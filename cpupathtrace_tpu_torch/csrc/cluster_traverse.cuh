// K3: the tiered cluster traversal as device functions, one ray per thread.
//
// Replaces: cpupathtrace_tpu/accel/kernel_traverse.py `traverse_clusters`
//   (:1041), `traverse_clusters_anyhit` (:1106) and `_scan_pipelined`
//   (:750), with `pair_slab_entries` (:337) and `_root_gate` (:372). The
//   bounce kernel K2 (bounce.cu) and K1's binned form (megakernel.cu)
//   inline them through binned_geo.cuh; K4 (cluster_query.cu) launches them
//   alone. Plain version: traverse_clusters[_anyhit] in
//   cpupathtrace_tpu_torch/accel/kernel_traverse.py.
//
// Tables (the port's compact layout, kernel_traverse.py):
//   records  [n_rec, rec_rows, 32] f32: pair-record rows, columns 0-27 used
//   clb      [S, 32, 8]   cluster bounds, one page per supercluster
//   sup      [Hp, 16, 8]  supercluster bounds, one page per hyper
//   hyp      [>= Hp, 8]   hyper bounds;  root [8] their union
//   bounds rows: lo3 hi3 valid pad.
//
// What bounds it on this card: the latency of dependent loads and the
// divergence of per-thread descents. Each thread walks its own path through
// the tiers; the lanes of a warp enter different clusters, so a warp pays for
// the union of its lanes' record tests. Neither bytes nor operations bound
// it: the 200k dragon's 4,128 records are 29.6 MB, which fits the 50 MB L2,
// and a bounce does a few hundred flops per record row tested. What limits
// it is how many row and box loads each SM keeps in flight, and how many
// lanes of a warp test together. Run as nested loops (hypers, superclusters,
// cluster boxes, rows), a warp's lanes left the loops at different
// iterations and did not meet again before the walk ended: K1's binned form
// and K2 read about one lane of 32 a filled-row step (PERF.md §6).
//
// What the design does about it: it is not the TPU's bitmask-and-DMA scan,
// whose vector-to-scalar steps were the TPU's cost. The walk is a state
// machine (`Walk`) that does one test a step, a hyper, supercluster or
// cluster box or a record row, in the order of the nested loops over hypers,
// superclusters and clusters in ascending index order, pruning each box
// against its own running nearest t (any-hit: its t_lim, stopping at the
// first occluder), so it tests only records its own ray enters. In K1's
// binned form and K2 each lane steps its own walk (cluster_nearest,
// cluster_anyhit): one flat loop with one test a turn, in which the card
// runs together the lanes that are in the same kind of test, whichever
// loop of the nested walk each is in; K4 steps it on its refilling warps.
// Stepping it converged (the lanes that reach a query together take one
// test each a turn and meet again at a vote) was slower in every cell of
// experiments/walk_stepping.py (PERF.md §6). Hyper and supercluster boxes
// are staged in shared memory by the launching kernel (broadcast reads)
// when they fit. Cluster boxes and record rows reach the test through a
// row source (`Rows`), the ring `Ring<D, T>` of every walking kernel (K1's
// binned form and K2 at WalkRing's D and T, K4 at its own): a per-thread
// ring of D slots of 80 bytes in dynamic shared memory, filled by 16-byte
// `cp.async` through L1, one commit group per slot. Before the thread tests
// element k of a stream (the rows of a cluster, or the 32 boxes of a
// descended page) it issues element k + D - 1 and waits for element k, so
// D - 1 rows or boxes are in flight while one is tested. The slots are
// interleaved by thread ([slot][16-byte piece][thread]), so a warp's 16-byte
// reads do not conflict, and the test reads its operands from shared
// memory: no register array holds a row.
// The sorted driver reorders rays between bounces so neighbouring threads
// take similar paths; K1's binned form does not (it traces whole paths in
// one launch), nor does K4 (it takes its caller's order).
//
// Copies left in flight (the ring's hazard): a stream that runs to its end
// has waited for every element it issued (only empty groups stay pending).
// The three early ways out wait for their copies with cp.async.wait_all
// (`Ring::drain`) before a slot is rewritten or read again: an any-hit walk
// that stops at an occluder; a box that passes, whose cluster's rows reuse
// the slots of the page's boxes in flight (the page's stream then restarts
// after that box); and so a query, and the next query of the thread, always
// begin with no copy in flight.
//
// Semantics kept: a record row wins only by improving strictly on the
// running t, so among equal t the lowest cluster and then the lowest row
// wins, as the plain version's first strict minimum; min/max propagate NaN
// (jmin/jmax), so a NaN slab entry enters nothing.
//
// Counters (debug_visits): a counter policy (Visits) counts, per ray, the
// superclusters descended and the records visited, against the running
// bound the walk prunes with, and the walk's work: its slab tests below the
// root gate and the filled record rows it tests; NoVisits builds the plain
// instances. These are per-thread counts; the TPU's were per block (a block
// descended when any of its lanes needed it), so the two are not comparable.
// WarpVisits (K1's and K2's counting instances) also counts the warp's
// steps: once per slab test and once per test of filled rows that the warp
// executes, by the lowest active lane (each turn of the stepped walk that
// runs slab tests, and each that runs filled-row tests, counts once for
// the lanes that run it together), so lane utilisation is work / (32 x
// steps). The walk names the cluster it
// visits (record(c)), for a policy that reads which clusters a warp's lanes
// test together (K4's).
#pragma once

#include <float.h>

#include "bulk_copy.cuh"
#include "dense_intersect.cuh"

namespace ptx {

constexpr int kGroup = 32;   // clusters per supercluster page
constexpr int kGroup2 = 16;  // superclusters per hyper page
constexpr int kBndCols = 8;  // lo3 hi3 valid pad
constexpr int kKrnCols = 32; // record row stride (28 used)

struct ClusterTables {
  const float* rec;  // [n_rec, rec_rows, kKrnCols], global
  int n_rec;
  int rec_rows;
  const float* clb;  // [n_rec / kGroup, kGroup, kBndCols], global
  const float* sup;  // [n_pages, kGroup2, kBndCols], shared or global
  int n_pages;
  const float* hyp;  // [>= n_pages, kBndCols], shared or global
  const float* root; // [kBndCols]
  int cull;          // cull class of the records: -1 per row, 0 none, 1 all
};

struct InvDir {
  float ix, iy, iz;
};

// Slab-test inverse: zero components use FLT_MAX (kernel_traverse.py:_inv_dir).
__device__ __forceinline__ float inv_dir(float d) { return fabsf(d) > 0.0f ? 1.0f / d : FLT_MAX; }

// Clamped slab entry of a ray into a bounds row `b` (a pointer or a row
// view: b[i] its i-th column); +inf on a miss or an invalid box
// (pair_slab_entries).
template <class B>
__device__ __forceinline__ float slab_entry(const B& b, const Ray& r, const InvDir& v) {
  const float t1x = (b[0] - r.ox) * v.ix, t2x = (b[3] - r.ox) * v.ix;
  const float t1y = (b[1] - r.oy) * v.iy, t2y = (b[4] - r.oy) * v.iy;
  const float t1z = (b[2] - r.oz) * v.iz, t2z = (b[5] - r.oz) * v.iz;
  const float tmin = jmax(jmax(jmin(t1x, t2x), jmin(t1y, t2y)), jmin(t1z, t2z));
  const float tmax = jmin(jmin(jmax(t1x, t2x), jmax(t1y, t2y)), jmax(t1z, t2z));
  const bool miss = b[6] < 0.5f || tmax < 0.0f || tmin > tmax;
  return miss ? INFINITY : jmax(tmin, 0.0f);
}

// The pair test of one record row with the cull class chosen at run time
// (one warp-uniform branch; the record's class is one per scene).
template <class C>
__device__ __forceinline__ bool pair_quantities_rt(const C& c, const Ray& r, float mx, float my,
                                                   float mz, int cull, float& sd, float& su,
                                                   float& sv, float& st) {
  if (cull == 0) return pair_quantities<0>(c, r, mx, my, mz, sd, su, sv, st);
  if (cull == 1) return pair_quantities<1>(c, r, mx, my, mz, sd, su, sv, st);
  return pair_quantities<-1>(c, r, mx, my, mz, sd, su, sv, st);
}

// A stream's element: P 16-byte pieces (rows kRowPieces, the 17 columns
// the test reads; boxes 2), at a stride of the row or box. Rows and boxes
// are 16-byte aligned in the tables.
constexpr int kBoxPieces = 2;

template <int P>
constexpr int kElementStride = P == kRowPieces ? kKrnCols : kBndCols;

// Pieces per ring slot (one record row) and its bytes
// (accel/kernel_traverse.py RING_SLOT_BYTES).
constexpr int kRingPieces = kRowPieces;
constexpr int kRingSlotBytes = kRingPieces * 16;

// One slot of a thread's ring in a block of T threads: piece j at p[j * T].
template <int T>
struct SlotView {
  const float4* p;
  __device__ __forceinline__ float operator[](int i) const {
    const float4 v = p[(i >> 2) * T];
    const int c = i & 3;
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
};

// The row source of the walk: a ring of D slots in shared
// memory for each of a block's T threads, `base` this thread's piece 0 of
// slot 0, piece j of slot s at base[(s * kRingPieces + j) * T]. Every
// stream begins with no copy in flight (see the header): begin copies its
// elements `first` .. `first` + D - 2 into slots 0 .. D - 2; the element
// tested next is in slot `tail`, and the slot before it (mod D) takes the
// element D - 1 ahead.
template <int D, int T>
struct Ring {
  float4* base;
  const float* src = nullptr;
  int n = 0;
  int next = 0;  // next element to copy
  int tail = 0;  // slot of the next element to test

  // Copies element `next` into `slot` (nothing past the stream's end) and
  // commits it as one group.
  template <int P>
  __device__ __forceinline__ void copy(int slot) {
    if (next < n) {
      float4* dst = base + slot * kRingPieces * T;
      const float* from = src + static_cast<size_t>(next) * kElementStride<P>;
#pragma unroll
      for (int j = 0; j < P; ++j) cp_async16(dst + j * T, from + 4 * j);
    }
    cp_async_commit();
    ++next;
  }

  template <int P>
  __device__ __forceinline__ void begin(const float* s, int count, int first) {
    src = s;
    n = count;
    next = first;
    tail = 0;
#pragma unroll
    for (int j = 0; j < D - 1; ++j) copy<P>(j);
  }

  // Element k (the streams are read in order): copy element k + D - 1 into
  // the slot element k - 1 held, then wait for element k's group.
  template <int P>
  __device__ __forceinline__ SlotView<T> at(int) {
    copy<P>(tail == 0 ? D - 1 : tail - 1);
    cp_async_wait<D - 1>();
    const SlotView<T> v{base + tail * kRingPieces * T};
    tail = tail + 1 == D ? 0 : tail + 1;
    return v;
  }

  __device__ __forceinline__ void drain() { cp_async_wait_all(); }
};

// The walk's ring: slots per thread and threads per block of K1's binned
// form and K2 (the wrappers read them through ptx_walk_layout,
// binned_geo.cuh), and the blocks each SM must hold (__launch_bounds__'s
// minimum, which caps the registers). Chosen by a sweep over D 2-4,
// 128 / 256 threads and 24 / 20 / no minimum of resident warps (PERF.md
// §6): at 20 warps (96 registers) K2's and K1's plain instances do not
// spill; capped to 24 warps (80 registers) they spill and ran slower.
constexpr int kRingDepth = 3;
constexpr int kWalkThreads = 128;
constexpr int kWalkMinBlocks = 640 / kWalkThreads;
using WalkRing = Ring<kRingDepth, kWalkThreads>;

// Traversal counter policies, per ray. The JAX package's debug_visits
// columns: a descend is a supercluster whose box the ray enters below its
// bound, so the thread reads its 32 cluster boxes; a record visit is one
// visit(cluster) call. The work the walk does beside them: slab tests below
// the root gate (hyper, supercluster and cluster boxes tested) and filled
// record rows tested (prim >= 0; padding rows are not work the query needs;
// any-hit stops at the occluding row); queries counts the nearest queries
// (BinnedGeo::nearest), one per ray-bounce. NoVisits compiles to nothing.
struct NoVisits {
  __device__ __forceinline__ void query() {}
  __device__ __forceinline__ void slab() {}
  __device__ __forceinline__ void descend() {}
  __device__ __forceinline__ void record(int) {}
  __device__ __forceinline__ void row(float) {}
};

struct Visits {
  int queries = 0;
  int slabs = 0;
  int descends = 0;
  int records = 0;
  int rows = 0;
  __device__ __forceinline__ void query() { ++queries; }
  __device__ __forceinline__ void slab() { ++slabs; }
  __device__ __forceinline__ void descend() { ++descends; }
  __device__ __forceinline__ void record(int) { ++records; }
  __device__ __forceinline__ void row(float prim) { rows += prim >= 0.0f ? 1 : 0; }
};

// Visits and the warp's steps: a step is one execution of a slab test, or
// of a test of filled rows, by the lanes that run it together; the lowest
// of them counts it. Summed over a warp's lanes, slab_steps <= slabs <= 32 x
// slab_steps, and the same for rows. The steps depend on how the card
// schedules lanes, so they are not among the columns the twins reproduce.
struct WarpVisits : Visits {
  int slab_steps = 0;
  int row_steps = 0;
  static __device__ __forceinline__ bool lowest(unsigned mask) {
    return static_cast<int>(threadIdx.x & 31) == __ffs(mask) - 1;
  }
  __device__ __forceinline__ void slab() {
    Visits::slab();
    if (lowest(__activemask())) ++slab_steps;
  }
  __device__ __forceinline__ void row(float prim) {
    Visits::row(prim);
    const unsigned filled = __ballot_sync(__activemask(), prim >= 0.0f);
    if (filled && lowest(filled)) ++row_steps;
  }
};

// The walk's phase: the loop of the nested walk (hypers, superclusters,
// the 32 cluster boxes of a descended page, a visited cluster's record
// rows) whose test comes next, or kWalkDone.
enum WalkPhase : int { kWalkHyper, kWalkSuper, kWalkBox, kWalkRow, kWalkDone };

// The walk of one ray as a state machine, one test a step: start(ray,
// bound) applies the root gate; each step() runs one test, a record row or
// a hyper, supercluster or cluster box, after stepping past the loops the
// last test ended. The tests are those of the nested loops over hypers,
// superclusters and clusters in ascending index order, each box pruned
// against the running bound (nearest: the running t, from the initial
// bound; any-hit: t_lim, stopping at the first occluding row), in the same
// order and through the same ring streams; the cluster boxes of a
// descended page and the visited clusters' rows come from the row source
// `rows` (WalkRing in K1 and K2, QueryRing in K4), whose invariant (a
// stream begins with no copy in flight, see the header) the drains keep.
// Results: nearest, the running t in `bound`, the winning row `win` (c x
// rec_rows + row, -1 for none), its prim column `prim` (-1 for none) and
// its (sd, su, sv); any-hit, `win` the occluding row (occluded: win >= 0).
// The compiler keeps only what a caller reads: K4 the prim in a register,
// as its walk did before the move, cluster_nearest the row, whose normals
// and material it reads.
template <bool kAnyHit>
struct Walk {
  Ray r;
  InvDir v;
  float mx, my, mz;
  float bound;
  int phase, h, s, g, k;
  int win;
  float prim, sd, su, sv;

  __device__ __forceinline__ bool done() const { return phase == kWalkDone; }

  __device__ __forceinline__ void start(const ClusterTables& T, const Ray& ray, float b) {
    r = ray;
    v = InvDir{inv_dir(r.dx), inv_dir(r.dy), inv_dir(r.dz)};
    mx = r.oy * r.dz - r.oz * r.dy;
    my = r.oz * r.dx - r.ox * r.dz;
    mz = r.ox * r.dy - r.oy * r.dx;
    bound = b;
    win = -1;
    prim = -1.0f;
    h = 0;
    phase = slab_entry(T.root, r, v) < bound ? kWalkHyper : kWalkDone;
  }

  __device__ __forceinline__ const float* page(const ClusterTables& T) const {
    return T.clb + static_cast<size_t>(s) * kGroup * kBndCols;
  }

  template <class Rows, class Count>
  __device__ __forceinline__ void step(const ClusterTables& T, Rows& rows, Count& count) {
    if (phase == kWalkRow) {
      const auto q = rows.template at<kRowPieces>(k);
      count.row(q[kRecPrim]);
      float qd, qu, qv, qt;
      if (pair_quantities_rt(q, r, mx, my, mz, T.cull, qd, qu, qv, qt)) {
        if constexpr (kAnyHit) {
          // Division-free: t < t_lim <=> st < t_lim * sd. The rows after
          // the occluder may be in flight: drain.
          if (qt < bound * qd) {
            rows.drain();
            win = (s * kGroup + g) * T.rec_rows + k;
            phase = kWalkDone;
            return;
          }
        } else {
          const float tv = qt / qd;
          if (tv < bound) {
            bound = tv;
            win = (s * kGroup + g) * T.rec_rows + k;
            prim = q[kRecPrim];
            sd = qd;
            su = qu;
            sv = qv;
          }
        }
      }
      if (++k == T.rec_rows) {
        // The page's box stream restarts after the visited box.
        phase = kWalkBox;
        ++g;
        rows.template begin<kBoxPieces>(page(T), kGroup, g);
      }
      return;
    }
    if (phase == kWalkBox && g == kGroup) {
      phase = kWalkSuper;
      ++s;
    }
    if (phase == kWalkSuper && s == min(T.n_rec / kGroup, (h + 1) * kGroup2)) {
      phase = kWalkHyper;
      ++h;
    }
    if (phase == kWalkHyper && h == T.n_pages) {
      phase = kWalkDone;
      return;
    }
    float b[kBndCols];
    if (phase == kWalkBox) {
      const auto box = rows.template at<kBoxPieces>(g);
#pragma unroll
      for (int j = 0; j < kBndCols; ++j) b[j] = box[j];
    } else {
      const float* box = phase == kWalkHyper ? T.hyp + h * kBndCols : T.sup + s * kBndCols;
#pragma unroll
      for (int j = 0; j < kBndCols; ++j) b[j] = box[j];
    }
    count.slab();
    const bool enters = slab_entry(b, r, v) < bound;
    if (phase == kWalkHyper) {
      if (enters) {
        phase = kWalkSuper;
        s = h * kGroup2;
      } else {
        ++h;
      }
    } else if (phase == kWalkSuper) {
      if (enters) {
        count.descend();
        phase = kWalkBox;
        g = 0;
        rows.template begin<kBoxPieces>(page(T), kGroup, 0);
      } else {
        ++s;
      }
    } else if (enters) {
      // The visit's rows reuse the slots of the boxes in flight: wait for
      // them first.
      count.record(s * kGroup + g);
      rows.drain();
      phase = kWalkRow;
      k = 0;
      rows.template begin<kRowPieces>(
          T.rec + static_cast<size_t>(s * kGroup + g) * T.rec_rows * kKrnCols, T.rec_rows, 0);
    } else {
      ++g;
    }
  }
};

// Nearest hit over the cluster set, improving strictly on h (traverse_clusters).
// kNormal: also resolve the winner's shading normal and material. The lane
// steps its walk to its end in one flat loop; the card runs together the
// lanes of a warp that take the same branch of a step.
template <bool kNormal, class Count, class Rows>
__device__ __forceinline__ void cluster_nearest(const ClusterTables& T, const Ray& r, Hit& h,
                                                Count& count, Rows& rows) {
  Walk<false> w;
  w.start(T, r, h.t);
  while (!w.done()) w.step(T, rows, count);
  if (w.win < 0) return;
  const float* best = T.rec + static_cast<size_t>(w.win) * kKrnCols;
  h.t = w.bound;
  h.prim = static_cast<int>(__ldg(best + kRecPrim));
  if (kNormal) {
    const float sdw = jmax(w.sd, 1e-30f);
    const float uw = w.su / sdw;
    const float vw = w.sv / sdw;
    const float w0 = 1.0f - uw - vw;
    float n[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) n[j] = __ldg(best + kRecN0 + j);
    const float snx = w0 * n[0] + uw * n[3] + vw * n[6];
    const float sny = w0 * n[1] + uw * n[4] + vw * n[7];
    const float snz = w0 * n[2] + uw * n[5] + vw * n[8];
    const float inv = rsqrtf(snx * snx + sny * sny + snz * snz + 1e-30f);
    h.nx = snx * inv;
    h.ny = sny * inv;
    h.nz = snz * inv;
    h.mat = static_cast<int>(__ldg(best + kRecMat));
  }
}

// Any-hit below t_lim over the cluster set (traverse_clusters_anyhit).
// t_lim <= 0 queries nothing (the root gate).
template <class Count, class Rows>
__device__ __forceinline__ bool cluster_anyhit(const ClusterTables& T, const Ray& r, float t_lim,
                                               Count& count, Rows& rows) {
  Walk<true> w;
  w.start(T, r, t_lim);
  while (!w.done()) w.step(T, rows, count);
  return w.win >= 0;
}

// Rays per row of the counter output: a TPU ray block of 8 x 128 lanes.
constexpr int kVisitBlock = 1024;

// Adds a thread's count `v` to column `col` of ray i's row of `out`
// [n_rays / kVisitBlock, cols] int32.
__device__ __forceinline__ void add_visits(int* out, int cols, int64_t i, int col, int v) {
  if (v) atomicAdd(out + (i / kVisitBlock) * cols + col, v);
}

// Stage the hyper and supercluster boxes in shared memory when they fit
// `budget_floats`; otherwise the thread reads them from global memory.
// Returns the floats used. Every thread of the block must call it, followed
// by __syncthreads() before any traversal.
__device__ __forceinline__ int stage_tiers(ClusterTables& T, float* smem, int budget_floats) {
  const int n_hyp = T.n_pages * kBndCols;
  const int n_sup = T.n_pages * kGroup2 * kBndCols;
  if (n_hyp + n_sup > budget_floats) return 0;
  for (int i = threadIdx.x; i < n_hyp; i += blockDim.x) smem[i] = T.hyp[i];
  for (int i = threadIdx.x; i < n_sup; i += blockDim.x) smem[n_hyp + i] = T.sup[i];
  T.hyp = smem;
  T.sup = smem + n_hyp;
  return n_hyp + n_sup;
}

}  // namespace ptx
