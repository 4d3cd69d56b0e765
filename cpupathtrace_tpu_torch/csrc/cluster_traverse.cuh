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
// the tiers; the lanes of a warp enter different clusters at different
// turns. Neither bytes nor operations bound it: the 200k dragon's 4,128
// records are 29.6 MB, which fits the 50 MB L2, and a bounce does a few
// hundred flops per record row tested. What limits it is how many row and
// box loads each SM keeps in flight, and how many lanes of a warp test
// together. Run as nested loops (hypers, superclusters, cluster boxes,
// rows), a warp's lanes left the loops at different iterations and did not
// meet again before the walk ended: K1's binned form and K2 read about one
// lane of 32 a filled-row step (PERF.md §6). Stepped each lane alone (one
// flat loop, one test a turn), the box tests, which every lane takes in the
// same order, ran fuller, but a visited record's rows stayed serial: the
// visiting lane tested its rec_rows rows one ring step each, with few other
// lanes in a row step beside it (0.086 of 32 lanes at a row step at 7.2M
// triangles in 128-row records), and those row steps were most of the walk.
//
// What the design does about it: it is not the TPU's bitmask-and-DMA scan,
// whose vector-to-scalar steps were the TPU's cost. The walk is a state
// machine (`Walk`) that does one test a step, a hyper, supercluster or
// cluster box or a record row, in the order of the nested loops over hypers,
// superclusters and clusters in ascending index order, pruning each box
// against its own running nearest t (any-hit: its t_lim, stopping at the
// first occluder), so it tests only records its own ray enters. In K1's
// binned form and K2 (cluster_nearest, cluster_anyhit) each lane steps its
// own walk through the boxes, and the warp tests a visited record's rows
// together (`walk_together`): a lane whose cluster box passes posts the
// cluster and waits; at the first post (the lanes meet at a vote after each
// box step) the warp serves the posted clusters, each once for all the lanes
// that posted it, rank j of the warp's lanes testing rows j, j + 32, ... in
// ceil(rec_rows / 32) rounds (4 at 128 rows), each round reduced across the
// warp. Lanes whose walk has ended test rows for the others. K1's binned
// form tests its shadow walks' rows each lane alone, and K2's record form
// all its rows (BinnedGeo's kTogether: with more rounds they spilled at 96
// registers). K4 steps the walk on its refilling warps, each lane its own
// rows (`Walk::step`).
// Stepping the whole walk converged (the lanes that reach a query together
// take one test each a turn and meet again at a vote) was slower in every
// cell of an earlier sweep of experiments/walk_stepping.py (PERF.md §6).
// Hyper and supercluster boxes are staged in shared memory by the launching
// kernel (broadcast reads) when they fit. Cluster boxes and record rows
// reach the test through a row source (`Rows`), the ring `Ring<D, T>` of
// every walking kernel (K1's binned form and K2 at WalkRing's D and T, K4
// at its own): a per-thread ring of D slots of 80 bytes in dynamic shared
// memory, filled by 16-byte `cp.async` through L1, one commit group per
// slot. Before the thread tests
// element k of a stream (the rows of a cluster, the 32 boxes of a descended
// page, or its share of a served record's rows) it issues element k + D - 1
// and waits for element k, so D - 1 rows or boxes are in flight while one is
// tested (a warp's 32 x (D - 2) while it serves a record: the last slot then
// holds the lane's parked walk, whose ray and bound the other lanes read,
// so that no lane holds its walk in registers while the warp serves). The slots are
// interleaved by thread ([slot][16-byte piece][thread]), so a warp's 16-byte
// reads do not conflict, and the test reads its operands from shared
// memory: no register array holds a row.
// The sorted driver reorders rays between bounces so neighbouring threads
// take similar paths, so lanes often post the same cluster; K1's binned form
// does not (it traces whole paths in one launch), nor does K4 (it takes its
// caller's order).
//
// Copies left in flight (the ring's hazard): a stream that runs to its end
// has waited for every element it issued (only empty groups stay pending).
// The early ways out wait for their copies with cp.async.wait_all
// (`Ring::drain`) before a slot is rewritten or read again: an any-hit walk
// that stops at an occluder; a box that passes, whose cluster's rows reuse
// the slots of the page's boxes in flight (the page's stream then restarts
// after that box); a served record, whose rows reuse every lane's slots
// (each lane drains before the serve and after it, and restarts its page's
// stream); and so a query, and the next query of the thread, always begin
// with no copy in flight.
//
// Semantics kept: a record row wins only by improving strictly on the
// running t, so among equal t the lowest cluster and then the lowest row
// wins, as the plain version's first strict minimum; min/max propagate NaN
// (jmin/jmax), so a NaN slab entry enters nothing. A served record keeps it:
// each round takes the least (t, row) below the ray's bound, and the ray
// takes it only where it improves strictly; any-hit takes the round's lowest
// occluding row and counts the filled rows up to it.
//
// Counters (debug_visits): a counter policy (Visits) counts, per ray, the
// superclusters descended and the records visited, against the running
// bound the walk prunes with, and the walk's work: its slab tests below the
// root gate and the filled record rows it tests; NoVisits builds the plain
// instances. These are per-thread counts; the TPU's were per block (a block
// descended when any of its lanes needed it), so the two are not comparable.
// WarpVisits (K1's and K2's counting instances) also counts the warp's
// steps: once per slab test that the warp executes, by the lowest active
// lane (each turn of the stepped walk that runs slab tests counts once for
// the lanes that run it together); once per test of filled rows (K4: each
// turn that runs filled-row tests; a served record: each round for each
// lane it serves, by the lowest lane of the warp), so lane utilisation is
// work / (32 x steps); and once per record stream (a served record, or a
// record a lane streams for itself), so record visits over streams is the
// rays a stream serves. The walk names the cluster it
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

// The moment m = o x d of a ray, which the pair test reads beside o and d.
__device__ __forceinline__ void ray_moment(const Ray& r, float& mx, float& my, float& mz) {
  mx = r.oy * r.dz - r.oz * r.dy;
  my = r.oz * r.dx - r.ox * r.dz;
  mz = r.ox * r.dy - r.oy * r.dx;
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
// slot 0, piece j of slot s at base[(s * kRingPieces + j) * T]. A stream
// runs through the first S slots (S = D, or D - 1 while the warp serves a
// record: the last slot then holds the lane's walk, park()), element e in
// slot e mod S, so the ring keeps nothing of a stream: the caller names
// its source, the element it reads and the stream's length. Every stream
// begins with no copy in flight (see the header): begin copies its elements
// `first` .. `first` + S - 2; before element k is tested, at(k) copies
// element k + S - 1 into the slot element k - 1 held. Element e of a stream lies
// `stride` floats after element e - 1: a row or a box apart, or, for a
// lane's share of a served record, as many rows apart as the warp has
// lanes.
template <int D, int T>
struct Ring {
  static constexpr int kDepth = D;
  float4* base;

  // Copies element e of the stream at `src` into its slot (nothing at or
  // past the stream's `count`) and commits it as one group.
  template <int P, int S>
  __device__ __forceinline__ void copy(const float* src, int e, int count, int stride) {
    if (e < count) {
      float4* dst = base + (e % S) * kRingPieces * T;
      const float* from = src + static_cast<size_t>(e) * stride;
#pragma unroll
      for (int j = 0; j < P; ++j) cp_async16(dst + j * T, from + 4 * j);
    }
    cp_async_commit();
  }

  template <int P, int S = D>
  __device__ __forceinline__ void begin(const float* src, int count, int first,
                                        int stride = kElementStride<P>) {
#pragma unroll
    for (int j = 0; j < S - 1; ++j) copy<P, S>(src, first + j, count, stride);
  }

  // Element k (the streams are read in order): copy element k + S - 1,
  // then wait for element k's group.
  template <int P, int S = D>
  __device__ __forceinline__ SlotView<T> at(const float* src, int k, int count,
                                            int stride = kElementStride<P>) {
    copy<P, S>(src, k + S - 1, count, stride);
    cp_async_wait<S - 1>();
    return SlotView<T>{base + (k % S) * kRingPieces * T};
  }

  __device__ __forceinline__ void drain() { cp_async_wait_all(); }

  // A walk, parked in the lane's last slot while the warp serves: its ray
  // and bound, winning row, phase and position (plain shared-memory stores
  // and loads: the warp synchronises between a lane's store and another
  // lane's load).
  __device__ __forceinline__ float4* parking() const { return base + (D - 1) * kRingPieces * T; }
  template <class W>
  __device__ __forceinline__ void park(const W& w) {
    parking()[0] = make_float4(w.r.ox, w.r.oy, w.r.oz, w.bound);
    parking()[T] = make_float4(w.r.dx, w.r.dy, w.r.dz, __int_as_float(w.win));
    parking()[2 * T] = make_float4(__int_as_float(w.phase), __int_as_float(w.h),
                                   __int_as_float(w.s), __int_as_float(w.g));
  }
  template <class W>
  __device__ __forceinline__ void unpark(W& w) const {
    const float4 o = parking()[0], d = parking()[T], at = parking()[2 * T];
    w.r = Ray{o.x, o.y, o.z, d.x, d.y, d.z};
    w.bound = o.w;
    w.win = __float_as_int(d.w);
    w.phase = __float_as_int(at.x);
    w.h = __float_as_int(at.y);
    w.s = __float_as_int(at.z);
    w.g = __float_as_int(at.w);
  }
  // A served lane's new bound and winning row.
  __device__ __forceinline__ void repark(float bound, int win) {
    reinterpret_cast<float*>(parking())[3] = bound;
    reinterpret_cast<float*>(parking() + T)[3] = __int_as_float(win);
  }
  // The ray and bound that the thread `offset` lanes away parked.
  __device__ __forceinline__ Ray parked_ray(int offset, float& bound) const {
    const float4 o = parking()[offset], d = parking()[offset + T];
    bound = o.w;
    return Ray{o.x, o.y, o.z, d.x, d.y, d.z};
  }
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
// (BinnedGeo::nearest), one per ray-bounce. A served record's round counts
// its filled rows (up to the occluder) for the lane it tests them for
// (round(mask, filled, mine)); stream(mask) marks one record stream.
// NoVisits compiles to nothing.
struct NoVisits {
  __device__ __forceinline__ void query() {}
  __device__ __forceinline__ void slab() {}
  __device__ __forceinline__ void descend() {}
  __device__ __forceinline__ void record(int) {}
  __device__ __forceinline__ void row(float) {}
  __device__ __forceinline__ void round(unsigned, unsigned, bool) {}
  __device__ __forceinline__ void stream(unsigned) {}
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
  __device__ __forceinline__ void round(unsigned, unsigned filled, bool mine) {
    if (mine) rows += __popc(filled);
  }
  __device__ __forceinline__ void stream(unsigned) {}
};

// Visits and the warp's steps: a step is one execution of a slab test, or
// of a test of filled rows, by the lanes that run it together; the lowest
// of them counts it. A served record's round is one row step for each lane
// it serves, counted by the lowest lane of the warp's mask, and the record
// one stream (as is a record a lane visits and streams for itself). Summed
// over a warp's lanes, slab_steps <= slabs <= 32 x slab_steps, the same for
// rows, and streams <= record visits <= 32 x streams. The steps depend on
// how the card schedules lanes, so they are not among the columns the twins
// reproduce.
struct WarpVisits : Visits {
  int slab_steps = 0;
  int row_steps = 0;
  int streams = 0;
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
  __device__ __forceinline__ void round(unsigned mask, unsigned filled, bool mine) {
    Visits::round(mask, filled, mine);
    if (filled && lowest(mask)) ++row_steps;
  }
  __device__ __forceinline__ void stream(unsigned mask) {
    if (lowest(mask)) ++streams;
  }
};

// The walk's phase: the loop of the nested walk (hypers, superclusters,
// the 32 cluster boxes of a descended page, a visited cluster's record
// rows) whose test comes next, or kWalkDone. Under walk_together, kWalkRow
// is a posted walk: its cluster's box passed and it waits for the warp to
// serve the cluster's rows.
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
// step() is row() in a visited cluster, else box<false>(); walk_together
// steps box<true>(), which posts a visited cluster in place of streaming
// its rows, and serves the rows itself.
// Results: nearest, the running t in `bound`, the winning row `win` (c x
// rec_rows + row, -1 for none) and, from step(), its prim column `prim`
// (-1 for none); any-hit, `win` the occluding row (occluded: win >= 0).
// The compiler keeps only what a caller reads: K4 the prim in a register,
// as its walk did before the move, cluster_nearest the row, whose pair
// test it runs again for the winner's (sd, su, sv), normals and material.
template <bool kAnyHit>
struct Walk {
  Ray r;
  InvDir v;
  float mx, my, mz;
  float bound;
  int phase, h, s, g, k;
  int win;
  float prim;

  __device__ __forceinline__ bool done() const { return phase == kWalkDone; }
  __device__ __forceinline__ bool posted() const { return phase == kWalkRow; }
  __device__ __forceinline__ int cluster() const { return s * kGroup + g; }

  // The slab tests' inverse direction, from r: at the start, and again after
  // the warp serves (walk_together), so that it is not held while it serves.
  __device__ __forceinline__ void invert() {
    v = InvDir{inv_dir(r.dx), inv_dir(r.dy), inv_dir(r.dz)};
  }

  __device__ __forceinline__ void start(const ClusterTables& T, const Ray& ray, float b) {
    r = ray;
    invert();
    ray_moment(r, mx, my, mz);
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
      row(T, rows, count);
      return;
    }
    box<false>(T, rows, count);
  }

  // One record row of the visited cluster, from the lane's own stream.
  template <class Rows, class Count>
  __device__ __forceinline__ void row(const ClusterTables& T, Rows& rows, Count& count) {
    const auto q = rows.template at<kRowPieces>(
        T.rec + static_cast<size_t>(cluster()) * T.rec_rows * kKrnCols, k, T.rec_rows);
    count.row(q[kRecPrim]);
    float qd, qu, qv, qt;
    if (pair_quantities_rt(q, r, mx, my, mz, T.cull, qd, qu, qv, qt)) {
      if constexpr (kAnyHit) {
        // Division-free: t < t_lim <=> st < t_lim * sd. The rows after
        // the occluder may be in flight: drain.
        if (qt < bound * qd) {
          rows.drain();
          win = cluster() * T.rec_rows + k;
          phase = kWalkDone;
          return;
        }
      } else {
        const float tv = qt / qd;
        if (tv < bound) {
          bound = tv;
          win = cluster() * T.rec_rows + k;
          prim = q[kRecPrim];
        }
      }
    }
    if (++k == T.rec_rows) {
      // The page's box stream restarts after the visited box.
      phase = kWalkBox;
      ++g;
      rows.template begin<kBoxPieces>(page(T), kGroup, g);
    }
  }

  // One hyper, supercluster or cluster box, after stepping past the loops
  // the last test ended. A cluster box that passes: kPost false begins the
  // cluster's rows in the lane's ring; kPost true posts the cluster
  // (phase kWalkRow) with the page's boxes still in flight, for
  // walk_together, which drains them before it serves.
  template <bool kPost, class Rows, class Count>
  __device__ __forceinline__ void box(const ClusterTables& T, Rows& rows, Count& count) {
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
      const auto bx = rows.template at<kBoxPieces>(page(T), g, kGroup);
#pragma unroll
      for (int j = 0; j < kBndCols; ++j) b[j] = bx[j];
    } else {
      const float* bx = phase == kWalkHyper ? T.hyp + h * kBndCols : T.sup + s * kBndCols;
#pragma unroll
      for (int j = 0; j < kBndCols; ++j) b[j] = bx[j];
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
      count.record(cluster());
      if constexpr (kPost) {
        phase = kWalkRow;
      } else {
        // The lane streams the record for itself. The visit's rows reuse
        // the slots of the boxes in flight: wait for them first.
        count.stream(1u << (threadIdx.x & 31));
        rows.drain();
        phase = kWalkRow;
        k = 0;
        rows.template begin<kRowPieces>(T.rec + static_cast<size_t>(cluster()) * T.rec_rows *
                                        kKrnCols, T.rec_rows, 0);
      }
    } else {
      ++g;
    }
  }
};

// When the warp serves posted clusters (walk_together): 0, once no lane of
// the warp's mask can take another box step (each has posted or ended);
// n > 0, also as soon as n lanes wait, the lanes meeting at a vote after
// each box step. Chosen by the sweep of experiments/walk_stepping.py
// (PERF.md §6): 1, at the first post, ran fastest in K2 on the 7.2M and
// 200k frames and on cornell-demo's.
constexpr int kServeWaiting = 1;

// Serves cluster `c` for the lanes `peers` of `mask` that posted it: the
// record's rows are streamed once, rank j of the mask's n lanes taking rows
// j, j + n, ... through its own ring slots but the last, in ceil(rec_rows /
// n) rounds; each round every lane tests its row against each peer's ray (o,
// d and the running bound from the peer's parked walk, m = o x d recomputed
// as Walk::start computes it). Nearest: the least (t, row) below the peer's
// bound (__reduce_min_sync over t's bits, t >= 0 or -0, then the lowest
// lane holding it), parked as the peer's bound and winning row; it
// improves strictly, and among equal t the lowest row wins, as the lane's
// own strict-improvement scan; NaN enters nothing. The winner's `prim` is
// not kept (cluster_nearest reads the winning row). Any-hit: the lowest
// occluding row of the round ends the peer's walk, and the peer counts the
// filled rows up to it, and parks the row; no round runs once every peer
// has ended. Every lane of `mask` calls it together; the lanes' rings have
// no copy in flight, and have none after it; each has parked its walk.
template <bool kAnyHit, class Rows, class Count>
__device__ __forceinline__ void serve_cluster(const ClusterTables& T, Rows& rows, Count& count,
                                              unsigned mask, int c, unsigned peers) {
  const int lane = threadIdx.x & 31;
  const int rank = __popc(mask & ((1u << lane) - 1u));
  const int n_lanes = __popc(mask);
  const int mine = rank < T.rec_rows ? (T.rec_rows - rank + n_lanes - 1) / n_lanes : 0;
  const int first_row = c * T.rec_rows;
  constexpr int S = Rows::kDepth - 1;  // the last slot holds the lane's walk
  const float* src = T.rec + (static_cast<size_t>(first_row) + rank) * kKrnCols;
  rows.template begin<kRowPieces, S>(src, mine, 0, n_lanes * kKrnCols);
  count.stream(mask);
  unsigned open = peers;
  for (int k = 0; k * n_lanes < T.rec_rows && open; ++k) {
    const auto q = rows.template at<kRowPieces, S>(src, k, mine, n_lanes * kKrnCols);
    const bool has = k < mine;
    const float qp = has ? q[kRecPrim] : -1.0f;
    const unsigned filled = __ballot_sync(mask, qp >= 0.0f);
    for (unsigned left = open; left; left &= left - 1) {
      const int p = __ffs(left) - 1;
      float pb, pmx, pmy, pmz, qd, qu, qv, qt;
      const Ray pr = rows.parked_ray(p - lane, pb);
      ray_moment(pr, pmx, pmy, pmz);
      const bool ok = has && pair_quantities_rt(q, pr, pmx, pmy, pmz, T.cull, qd, qu, qv, qt);
      if constexpr (kAnyHit) {
        // Division-free, as Walk::row: t < t_lim <=> st < t_lim * sd.
        const unsigned hit = __ballot_sync(mask, ok && qt < pb * qd);
        const unsigned first = hit & (0u - hit);
        count.round(mask, hit ? filled & (first * 2u - 1u) : filled, lane == p);
        if (hit) {
          open &= ~(1u << p);
          if (lane == p) rows.repark(pb, first_row + k * n_lanes + __popc(mask & (first - 1u)));
        }
      } else {
        const float tv = qt / qd;
        const unsigned key = ok && tv < pb ? __float_as_uint(tv) & 0x7fffffffu : 0xffffffffu;
        const unsigned least = __reduce_min_sync(mask, key);
        count.round(mask, filled, lane == p);
        if (least != 0xffffffffu) {
          const int src = __ffs(__ballot_sync(mask, key == least)) - 1;
          const float bt = __shfl_sync(mask, tv, src);
          const int row = first_row + k * n_lanes + __popc(mask & ((1u << src) - 1u));
          if (lane == p) rows.repark(bt, row);
          __syncwarp(mask);  // the next rounds read the peer's new bound
        }
      }
    }
  }
  rows.drain();
}

// The walks of the lanes that reach a query together (`mask`, taken at
// entry), each lane's through its own boxes, with the rows of the records
// they visit tested by the warp (see the header): each lane steps box<true>
// until it posts a cluster or its walk ends; then, while some lane has
// posted, the warp serves the posted clusters, the lowest posting lane's
// first, its peers found by __match_any_sync on the cluster index, and the
// served lanes (and any lane stopped in a page) restart their page's box
// stream. A lane whose walk has ended stays until every walk of the mask
// has ended, testing rows for the others. Each walk takes the same tests
// in the same order, with the same results, as Walk::step to its end.
template <bool kAnyHit, class Rows, class Count>
__device__ __forceinline__ void walk_together(Walk<kAnyHit>& w, const ClusterTables& T,
                                              Rows& rows, Count& count) {
  const unsigned mask = __activemask();
  for (;;) {
    if constexpr (kServeWaiting == 0) {
      while (!w.done() && !w.posted()) w.template box<true>(T, rows, count);
    } else {
      for (;;) {
        if (!w.done() && !w.posted()) w.template box<true>(T, rows, count);
        if (__popc(__ballot_sync(mask, w.posted())) >= kServeWaiting ||
            !__any_sync(mask, !w.done() && !w.posted()))
          break;
      }
    }
    unsigned waiting = __ballot_sync(mask, w.posted());
    if (!waiting) return;
    rows.drain();
    // The lanes' walks wait in their rings' last slots while the warp
    // serves, so that no lane holds one (or its ray's inverse) in registers
    // then.
    const int posted = w.posted() ? w.cluster() : -1;
    rows.park(w);
    __syncwarp(mask);
    const unsigned same = __match_any_sync(mask, posted);
    do {
      const int lead = __ffs(waiting) - 1;
      const unsigned peers = __shfl_sync(mask, same, lead);
      serve_cluster<kAnyHit>(T, rows, count, mask, __shfl_sync(mask, posted, lead), peers);
      waiting &= ~peers;
    } while (waiting);
    rows.unpark(w);
    __syncwarp(mask);
    if (w.posted()) {
      // Served: an occluding row ends an any-hit walk; else the page's box
      // stream restarts after the cluster's box.
      if (kAnyHit && w.win >= 0) {
        w.phase = kWalkDone;
      } else {
        w.phase = kWalkBox;
        ++w.g;
      }
    }
    w.invert();
    if (w.phase == kWalkBox) rows.template begin<kBoxPieces>(w.page(T), kGroup, w.g);
  }
}

// Nearest hit over the cluster set, improving strictly on h (traverse_clusters).
// kNormal: also resolve the winner's shading normal and material, from its
// (sd, su, sv): the winning row's pair test run again on the same operands,
// so the same bits as when it won. kTogether: the warp tests a visited
// record's rows (walk_together); else each lane its own.
template <bool kNormal, bool kTogether, class Count, class Rows>
__device__ __forceinline__ void cluster_nearest(const ClusterTables& T, const Ray& r, Hit& h,
                                                Count& count, Rows& rows) {
  Walk<false> w;
  w.start(T, r, h.t);
  if constexpr (kTogether)
    walk_together(w, T, rows, count);
  else
    while (!w.done()) w.step(T, rows, count);
  if (w.win < 0) return;
  const float* best = T.rec + static_cast<size_t>(w.win) * kKrnCols;
  h.t = w.bound;
  h.prim = static_cast<int>(__ldg(best + kRecPrim));
  if (kNormal) {
    float mx, my, mz, sd, su, sv, st;
    ray_moment(r, mx, my, mz);
    pair_quantities_rt(best, r, mx, my, mz, T.cull, sd, su, sv, st);
    const float sdw = jmax(sd, 1e-30f);
    const float uw = su / sdw;
    const float vw = sv / sdw;
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
// t_lim <= 0 queries nothing (the root gate). kTogether: the warp tests a
// visited record's rows (walk_together); else each lane its own.
template <bool kTogether, class Count, class Rows>
__device__ __forceinline__ bool cluster_anyhit(const ClusterTables& T, const Ray& r, float t_lim,
                                               Count& count, Rows& rows) {
  Walk<true> w;
  w.start(T, r, t_lim);
  if constexpr (kTogether)
    walk_together(w, T, rows, count);
  else
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

// The floats stage_tiers stages of `T` within `budget_floats`: every hyper
// and supercluster box, or 0 (the launches of K1, K2 and K4 size with it).
__host__ __device__ inline int staged_tier_floats(const ClusterTables& T, int budget_floats) {
  const int n = T.n_pages * (kBndCols + kGroup2 * kBndCols);
  return n <= budget_floats ? n : 0;
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
