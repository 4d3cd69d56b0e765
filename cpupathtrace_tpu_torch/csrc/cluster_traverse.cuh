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
// the union of its lanes' record tests, and each record row is 128 bytes of
// L2/HBM traffic (the 200k dragon's 4,128 records are 29.6 MB, which fits the
// 50 MB L2). A bounce does a few hundred flops per record row tested.
//
// What the design does about it: it is not the TPU's bitmask-and-DMA scan,
// whose vector-to-scalar steps were the TPU's cost. Each thread runs a plain
// nested loop over hypers, superclusters and clusters in ascending index
// order and prunes each box against its own running nearest t (any-hit: its
// t_lim, stopping at the first occluder), so it tests only records its own
// ray enters. Hyper and supercluster boxes are staged in shared memory by
// the launching kernel (broadcast reads); cluster boxes and records come
// from global memory through L1/L2, records as five float4 loads per row
// (the 17 columns the test reads). The sorted driver reorders rays between
// bounces so neighbouring threads take similar paths; K1's binned form does
// not (it traces whole paths in one launch).
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
#pragma once

#include <float.h>

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

// Clamped slab entry of a ray into a bounds row; +inf on a miss or an
// invalid box (pair_slab_entries).
__device__ __forceinline__ float slab_entry(const float* b, const Ray& r, const InvDir& v) {
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
__device__ __forceinline__ bool pair_quantities_rt(const float* c, const Ray& r, float mx, float my,
                                                   float mz, int cull, float& sd, float& su,
                                                   float& sv, float& st) {
  if (cull == 0) return pair_quantities<0>(c, r, mx, my, mz, sd, su, sv, st);
  if (cull == 1) return pair_quantities<1>(c, r, mx, my, mz, sd, su, sv, st);
  return pair_quantities<-1>(c, r, mx, my, mz, sd, su, sv, st);
}

// The 17 feature columns of a global record row, as five 16-byte loads.
__device__ __forceinline__ void load_row17(const float* row, float c[20]) {
  const float4* q = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float4 v = __ldg(q + j);
    c[4 * j] = v.x;
    c[4 * j + 1] = v.y;
    c[4 * j + 2] = v.z;
    c[4 * j + 3] = v.w;
  }
}

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
  __device__ __forceinline__ void record() {}
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
  __device__ __forceinline__ void record() { ++records; }
  __device__ __forceinline__ void row(float prim) { rows += prim >= 0.0f ? 1 : 0; }
};

// Walks the tiers in ascending index order and calls visit(record) for every
// cluster whose box the ray enters below bound(); visit returns true to stop.
template <class Bound, class Visit, class Count>
__device__ __forceinline__ void walk_clusters(const ClusterTables& T, const Ray& r,
                                              const InvDir& v, Bound bound, Visit visit,
                                              Count& count) {
  if (!(slab_entry(T.root, r, v) < bound())) return;
  const int n_sup = T.n_rec / kGroup;
  for (int h = 0; h < T.n_pages; ++h) {
    count.slab();
    if (!(slab_entry(T.hyp + h * kBndCols, r, v) < bound())) continue;
    const int s_end = min(n_sup, (h + 1) * kGroup2);
    for (int s = h * kGroup2; s < s_end; ++s) {
      count.slab();
      if (!(slab_entry(T.sup + s * kBndCols, r, v) < bound())) continue;
      count.descend();
      const float* page = T.clb + static_cast<size_t>(s) * kGroup * kBndCols;
      for (int g = 0; g < kGroup; ++g) {
        float b[8];
        const float4* q = reinterpret_cast<const float4*>(page + g * kBndCols);
        const float4 b0 = __ldg(q), b1 = __ldg(q + 1);
        b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
        b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
        count.slab();
        if (!(slab_entry(b, r, v) < bound())) continue;
        count.record();
        if (visit(s * kGroup + g)) return;
      }
    }
  }
}

// Nearest hit over the cluster set, improving strictly on h (traverse_clusters).
// kNormal: also resolve the winner's shading normal and material.
template <bool kNormal, class Count>
__device__ __forceinline__ void cluster_nearest(const ClusterTables& T, const Ray& r, Hit& h,
                                                Count& count) {
  const InvDir v{inv_dir(r.dx), inv_dir(r.dy), inv_dir(r.dz)};
  const float mx = r.oy * r.dz - r.oz * r.dy;
  const float my = r.oz * r.dx - r.ox * r.dz;
  const float mz = r.ox * r.dy - r.oy * r.dx;
  float bt = h.t, bsd = 0.0f, bsu = 0.0f, bsv = 0.0f;
  const float* best = nullptr;
  walk_clusters(T, r, v, [&] { return bt; }, [&](int c) {
    const float* row = T.rec + static_cast<size_t>(c) * T.rec_rows * kKrnCols;
    for (int k = 0; k < T.rec_rows; ++k, row += kKrnCols) {
      float q[20];
      load_row17(row, q);
      count.row(q[kRecPrim]);
      float sd, su, sv, st;
      if (pair_quantities_rt(q, r, mx, my, mz, T.cull, sd, su, sv, st)) {
        const float tv = st / sd;
        if (tv < bt) {
          bt = tv;
          best = row;
          bsd = sd;
          bsu = su;
          bsv = sv;
        }
      }
    }
    return false;
  }, count);
  if (best == nullptr) return;
  h.t = bt;
  h.prim = static_cast<int>(__ldg(best + kRecPrim));
  if (kNormal) {
    const float sdw = jmax(bsd, 1e-30f);
    const float uw = bsu / sdw;
    const float vw = bsv / sdw;
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

// Any-hit below t_lim over the cluster set (traverse_clusters_anyhit),
// division-free: t < t_lim <=> st < t_lim * sd. t_lim <= 0 queries nothing.
template <class Count>
__device__ __forceinline__ bool cluster_anyhit(const ClusterTables& T, const Ray& r, float t_lim,
                                               Count& count) {
  const InvDir v{inv_dir(r.dx), inv_dir(r.dy), inv_dir(r.dz)};
  const float mx = r.oy * r.dz - r.oz * r.dy;
  const float my = r.oz * r.dx - r.ox * r.dz;
  const float mz = r.ox * r.dy - r.oy * r.dx;
  bool occ = false;
  walk_clusters(T, r, v, [&] { return t_lim; }, [&](int c) {
    const float* row = T.rec + static_cast<size_t>(c) * T.rec_rows * kKrnCols;
    for (int k = 0; k < T.rec_rows; ++k, row += kKrnCols) {
      float q[20];
      load_row17(row, q);
      count.row(q[kRecPrim]);
      float sd, su, sv, st;
      if (pair_quantities_rt(q, r, mx, my, mz, T.cull, sd, su, sv, st) && st < t_lim * sd) {
        occ = true;
        return true;
      }
    }
    return false;
  }, count);
  return occ;
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
