// The geometry of a binned scene for the per-bounce body (bounce_body.cuh):
// spheres, then the big-partition pair record, then the cluster set through
// the traversal K3 (cluster_traverse.cuh), each improving strictly on the
// last; shadow rays likewise, stopping at the first occluder. Shared by the
// megakernel's binned form (K1, megakernel.cu) and the bounce kernel (K2,
// bounce.cu), so their nearest and occlusion logic cannot drift.
//
// Port of the binned branch of `body` in
// cpupathtrace_tpu/integrator/pallas_megakernel.py (:424-457, 502-571).
// Count: the traversal counter policy (NoVisits, or WarpVisits for
// debug_visits); `near` counts the nearest queries, `shadow` the shadow
// queries of one path; add_geo_visits writes them as the counters' row,
// add_warp_steps the warp steps. The cluster walks step the state machine
// `Walk`, each lane its own, and stream their boxes and rows through the
// thread's ring in shared memory (cluster_traverse.cuh).
// kAblate (the ablation instances, bounce_body.cuh): `walks` false skips
// both walks (PTX_SKIP_TRAVERSE); the nearest query still counts.
#pragma once

#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"

namespace ptx {

template <int BIG_CULL, class Count = NoVisits, bool kAblate = false>
struct BinnedGeo {
  const float* rec;
  int rec_rows;
  const float* sph;
  int n_sph;
  ClusterTables cl;
  float4* ring;  // this thread's ring of kRingDepth slots (ring_base)
  mutable Count near{};
  mutable Count shadow{};
  bool walks = true;  // read by the kAblate instances only

  __device__ __forceinline__ void nearest(const Ray& r, Hit& h) const {
    sph_nearest(sph, n_sph, 0, r, h);
    pair_nearest<BIG_CULL>(rec, rec_rows, r, h);
    near.query();
    if (kAblate && !walks) return;
    WalkRing rows{ring};
    cluster_nearest<true>(cl, r, h, near, rows);
  }

  __device__ __forceinline__ bool occluded(const Ray& r, float t_max) const {
    if (table_occluded(nullptr, 0, sph, n_sph, r, t_max)) return true;
    if (pair_anyhit<BIG_CULL>(rec, rec_rows, r, jmax(t_max, 0.0f))) return true;
    if (kAblate && !walks) return false;
    WalkRing rows{ring};
    return cluster_anyhit(cl, r, t_max, shadow, rows);
  }
};

// The floats of dynamic shared memory before the ring, rounded up to a
// 16-byte boundary, and this thread's ring after them.
__device__ __forceinline__ size_t ring_offset_floats(size_t table_floats) {
  return (table_floats + 3) / 4 * 4;
}

__device__ __forceinline__ float4* ring_base(float* smem, size_t table_floats) {
  return reinterpret_cast<float4*>(smem + ring_offset_floats(table_floats)) + threadIdx.x;
}

// Shared-memory floats the hyper + supercluster boxes may take (64 KB);
// larger tier tables are read from global memory.
constexpr int kTierFloats = 16384;

// Columns of the K1 / K2 counters [n_blocks, kGeoVisitCols]: the JAX
// package's four (nearest descends, nearest record visits, shadow descends,
// shadow record visits), then the walks' work (nearest slab tests, nearest
// filled rows tested, shadow slab tests, shadow filled rows tested) and the
// nearest queries (ray-bounces).
constexpr int kGeoVisitCols = 9;

// Adds a thread's counts to its 1024-ray block's row of `out`.
template <class Geo>
__device__ __forceinline__ void add_geo_visits(int* out, int64_t i, const Geo& geo) {
  const int v[kGeoVisitCols] = {geo.near.descends,   geo.near.records, geo.shadow.descends,
                                geo.shadow.records,  geo.near.slabs,   geo.near.rows,
                                geo.shadow.slabs,    geo.shadow.rows,  geo.near.queries};
#pragma unroll
  for (int c = 0; c < kGeoVisitCols; ++c) add_visits(out, kGeoVisitCols, i, c, v[c]);
}

// The warp steps of the counting instances ([kWarpStepCols] int64, summed
// over the launch): slab-test steps, then filled-row steps, of the nearest
// and shadow walks together (WarpVisits).
constexpr int kWarpStepCols = 2;

template <class Geo>
__device__ __forceinline__ void add_warp_steps(unsigned long long* out, const Geo& geo) {
  const int v[kWarpStepCols] = {geo.near.slab_steps + geo.shadow.slab_steps,
                                geo.near.row_steps + geo.shadow.row_steps};
#pragma unroll
  for (int c = 0; c < kWarpStepCols; ++c)
    if (v[c]) atomicAdd(out + c, static_cast<unsigned long long>(v[c]));
}

}  // namespace ptx

// The layout of a binned block's dynamic shared memory, for the wrappers to
// size it (accel/kernel_traverse.py walk_layout, kernel_smem_bytes): threads
// a block, ring slots a thread, bytes a slot, and the most tier floats
// staged. The block holds its tables, the staged tiers (when they fit
// kTierFloats), then at the next 16-byte boundary the rings
// (ring_offset_floats). The kernels take the size the wrapper computed.
extern "C" int ptx_walk_layout(int* threads, int* depth, int* slot_bytes, int* tier_floats) {
  *threads = ptx::kWalkThreads;
  *depth = ptx::kRingDepth;
  *slot_bytes = ptx::kRingSlotBytes;
  *tier_floats = ptx::kTierFloats;
  return 0;
}
