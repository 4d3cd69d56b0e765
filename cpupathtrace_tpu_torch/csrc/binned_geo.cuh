// The geometry of a binned scene for the per-bounce body (bounce_body.cuh):
// spheres, then the big-partition pair record, then the cluster set through
// the traversal K3 (cluster_traverse.cuh), each improving strictly on the
// last; shadow rays likewise, stopping at the first occluder. Shared by the
// megakernel's binned form (K1, megakernel.cu) and the bounce kernel (K2,
// bounce.cu), so their nearest and occlusion logic cannot drift.
//
// Port of the binned branch of `body` in
// cpupathtrace_tpu/integrator/pallas_megakernel.py (:424-457, 502-571).
// Count: the traversal counter policy (NoVisits, or Visits for
// debug_visits); `near` counts the nearest queries, `shadow` the shadow
// queries of one path; add_geo_visits writes them as the counters' row.
#pragma once

#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"

namespace ptx {

template <int BIG_CULL, class Count = NoVisits>
struct BinnedGeo {
  const float* rec;
  int rec_rows;
  const float* sph;
  int n_sph;
  ClusterTables cl;
  mutable Count near{};
  mutable Count shadow{};

  __device__ __forceinline__ void nearest(const Ray& r, Hit& h) const {
    sph_nearest(sph, n_sph, 0, r, h);
    pair_nearest<BIG_CULL>(rec, rec_rows, r, h);
    near.query();
    cluster_nearest<true>(cl, r, h, near);
  }

  __device__ __forceinline__ bool occluded(const Ray& r, float t_max) const {
    if (table_occluded(nullptr, 0, sph, n_sph, r, t_max)) return true;
    if (pair_anyhit<BIG_CULL>(rec, rec_rows, r, jmax(t_max, 0.0f))) return true;
    return cluster_anyhit(cl, r, t_max, shadow);
  }
};

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

}  // namespace ptx
