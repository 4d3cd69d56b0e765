// K4: the standalone cluster-set query on Hopper (sm_90a): one thread per
// ray runs the K3 device functions (cluster_traverse.cuh), nearest or
// any-hit, and writes t [n] f32 and prim [n] i32.
//
// Replaces: cpupathtrace_tpu/accel/kernel_traverse.py `_single_kernel`
//   (:1158), launched by `_single_call` (:1201) / `cluster_intersect_kernel`
//   (:1250). Wrapper and plain version: `cluster_intersect` and
//   `traverse_clusters[_anyhit]` in cpupathtrace_tpu_torch/accel/kernel_traverse.py.
//
// Output convention of cluster_intersect_kernel: nearest -> (t, prim) of the
// winner or (-1, -1); any-hit -> (1, 0) where something occludes in
// [0, t_lim), else (-1, -1). t_lim <= 0 makes a ray inactive.
//
// Counters (debug_visits): with a `visits` output [ceil(n / 1024), 4] int32,
// each thread adds its supercluster descends, record visits, slab tests
// below the root gate and filled record rows tested to its 1024-ray block's
// row (the Visits policy of cluster_traverse.cuh).
//
// What bounds it: the traversal (see cluster_traverse.cuh); the query adds
// 28 bytes of ray in and 8 bytes out per ray. The block stages the hyper and
// supercluster boxes in shared memory when they fit; rows and cluster boxes
// come from global memory as they are tested (the walk's GlobalRows source,
// not the ring K1's binned form and K2 use).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 256;
constexpr int kTierFloats = 16384;  // 64 KB of staged tier boxes at most

template <bool kCount>
__global__ void __launch_bounds__(kThreads)
    cluster_query_kernel(const float* origin, const float* direction, const float* t_lim,
                         float* t_out, int* p_out, int n_rays, ClusterTables cl,
                         int tier_floats, int any_hit, int* visits) {
  extern __shared__ float smem[];
  stage_tiers(cl, smem, tier_floats);
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r{origin[3 * i], origin[3 * i + 1], origin[3 * i + 2],
              direction[3 * i], direction[3 * i + 1], direction[3 * i + 2]};
  const float lim = t_lim[i];
  std::conditional_t<kCount, Visits, NoVisits> count;
  GlobalRows rows;
  if (any_hit) {
    const bool occ = cluster_anyhit(cl, r, lim, count, rows);
    t_out[i] = occ ? 1.0f : -1.0f;
    p_out[i] = occ ? 0 : -1;
  } else {
    Hit h = no_hit();
    h.t = lim;
    cluster_nearest<false>(cl, r, h, count, rows);
    t_out[i] = h.prim >= 0 ? h.t : -1.0f;
    p_out[i] = h.prim;
  }
  if constexpr (kCount) {
    add_visits(visits, 4, i, 0, count.descends);
    add_visits(visits, 4, i, 1, count.records);
    add_visits(visits, 4, i, 2, count.slabs);
    add_visits(visits, 4, i, 3, count.rows);
  }
}

template <bool kCount>
cudaError_t launch(const float* origin, const float* direction, const float* t_lim,
                   float* t_out, int* p_out, int n_rays, const ClusterTables& cl,
                   int tier_floats, int any_hit, int* visits, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(tier_floats) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_query_kernel<kCount>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n_rays + kThreads - 1) / kThreads;
  cluster_query_kernel<kCount><<<blocks, kThreads, smem, stream>>>(
      origin, direction, t_lim, t_out, p_out, n_rays, cl, tier_floats, any_hit, visits);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
// visits: the zeroed counters [ceil(n_rays / 1024), 4] int32, or null.
extern "C" int ptx_cluster_query_launch(const float* origin, const float* direction,
                                        const float* t_lim, float* t_out, int* p_out,
                                        int n_rays, const float* rec, int n_rec, int rec_rows,
                                        const float* clb, const float* sup, int n_pages,
                                        const float* hyp, int hyp_rows, const float* root,
                                        int cull, int any_hit, int* visits, void* stream) {
  using namespace ptx;
  (void)hyp_rows;
  const ClusterTables cl{rec, n_rec, rec_rows, clb, sup, n_pages, hyp, root, cull};
  const int tiers = n_pages * (kBndCols + kGroup2 * kBndCols);
  const int tier_floats = tiers <= kTierFloats ? tiers : 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      visits ? launch<true>(origin, direction, t_lim, t_out, p_out, n_rays, cl, tier_floats,
                            any_hit, visits, s)
             : launch<false>(origin, direction, t_lim, t_out, p_out, n_rays, cl, tier_floats,
                             any_hit, nullptr, s);
  return static_cast<int>(err);
}
