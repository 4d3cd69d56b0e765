// K6: the candidate scan of the binned wavefront for Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/accel/pallas_traverse.py `_cand_kernel` (:121),
//   launched by `_cand_call` (:207, pallas_call :221): per ray, the slab test
//   against every cluster box, keeping the top-M (entry, id) candidates in
//   (entry, id)-lexicographic order above the bound (t_lo, id_lo) and below
//   the ray's best hit, plus the (M+1)-th as the overflow row. The wrapper is
//   cpupathtrace_tpu_torch/accel/traverse.py `candidates`; the plain version
//   is its `candidates_reference`.
//
// What bounds it on this card: operations. A ray reads 36 bytes and writes
// 8 (M+1) bytes, and does ~40 float operations per cluster (the slab test and
// the insertion), so at hundreds of clusters it is compute-bound by far.
//
// What the design does about it: one thread per ray, 256 per block; the
// bounds table (32 bytes a cluster, 128 KB at the 4096-cluster limit) is
// staged once per block in shared memory, and every lane reads the same
// cluster at once (a broadcast). The M+1 slots live in registers (M is a
// template parameter, so the insertion unrolls as in the TPU kernel). The
// TPU skipped a whole 1024-ray block when no ray in it was pending; here a
// ray with nothing pending (t_lo = +inf) exits on its own, after writing -1
// ids and +inf entries to every slot, as the TPU's skip leaves them.
//
// The arithmetic is `_cand_kernel`'s float32 operations in its order (built
// with --fmad=false, IEEE division); the cluster id is carried as a float, as
// on the TPU, so the lexicographic comparisons are bit-exact with the plain
// version, and the exactness rounds of the pipeline terminate.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "dense_intersect.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 256;
constexpr int kBndCols = 8;  // lo3 hi3 valid pad
constexpr int kRayRows = 9;  // ox oy oz dx dy dz best t_lo id_lo

__device__ __forceinline__ float slab_inv(float d) { return fabsf(d) > 0.0f ? 1.0f / d : FLT_MAX; }

template <int M>
__global__ void __launch_bounds__(kThreads)
    binned_cand_kernel(const float* __restrict__ bounds, int n_clusters,
                       const float* __restrict__ rays, int n, int* __restrict__ ids_out,
                       float* __restrict__ ent_out) {
  extern __shared__ float s_bnd[];
  for (int i = threadIdx.x; i < n_clusters * kBndCols; i += blockDim.x) s_bnd[i] = bounds[i];
  __syncthreads();
  const int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float e[M + 1], cid[M + 1];
#pragma unroll
  for (int j = 0; j <= M; ++j) {
    e[j] = INFINITY;
    cid[j] = INFINITY;
  }
  const float t_lo = rays[7 * static_cast<int64_t>(n) + r];
  if (t_lo < INFINITY) {
    const float ox = rays[r], oy = rays[n + r], oz = rays[2 * static_cast<int64_t>(n) + r];
    const float dx = rays[3 * static_cast<int64_t>(n) + r];
    const float dy = rays[4 * static_cast<int64_t>(n) + r];
    const float dz = rays[5 * static_cast<int64_t>(n) + r];
    const float best = rays[6 * static_cast<int64_t>(n) + r];
    const float id_lo = rays[8 * static_cast<int64_t>(n) + r];
    const float ix = slab_inv(dx), iy = slab_inv(dy), iz = slab_inv(dz);
    for (int c = 0; c < n_clusters; ++c) {
      const float* b = s_bnd + c * kBndCols;
      const float t1x = (b[0] - ox) * ix, t2x = (b[3] - ox) * ix;
      const float t1y = (b[1] - oy) * iy, t2y = (b[4] - oy) * iy;
      const float t1z = (b[2] - oz) * iz, t2z = (b[5] - oz) * iz;
      const float tmin = jmax(jmax(jmin(t1x, t2x), jmin(t1y, t2y)), jmin(t1z, t2z));
      const float tmax = jmin(jmin(jmax(t1x, t2x), jmax(t1y, t2y)), jmax(t1z, t2z));
      const float entry = tmin < 0.0f ? 0.0f : tmin;
      const float cf = static_cast<float>(c);
      const bool after = (entry > t_lo) || (entry == t_lo && cf > id_lo);
      const bool ok = b[6] > 0.5f && tmax >= 0.0f && tmin <= tmax && entry < best && after;
      if (!ok) continue;  // (inf, inf) displaces nothing
      float ce = entry, ci = cf;
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const bool less = ce < e[j] || (ce == e[j] && ci < cid[j]);
        const float te = e[j], ti = cid[j];
        e[j] = less ? ce : te;
        cid[j] = less ? ci : ti;
        ce = less ? te : ce;
        ci = less ? ti : ci;
      }
      const bool less = ce < e[M] || (ce == e[M] && ci < cid[M]);
      e[M] = less ? ce : e[M];
      cid[M] = less ? ci : cid[M];
    }
  }
#pragma unroll
  for (int j = 0; j <= M; ++j) {
    const int64_t k = static_cast<int64_t>(j) * n + r;
    ent_out[k] = e[j];
    ids_out[k] = e[j] < INFINITY ? static_cast<int>(cid[j]) : -1;
  }
}

template <int M>
cudaError_t launch(const float* bounds, int n_clusters, const float* rays, int n, int* ids,
                   float* ent, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_clusters) * kBndCols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        binned_cand_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + kThreads - 1) / kThreads;
  binned_cand_kernel<M><<<blocks, kThreads, smem, stream>>>(bounds, n_clusters, rays, n, ids,
                                                            ent);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. bounds [n_clusters, 8]; rays [9, n]
// planes; ids / ent [m + 1, n]. Launches on `stream`, does not synchronise,
// allocates nothing, returns the launch's cudaError_t (cudaErrorInvalidValue
// for m outside 1..7).
extern "C" int ptx_binned_cand_launch(const float* bounds, int n_clusters, const float* rays,
                                      int n, int m, int* ids, float* ent, void* stream) {
  using namespace ptx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return static_cast<int>(launch<1>(bounds, n_clusters, rays, n, ids, ent, s));
    case 2: return static_cast<int>(launch<2>(bounds, n_clusters, rays, n, ids, ent, s));
    case 3: return static_cast<int>(launch<3>(bounds, n_clusters, rays, n, ids, ent, s));
    case 4: return static_cast<int>(launch<4>(bounds, n_clusters, rays, n, ids, ent, s));
    case 5: return static_cast<int>(launch<5>(bounds, n_clusters, rays, n, ids, ent, s));
    case 6: return static_cast<int>(launch<6>(bounds, n_clusters, rays, n, ids, ent, s));
    case 7: return static_cast<int>(launch<7>(bounds, n_clusters, rays, n, ids, ent, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
