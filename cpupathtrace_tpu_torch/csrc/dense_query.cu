// K5: the dense nearest-hit query of the wavefront for Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/ops/pallas_intersect.py `_dense_kernel` (:31),
//   launched by `_dense_pallas_call` / `dense_intersect_pallas` (:140, :173):
//   for every ray the nearest (t, prim) over all triangles (Moller-Trumbore,
//   eps 1e-6, the cull rule, `valid`) and then all spheres (near root). The
//   wrapper is cpupathtrace_tpu_torch/ops/intersect.py `dense_intersect`;
//   the plain version is its `dense_intersect_reference`.
//
// What bounds it on this card: the tests, not memory. A ray reads 24 bytes
// and writes 8, and costs ~64 flops per triangle and ~20 per sphere, so a
// scene of more than a handful of primitives is compute-bound; each test is
// a dependent chain (cross, dot, divide) whose latency the warp scheduler
// hides only with enough warps in flight.
//
// What the design does about it: one thread per ray, 256 per block, the
// tables staged once per block in shared memory when they fit (kMaxStage
// bytes; larger tables stay in global memory and are read through L1, still
// one row for all lanes at a time), so every lane reads the same row at once
// (a broadcast). The per-row arithmetic is tri_scan / sph_scan of
// dense_intersect.cuh, the same device functions K1 and K2 run, which do
// `_dense_kernel`'s float32 operations in its order (built with
// --fmad=false). A row wins only by improving strictly, so an exact tie goes
// to the lowest row (the jnp version's argmin).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_intersect.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 256;
// Tables up to this size are staged in shared memory (~1000 triangles).
constexpr size_t kMaxStage = 96 * 1024;

struct Params {
  const float* origin;     // [n, 3]
  const float* direction;  // [n, 3]
  float* t_out;            // [n]; -1 on a miss
  int* prim_out;           // [n]; -1 on a miss
  int n_rays;
  const float* tri;  // [n_tri, kTriCols]
  int n_tri;
  const float* sph;  // [n_sph, kSphCols]
  int n_sph;
};

template <bool kStaged>
__global__ void __launch_bounds__(kThreads) dense_query_kernel(const Params p) {
  extern __shared__ float smem[];
  const float* tri = p.tri;
  const float* sph = p.sph;
  if (kStaged) {
    float* s_tri = smem;
    float* s_sph = smem + p.n_tri * kTriCols;
    for (int i = threadIdx.x; i < p.n_tri * kTriCols; i += blockDim.x) s_tri[i] = p.tri[i];
    for (int i = threadIdx.x; i < p.n_sph * kSphCols; i += blockDim.x) s_sph[i] = p.sph[i];
    __syncthreads();
    tri = s_tri;
    sph = s_sph;
  }
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  const Ray r{p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2],
              p.direction[3 * i], p.direction[3 * i + 1], p.direction[3 * i + 2]};
  float best_t = INFINITY, u, v;
  int prim = tri_scan(tri, p.n_tri, r, best_t, u, v);
  const int k = sph_scan(sph, p.n_sph, r, best_t);  // must beat the triangles
  if (k >= 0) prim = k + p.n_tri;
  p.t_out[i] = prim >= 0 ? best_t : -1.0f;
  p.prim_out[i] = prim;
}

template <bool kStaged>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dense_query_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.n_rays + kThreads - 1) / kThreads;
  dense_query_kernel<kStaged><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
extern "C" int ptx_dense_query_launch(const float* origin, const float* direction, float* t_out,
                                      int* prim_out, int n_rays, const float* tri, int n_tri,
                                      const float* sph, int n_sph, void* stream) {
  using namespace ptx;
  const Params p{origin, direction, t_out, prim_out, n_rays, tri, n_tri, sph, n_sph};
  const size_t bytes = (static_cast<size_t>(n_tri) * kTriCols +
                        static_cast<size_t>(n_sph) * kSphCols) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bytes <= kMaxStage) return static_cast<int>(launch<true>(p, bytes, s));
  return static_cast<int>(launch<false>(p, 0, s));
}
