// K1: the dense path-trace megakernel for Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/integrator/pallas_megakernel.py,
//   `_make_megakernel` in its while-loop form with n_super = 0, launched by
//   `_mega_call` / `trace_megakernel`. Both dense forms: the pair-record form
//   (1..128 triangles in one Plucker record + the sphere table) and the
//   table form (triangle table + sphere table).
//
// What bounds it on this card: not memory. A path reads its ray (24 bytes)
// and writes its spectrum (16 bytes), ~40 bytes of HBM traffic for up to
// max_depth bounces. Each bounce is a few hundred flops per record row
// tested (nearest hit, one shadow ray per point light and per emitter draw)
// in loops whose every iteration reads a table row, so the kernel is bound
// by instruction latency and by divergence: lanes of a warp end their paths
// at different depths (misses, roulette) and take different BSDF branches.
//
// What the design does about it: one thread per ray with the whole path
// state in registers (the per-bounce body is bounce_body.cuh, shared with
// the single-bounce kernel K2); every table (pair record, triangles, spheres,
// materials, lights, emitters) staged once per block in shared memory,
// where all lanes read the same row at the same time (a broadcast, no bank
// conflicts); each thread leaves its loop when its path ends instead of
// waiting for the block; only the chosen BSDF branch is computed; shadow
// rays stop at the first occluder.
//
// Parity with the TPU kernel and with the torch twin
// (cpupathtrace_tpu_torch/integrator/megakernel.py): the same arithmetic in
// the same order, built with --fmad=false so no product is fused into an
// add, and the same random stream (rng.cuh) with the same draw order:
// u_rt, then (rsel, u1, u2) per emitter draw, then (u1, u2, ub).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_body.cuh"
#include "dense_intersect.cuh"
#include "rng.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 256;

struct Params {
  const float* origin;     // [n_rays, 3]
  const float* direction;  // [n_rays, 3]
  float* spectrum;         // [n_rays, 4]: r, g, b, collected
  int n_rays;
  const float* tri;  // [n_tri, 24]; n_tri = 0 in the pair form
  int n_tri;
  const float* sph;  // [n_sph, 8]
  int n_sph;
  const float* mat;  // [n_mat, 12]
  int n_mat;
  const float* lgt;  // [n_lights, 8]
  int n_lights;
  const float* em;  // [n_em, 24]
  int n_em;
  int em_k;
  const float* rec;  // [rec_rows, rec_stride]; rec_rows = 0 in the table form
  int rec_rows;
  int rec_stride;
  const int* seed;  // [1], on the device
  int max_depth;
  float eps;
};

size_t smem_floats(const Params& p) {
  return static_cast<size_t>(p.rec_rows) * kRecCols + static_cast<size_t>(p.n_tri) * kTriCols +
         static_cast<size_t>(p.n_sph) * kSphCols + static_cast<size_t>(p.n_mat) * kMatCols +
         static_cast<size_t>(p.n_lights) * kLgtCols + static_cast<size_t>(p.n_em) * kEmCols;
}

template <int CULL>
__global__ void __launch_bounds__(kThreads) megakernel(const Params p) {
  extern __shared__ float smem[];
  float* s_rec = smem;
  float* s_tri = s_rec + p.rec_rows * kRecCols;
  float* s_sph = s_tri + p.n_tri * kTriCols;
  float* s_mat = s_sph + p.n_sph * kSphCols;
  float* s_lgt = s_mat + p.n_mat * kMatCols;
  float* s_em = s_lgt + p.n_lights * kLgtCols;
  stage_rows(s_rec, p.rec, p.rec_rows, kRecCols, p.rec_stride);
  stage_rows(s_tri, p.tri, p.n_tri, kTriCols, kTriCols);
  stage_rows(s_sph, p.sph, p.n_sph, kSphCols, kSphCols);
  stage_rows(s_mat, p.mat, p.n_mat, kMatCols, kMatCols);
  stage_rows(s_lgt, p.lgt, p.n_lights, kLgtCols, kLgtCols);
  stage_rows(s_em, p.em, p.n_em, kEmCols, kEmCols);
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;

  const DenseGeo<CULL> geo{s_rec, p.rec_rows, s_tri, p.n_tri, s_sph, p.n_sph};
  const Shading sh{s_mat, p.n_mat, s_lgt, p.n_lights, s_em, p.n_em, p.em_k, p.eps};
  PathState s;
  s.rng = seed_rng(*p.seed, i);
  s.ray = Ray{p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2],
              p.direction[3 * i], p.direction[3 * i + 1], p.direction[3 * i + 2]};
  s.sr = s.sg = s.sb = 1.0f;
  s.out_r = s.out_g = s.out_b = 0.0f;
  s.divisor = s.bounce_pd = s.contrib = 1.0f;
  s.collected = false;
  for (int depth = 0; depth < p.max_depth; ++depth) {
    if (!bounce_body<false>(geo, sh, depth, s)) break;
  }
  reinterpret_cast<float4*>(p.spectrum)[i] =
      make_float4(s.out_r, s.out_g, s.out_b, s.collected ? 1.0f : 0.0f);
}

template <int CULL>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megakernel<CULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.n_rays + kThreads - 1) / kThreads;
  megakernel<CULL><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
extern "C" int ptx_megakernel_launch(const float* origin, const float* direction,
                                     float* spectrum, int n_rays, const float* tri, int n_tri,
                                     const float* sph, int n_sph, const float* mat, int n_mat,
                                     const float* lgt, int n_lights, const float* em, int n_em,
                                     int em_k, const float* rec, int rec_rows, int rec_stride,
                                     int cull_mode, const int* seed, int max_depth,
                                     float epsilon, void* stream) {
  using namespace ptx;
  const Params p{origin, direction, spectrum, n_rays, tri, n_tri, sph, n_sph,
                 mat, n_mat, lgt, n_lights, em, n_em, em_k, rec, rec_rows, rec_stride,
                 seed, max_depth, epsilon};
  const size_t smem = smem_floats(p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rec_rows && cull_mode == 0) return static_cast<int>(launch<0>(p, smem, s));
  if (rec_rows && cull_mode == 1) return static_cast<int>(launch<1>(p, smem, s));
  return static_cast<int>(launch<-1>(p, smem, s));
}
