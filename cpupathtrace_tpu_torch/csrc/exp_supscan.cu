// X1: the cost of the supercluster-tier slab pass per query, as a
// microbenchmark on Hopper (sm_90a).
//
// Replaces: benchmarks/experiments/microbench_supscan.py `make_kernel` /
//   `run` (:20-62): 64 blocks of `rows` x 128 rays; for n_iter iterations
//   every ray takes its slab entry into each of `sp` supercluster boxes
//   (pair_slab_entries there, the port's slab_entry of cluster_traverse.cuh
//   here), the block reduces a flag (any entry < 1e30) into `acc`, and the
//   next iteration's origins move by acc * 1e-9 so no iteration can be
//   hoisted. Output: the block's first 8 rows of x plus acc; with `ent`
//   non-null, also each ray's least entry over the boxes in the last
//   iteration (the check's view of every slab test; null when timed).
//   Wrapper and plain version: cpupathtrace_tpu_torch/experiments/supscan.py.
//
// What bounds it: operations. Per iteration and ray, sp slab tests of ~31
// float operations against boxes in shared memory (broadcast reads); the
// inputs are 8 KB a block. The design: one block per TPU block, 256
// threads, each thread the rows * 128 / 256 rays of its lanes; every entry
// is computed (a min over the boxes, no early exit, as the TPU's vector
// pass), and the block-wide flag is one __syncthreads_or per iteration.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_traverse.cuh"
#include "rng.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 256;
constexpr int kXRows = 16;  // rows of x per block (the TPU's (16, 128) block)
constexpr int kOutRows = 8;
constexpr int kMaxRaysPerThread = kXRows * kLanes / kThreads;

__global__ void __launch_bounds__(kThreads)
    supscan_kernel(const float* sup, int sp, const float* x, float* o, float* ent, int rows,
                   int n_iter) {
  extern __shared__ float s_sup[];
  for (int i = threadIdx.x; i < sp * kBndCols; i += blockDim.x) s_sup[i] = sup[i];
  __syncthreads();
  const float* xb = x + static_cast<size_t>(blockIdx.x) * kXRows * kLanes;
  const int per = rows * kLanes / kThreads;
  float ox[kMaxRaysPerThread], oy[kMaxRaysPerThread], oz[kMaxRaysPerThread];
  InvDir inv[kMaxRaysPerThread];
#pragma unroll
  for (int k = 0; k < kMaxRaysPerThread; ++k) {
    const float xv = k < per ? xb[threadIdx.x + k * kThreads] : 0.0f;
    ox[k] = xv * 0.1f;
    oy[k] = xv * 0.2f;
    oz[k] = xv * 0.3f;
    inv[k] = InvDir{inv_dir(xv + 1.0f), inv_dir(xv + 2.0f), inv_dir(xv + 3.0f)};
  }
  float acc = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    float m = INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxRaysPerThread; ++k) {
      if (k >= per) break;
      const Ray r{ox[k] + acc * 1e-9f, oy[k], oz[k], 0.0f, 0.0f, 0.0f};
      float mk = INFINITY;
      for (int b = 0; b < sp; ++b) mk = fminf(mk, slab_entry(s_sup + b * kBndCols, r, inv[k]));
      if (ent != nullptr && it == n_iter - 1)
        ent[static_cast<size_t>(blockIdx.x) * rows * kLanes + threadIdx.x + k * kThreads] = mk;
      m = fminf(m, mk);
    }
    acc = acc + (__syncthreads_or(m < 1e30f) ? 1.0f : 0.0f);
  }
  float* ob = o + static_cast<size_t>(blockIdx.x) * kOutRows * kLanes;
  for (int i = threadIdx.x; i < kOutRows * kLanes; i += blockDim.x) ob[i] = xb[i] + acc;
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes: sup [sp, 8], x [16 * blocks, 128],
// o [8 * blocks, 128], ent [blocks * rows * 128] or null, rows 8 or 16.
// Launches on `stream`, does not synchronise, returns the launch's
// cudaError_t.
extern "C" int ptx_supscan_launch(const float* sup, int sp, const float* x, float* o, float* ent,
                                  int blocks, int rows, int n_iter, void* stream) {
  using namespace ptx;
  if (rows <= 0 || rows > kXRows || (rows * kLanes) % kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(sp) * kBndCols * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        supscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  supscan_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      sup, sp, x, o, ent, rows, n_iter);
  return static_cast<int>(cudaGetLastError());
}
