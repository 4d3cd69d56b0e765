// X2: the cost of a tile-wide conditional under growing live state, as a
// microbenchmark on Hopper (sm_90a).
//
// Replaces: benchmarks/experiments/microbench_cond_fat.py `make_kernel` /
//   `run` (:14-45): 64 tiles of 8 x 128 floats; each carries n_live copies
//   of its tile (copy i = x * float32(1 + 0.001 i)) through n_iter
//   iterations. An iteration takes y = copy 0 through 8 updates
//   y * 1.000001 + 1e-6, each under lax.cond(max(y) > -1) (USE_COND) or
//   inline, then adds y * 1e-12 to every copy. Output: copy 0 + the other
//   copies * 1e-6, summed in order; with `taken` non-null, each tile's count
//   of updates applied (the check's view of the predicate). Wrapper and
//   plain version: cpupathtrace_tpu_torch/experiments/cond_fat.py.
//
// What bounds it: operations (8 KB in and out a tile). Per element and
// iteration 8 x (multiply, add, compare) + n_live x (multiply, add).
// The design: one block per tile, 256 threads of 4 elements each (thread t
// holds elements t + 256 e, so loads and stores are coalesced); n_live x 4
// floats stay in registers (templated and unrolled, n_iter a run-time bound).
// The predicate is the same for the whole tile, so the block agrees on it
// with one __syncthreads_or per conditional: any element > -1 is max > -1
// for finite inputs. The branch therefore never diverges; what a
// conditional costs here is a block-wide vote and barrier with the live
// state held across it, and what a large n_live costs shows as the
// registers and spills ptxas reports for the instance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8 * 128;
constexpr int kPer = kTile / kThreads;
constexpr int kConds = 8;
constexpr int kMaxLive = 19;
// The script's constants, rounded from double as JAX rounds a Python float.
constexpr float kMul = static_cast<float>(1.000001);
constexpr float kAdd = static_cast<float>(0.000001);
constexpr float kFold = static_cast<float>(1e-12);
constexpr float kWeight = static_cast<float>(1e-6);

// The copies' factors, passed by value (no host-to-device copy per call).
struct Scales {
  float v[kMaxLive];
};

template <int N_LIVE, bool USE_COND>
__global__ void __launch_bounds__(kThreads)
    cond_fat_kernel(const float* x, Scales scale, float* o, int* taken, int n_iter) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile + threadIdx.x;
  float live[N_LIVE][kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const float xv = x[base + e * kThreads];
#pragma unroll
    for (int i = 0; i < N_LIVE; ++i) live[i][e] = xv * scale.v[i];
  }
  int count = 0;
  for (int it = 0; it < n_iter; ++it) {
    float y[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) y[e] = live[0][e];
#pragma unroll
    for (int k = 0; k < kConds; ++k) {
      bool run = true;
      if (USE_COND) {
        bool any = false;
#pragma unroll
        for (int e = 0; e < kPer; ++e) any = any || y[e] > -1.0f;
        run = __syncthreads_or(any) != 0;
      }
      if (run) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) y[e] = y[e] * kMul + kAdd;
        ++count;
      }
    }
#pragma unroll
    for (int i = 0; i < N_LIVE; ++i) {
#pragma unroll
      for (int e = 0; e < kPer; ++e) live[i][e] = live[i][e] + y[e] * kFold;
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    float acc = live[0][e];
#pragma unroll
    for (int i = 1; i < N_LIVE; ++i) acc = acc + live[i][e] * kWeight;
    o[base + e * kThreads] = acc;
  }
  if (taken != nullptr && threadIdx.x == 0) taken[blockIdx.x] = count;
}

template <int N_LIVE, bool USE_COND>
cudaError_t launch(const float* x, const Scales& scale, float* o, int* taken, int blocks,
                   int n_iter, cudaStream_t s) {
  cond_fat_kernel<N_LIVE, USE_COND><<<blocks, kThreads, 0, s>>>(x, scale, o, taken, n_iter);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes: x and o [8 * blocks, 128] on the card,
// scale [n_live] the copies' factors in host memory, taken [blocks] or
// null; n_live 2 or 19. Launches on `stream`, does not synchronise, returns
// the launch's cudaError_t.
extern "C" int ptx_cond_fat_launch(const float* x, const float* scale, float* o, int* taken,
                                   int blocks, int n_live, int use_cond, int n_iter,
                                   void* stream) {
  using namespace ptx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Scales sc = {};
  for (int i = 0; i < n_live && i < kMaxLive; ++i) sc.v[i] = scale[i];
  cudaError_t err = cudaErrorInvalidValue;
  if (n_live == 2)
    err = use_cond ? launch<2, true>(x, sc, o, taken, blocks, n_iter, s)
                   : launch<2, false>(x, sc, o, taken, blocks, n_iter, s);
  else if (n_live == 19)
    err = use_cond ? launch<19, true>(x, sc, o, taken, blocks, n_iter, s)
                   : launch<19, false>(x, sc, o, taken, blocks, n_iter, s);
  return static_cast<int>(err);
}
