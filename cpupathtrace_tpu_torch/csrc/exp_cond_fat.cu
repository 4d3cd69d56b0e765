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
// iteration 8 x (multiply, add, compare) + the fold's one multiply and
// n_live adds. The TPU script fixes 64 tiles.
//
// The design: the conditional and the inline instances each have a layout,
// the constants below (the fastest of experiments/cond_fat.py's sweep,
// PERF.md §6): a tile runs on CTAS CTAs of THREADS threads, CTA r holding
// the tile's elements [r 1024 / CTAS, (r + 1) 1024 / CTAS), thread t the
// elements t + THREADS e of that span (coalesced loads and stores); n_live
// x per-thread elements stay in registers (templated and unrolled, n_iter
// a run-time bound). Inline has no coupling inside a tile, so its CTAs are
// independent blocks and more CTAs a tile take its issue work onto more
// SMs. A conditional instance runs a tile on one CTA: each conditional
// stays its own tile-wide decision on the current y, made before the next
// one begins, one __syncthreads_or (any element > -1 is max > -1 for
// finite inputs). (Two CTAs a tile as a thread-block cluster, the vote
// ORed through distributed shared memory after a cluster barrier, lost by
// 8x in the sweep, PERF.md §6: not kept.) The update y * kMul + kAdd is
// computed before the vote and selected after it, and so is the next
// conditional's local predicate for the case that this one runs
// (any(upd > -1); if it does not run, y and its predicate stay): after a
// vote, the next vote's input is one select away, and the vote's latency
// is the chain's only cost. The branch never diverges; what a large n_live
// costs shows as the registers and spills ptxas reports for the instance.
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptx {
namespace {

constexpr int kTile = 8 * 128;
constexpr int kConds = 8;
constexpr int kMaxLive = 19;
// The layouts: threads a CTA of the conditional instances (one CTA a
// tile), threads a CTA and CTAs a tile of the inline ones.
constexpr int kCondThreads = 256;
constexpr int kInlineThreads = 512;
constexpr int kInlineCtas = 2;
// The script's constants, rounded from double as JAX rounds a Python float.
constexpr float kMul = static_cast<float>(1.000001);
constexpr float kAdd = static_cast<float>(0.000001);
constexpr float kFold = static_cast<float>(1e-12);
constexpr float kWeight = static_cast<float>(1e-6);

// The copies' factors, passed by value (no host-to-device copy per call).
struct Scales {
  float v[kMaxLive];
};

// Any of a thread's elements above -1 (max(y) > -1 for finite y; a NaN
// element counts as not above, as in the plain version).
template <int N>
__device__ __forceinline__ bool any_above(const float (&y)[N]) {
  bool any = false;
#pragma unroll
  for (int e = 0; e < N; ++e) any = any | (y[e] > -1.0f);
  return any;
}

template <int N_LIVE, bool USE_COND, int THREADS, int CTAS>
__global__ void __launch_bounds__(THREADS)
    cond_fat_kernel(const float* x, Scales scale, float* o, int* taken, int n_iter) {
  constexpr int kPer = kTile / (THREADS * CTAS);
  static_assert(kPer * THREADS * CTAS == kTile, "a layout must cover the tile");
  static_assert(!USE_COND || CTAS == 1, "a conditional's vote spans one CTA");
  const int tile = blockIdx.x / CTAS, rank = blockIdx.x % CTAS;
  const size_t base =
      static_cast<size_t>(tile) * kTile + rank * (kTile / CTAS) + threadIdx.x;
  float live[N_LIVE][kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const float xv = x[base + e * THREADS];
#pragma unroll
    for (int i = 0; i < N_LIVE; ++i) live[i][e] = xv * scale.v[i];
  }
  int count = 0;
  for (int it = 0; it < n_iter; ++it) {
    float y[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) y[e] = live[0][e];
    bool local = any_above(y);  // this thread's part of the next conditional's predicate
#pragma unroll
    for (int k = 0; k < kConds; ++k) {
      float upd[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) upd[e] = y[e] * kMul + kAdd;
      bool run = true;
      if constexpr (USE_COND) {
        // Off the chain: the next conditional's local predicate if this
        // one runs (if it does not, y and so the predicate stay).
        const bool local_if_run = any_above(upd);
        run = __syncthreads_or(local) != 0;
        local = run ? local_if_run : local;
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) y[e] = run ? upd[e] : y[e];
      count += run ? 1 : 0;
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
    o[base + e * THREADS] = acc;
  }
  if (taken != nullptr && rank == 0 && threadIdx.x == 0) taken[tile] = count;
}

// The instance's threads a CTA and CTAs a tile.
template <bool USE_COND>
struct Layout {
  static constexpr int kThreads = USE_COND ? kCondThreads : kInlineThreads;
  static constexpr int kCtas = USE_COND ? 1 : kInlineCtas;
};

template <int N_LIVE, bool USE_COND>
cudaError_t launch(const float* x, const Scales& scale, float* o, int* taken, int tiles,
                   int n_iter, cudaStream_t s) {
  using L = Layout<USE_COND>;
  cond_fat_kernel<N_LIVE, USE_COND, L::kThreads, L::kCtas>
      <<<tiles * L::kCtas, L::kThreads, 0, s>>>(x, scale, o, taken, n_iter);
  return cudaGetLastError();
}

// Threads a CTA, CTAs a tile and tiles resident at once (blocks a SM x
// SMs / CTAs).
template <int N_LIVE, bool USE_COND>
cudaError_t layout(int* threads, int* ctas, int* resident) {
  using L = Layout<USE_COND>;
  *threads = L::kThreads;
  *ctas = L::kCtas;
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, cond_fat_kernel<N_LIVE, USE_COND, L::kThreads, L::kCtas>, L::kThreads, 0);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *resident = per_sm * sms / L::kCtas;
  return err;
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

// The instance's layout: threads a CTA, CTAs a tile and the tiles that can
// be resident at once.
extern "C" int ptx_cond_fat_layout(int n_live, int use_cond, int* threads, int* ctas,
                                   int* resident) {
  using namespace ptx;
  cudaError_t err = cudaErrorInvalidValue;
  if (n_live == 2)
    err = use_cond ? layout<2, true>(threads, ctas, resident)
                   : layout<2, false>(threads, ctas, resident);
  else if (n_live == 19)
    err = use_cond ? layout<19, true>(threads, ctas, resident)
                   : layout<19, false>(threads, ctas, resident);
  return static_cast<int>(err);
}
