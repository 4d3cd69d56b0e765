// X5: the per-block cost of staging constant tables, as a microbenchmark on
// Hopper (sm_90a).
//
// Replaces: benchmarks/experiments/microbench_smemtables.py `make_kernel` /
//   `run` (:17-45): an almost empty kernel over blocks of rays, each block
//   with 0 or 6 small constant tables and optionally a 128 x 128 table as
//   inputs; it writes x + 1e-9 * (the sum of each table's [0, 0]). On the
//   TPU the tables were SMEM / VMEM inputs of every grid step; here every
//   launched block stages its tables into shared memory. With `staged`
//   non-null, each block also writes what it staged to its row of `staged`
//   (the check's view of every staged element; null when timed). Wrapper
//   and plain version: cpupathtrace_tpu_torch/experiments/smem_tables.py.
//
// What bounds it: bytes. Each ray is read and written once (8 bytes); every
// block reads its tables again (from L1 or L2 after the first).
//
// Two staging instances of one kernel (STAGING):
//   kRows: K1's own loop (stage_rows of bounce_body.cuh, as megakernel.cu
//     :120-125 and bounce.cu:124-129 stage): all threads copy floats in a
//     strided loop (an integer divide and modulo per element, each table
//     after the last), then __syncthreads, then the first ray load. This is
//     what K1 and K2 pay per block.
//   kBulk: warp 0 stages every table with Hopper's asynchronous copies
//     (bulk_copy.cuh), all in flight at once and completing on one
//     mbarrier, while every thread's first ray load is in flight too:
//     - a table whose staged columns fill its rows (or a single row) is one
//       span: lane 0 issues one cp.async.bulk for its 16-byte-aligned middle;
//     - a strided table (the pair record stages 28 of its 128 columns) goes
//       by 16-byte cp.async per row segment, its rows spread over the lanes;
//     - bytes that break the 16-byte rule (a span or row segment whose size
//       is not a multiple of 16 bytes, a source not 16-byte aligned) are not
//       refused: they go by 4-byte cp.async. In shared memory every table
//       starts on a 16-byte boundary, shifted by its source's offset from
//       one when it is a span, so that the bulk copy's source and
//       destination are aligned alike (the layout is made by `layout`).
//     The copies are issued before the block's first ray loads and waited
//     for after them.
//
// Launch shape: the rays in tiles of `threads`; block b of the G launched
// blocks takes tiles b, b + G, b + 2G, ... (smem_tables.py:block_tiles is
// this walk). G = one block per tile is K1's shape (16,384 blocks of 256
// for the box frame); G = SMs x resident blocks per SM is a persistent grid,
// in which each block stages once and walks its share. Rays move as float4,
// a quarter of the block's threads per tile, so one pass of the block covers
// four of its tiles; the next pass's load is issued before this pass's
// store; the ragged tail is masked.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_body.cuh"
#include "bulk_copy.cuh"

namespace ptx {
namespace {

constexpr int kMaxTables = 8;
constexpr int kRows = 0;
constexpr int kBulk = 1;
constexpr int kSlots = 4;  // tiles per pass: a tile is `threads` rays, threads / 4 float4s
constexpr int kArrivals = 33;  // warp 0's cp.async arrivals + lane 0's expect_tx

struct Table {
  const float* p;
  int rows, cols, stride;
  int smem;    // byte offset of the staged copy in shared memory
  int packed;  // float offset of the table in a row of `staged`
  int head;    // spans: floats before the bulk copy (4-byte copies)
  int bulk;    // spans: bytes of the bulk copy
};

struct Tables {
  Table t[kMaxTables];
  int n;
  int floats;           // staged floats per block
  uint32_t bulk_bytes;  // the barrier's transaction count
};

__device__ __forceinline__ bool is_span(const Table& t) {
  return t.cols == t.stride || t.rows == 1;
}

__device__ __forceinline__ float4 load4(const float* x, int64_t i, int64_t n) {
  if (i + 4 <= n) return __ldcs(reinterpret_cast<const float4*>(x + i));
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i < n) v.x = x[i];
  if (i + 1 < n) v.y = x[i + 1];
  if (i + 2 < n) v.z = x[i + 2];
  return v;
}

__device__ __forceinline__ void store4(float* o, int64_t i, int64_t n, float4 v) {
  if (i + 4 <= n) {
    __stcs(reinterpret_cast<float4*>(o + i), v);
    return;
  }
  if (i < n) o[i] = v.x;
  if (i + 1 < n) o[i + 1] = v.y;
  if (i + 2 < n) o[i + 2] = v.z;
}

// Warp 0: every table's copies, then this lane's arrival.
__device__ __forceinline__ void issue_copies(unsigned char* smem, const Tables& tb,
                                             uint64_t* bar) {
  const int lane = threadIdx.x;
  if (lane == 0) mbar_arrive_expect_tx(bar, tb.bulk_bytes);
  for (int k = 0; k < tb.n; ++k) {
    const Table& t = tb.t[k];
    float* dst = reinterpret_cast<float*>(smem + t.smem);
    if (is_span(t)) {
      const int total = t.rows * t.cols, tail = t.head + t.bulk / 4;
      if (lane == 0 && t.bulk) bulk_g2s(dst + t.head, t.p + t.head, t.bulk, bar);
      for (int f = lane; f < t.head; f += 32) cp_async4(dst + f, t.p + f);
      for (int f = tail + lane; f < total; f += 32) cp_async4(dst + f, t.p + f);
    } else {
      for (int r = lane; r < t.rows; r += 32) {
        const float* s = t.p + static_cast<size_t>(r) * t.stride;
        float* d = dst + r * t.cols;
        for (int f = 0; f < t.cols;) {
          if (f + 4 <= t.cols && aligned16(s + f) && aligned16(d + f)) {
            cp_async16(d + f, s + f);
            f += 4;
          } else {
            cp_async4(d + f, s + f);
            ++f;
          }
        }
      }
    }
  }
  cp_async_arrive_noinc(bar);
}

// At most 32 registers (1024 threads, 2 blocks of them per SM): K1's
// shape of 256 threads then fits 8 blocks on an SM in every instance.
template <int STAGING>
__global__ void __launch_bounds__(1024, 2)
    smem_tables_kernel(const float* __restrict__ x, float* __restrict__ o, int64_t n, Tables tb,
                       float* staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  const int tile = blockDim.x, vec = tile / 4;
  const int slot = threadIdx.x / vec;
  const int64_t n_tiles = (n + tile - 1) / tile, lead = 4 * (threadIdx.x % vec);
  // This thread's first ray in pass p of the block's walk, -1 past its tiles.
  auto ray = [&](int p) -> int64_t {
    const int64_t t = blockIdx.x + (static_cast<int64_t>(p) * kSlots + slot) * gridDim.x;
    return t < n_tiles ? t * tile + lead : -1;
  };

  int64_t i = ray(0);
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (STAGING == kBulk) {
    // The barrier's set-up and the copies come before any ray load: the
    // release of mbarrier.init's fence and of lane 0's arrival would
    // otherwise wait for that load to land.
    if (tb.n) {
      if (threadIdx.x == 0) mbar_init(&bar, kArrivals);
      __syncthreads();
      if (threadIdx.x < 32) issue_copies(smem, tb, &bar);
    }
    if (i >= 0) v = load4(x, i, n);  // in flight while the tables arrive
    if (tb.n) mbar_wait(&bar, 0);
  } else {
    for (int k = 0; k < tb.n; ++k) {
      const Table& t = tb.t[k];
      stage_rows(reinterpret_cast<float*>(smem + t.smem), t.p, t.rows, t.cols, t.stride);
    }
    __syncthreads();
    if (i >= 0) v = load4(x, i, n);
  }

  float acc = 0.0f;
  for (int k = 0; k < tb.n; ++k) {
    const float t00 = *reinterpret_cast<const float*>(smem + tb.t[k].smem);
    acc = k ? acc + t00 : t00;
  }
  const float s = tb.n ? acc * 1e-9f : 0.0f;
  if (staged != nullptr) {
    float* row = staged + static_cast<size_t>(blockIdx.x) * tb.floats;
    for (int k = 0; k < tb.n; ++k) {
      const Table& t = tb.t[k];
      const float* src = reinterpret_cast<const float*>(smem + t.smem);
      for (int e = threadIdx.x; e < t.rows * t.cols; e += blockDim.x) row[t.packed + e] = src[e];
    }
  }
  for (int p = 1; i >= 0; ++p) {
    const int64_t next = ray(p);
    const float4 w = v;
    if (next >= 0) v = load4(x, next, n);
    store4(o, i, n, make_float4(w.x + s, w.y + s, w.z + s, w.w + s));
    i = next;
  }
}

// The tables' places in shared memory and in a staged row, and the bulk
// copies' split; returns the dynamic shared memory a block needs.
size_t layout(Tables& tb, int n_tables, const float* const* ptrs, const int* rows,
              const int* cols, const int* strides) {
  tb = Tables{};
  tb.n = n_tables;
  size_t end = 0;
  for (int k = 0; k < n_tables; ++k) {
    Table t{ptrs[k], rows[k], cols[k], strides[k], 0, tb.floats, 0, 0};
    const int total = t.rows * t.cols;
    const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(t.p) & 15);
    size_t at = (end + 15) & ~static_cast<size_t>(15);
    if (t.cols == t.stride || t.rows == 1) {
      at += mis;
      t.head = ((16 - mis) & 15) / 4 < total ? ((16 - mis) & 15) / 4 : total;
      t.bulk = ((total - t.head) * 4) & ~15;
      tb.bulk_bytes += t.bulk;
    }
    t.smem = static_cast<int>(at);
    end = at + static_cast<size_t>(total) * sizeof(float);
    tb.floats += total;
    tb.t[k] = t;
  }
  return (end + 15) & ~static_cast<size_t>(15);
}

using Kernel = void (*)(const float*, float*, int64_t, Tables, float*);

Kernel instance(int staging) {
  switch (staging) {
    case kRows: return smem_tables_kernel<kRows>;
    case kBulk: return smem_tables_kernel<kBulk>;
    default: return nullptr;
  }
}

// The instance of this launch with its tables laid out (`tb`, `smem`) and
// its dynamic shared memory allowed; null if the arguments are out of
// range or the attribute was refused.
Kernel prepare(int staging, int threads, int n_tables, const float* const* ptrs,
               const int* rows, const int* cols, const int* strides, Tables& tb, size_t& smem) {
  if (threads < 32 || threads > 1024 || threads % 32 || n_tables < 0 || n_tables > kMaxTables)
    return nullptr;
  const Kernel k = instance(staging);
  smem = layout(tb, n_tables, ptrs, rows, cols, strides);
  if (k != nullptr && smem > 48 * 1024 &&
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem)) != cudaSuccess)
    return nullptr;
  return k;
}

}  // namespace
}  // namespace ptx

// Plain C entry points for ctypes. staging: 0 K1's loop, 1 the bulk
// copies. `n_tables` tables given as pointers, rows, columns staged and
// row strides (floats); n rays of x (16-byte aligned) in tiles of
// `threads` over `blocks` blocks; staged [blocks, staged floats] or null. `ptx_smem_tables_launch` launches on `stream`,
// does not synchronise and returns the launch's cudaError_t;
// `ptx_smem_tables_resident` writes the blocks of that launch that fit on
// one SM at once.
extern "C" int ptx_smem_tables_launch(int staging, const float* x, float* o, long long n,
                                      int blocks, int threads, int n_tables,
                                      const float* const* ptrs, const int* rows, const int* cols,
                                      const int* strides, float* staged, void* stream) {
  using namespace ptx;
  Tables tb;
  size_t smem = 0;
  const Kernel k = prepare(staging, threads, n_tables, ptrs, rows, cols, strides, tb, smem);
  if (k == nullptr || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  k<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(x, o, n, tb, staged);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ptx_smem_tables_resident(int staging, int threads, int n_tables,
                                        const float* const* ptrs, const int* rows,
                                        const int* cols, const int* strides, int* per_sm) {
  using namespace ptx;
  Tables tb;
  size_t smem = 0;
  const Kernel k = prepare(staging, threads, n_tables, ptrs, rows, cols, strides, tb, smem);
  if (k == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, k, threads, smem));
}
