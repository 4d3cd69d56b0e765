// X5: the per-block cost of staging constant tables, as a microbenchmark on
// Hopper (sm_90a).
//
// Replaces: benchmarks/experiments/microbench_smemtables.py `make_kernel` /
//   `run` (:17-45): an almost empty kernel over blocks of rays, each block
//   with 0 or 6 small constant tables and optionally a 128 x 128 table as
//   inputs; it writes x + 1e-9 * (the sum of each table's [0, 0]). On the
//   TPU the tables were SMEM / VMEM inputs of every grid step; here each
//   block stages its tables into shared memory with K1's own loop
//   (stage_rows of bounce_body.cuh, megakernel.cu:82-88), which is the cost
//   K1 pays per block. With `staged` non-null, each block also writes
//   what it staged to its row of `staged` (the check's view of every
//   staged element; null when timed). Wrapper and plain version:
//   cpupathtrace_tpu_torch/experiments/smem_tables.py.
//
// What bounds it: bytes. Each ray is read and written once (8 bytes) and
// every block reads its tables again (from L2 after the first). The
// design is K1's: all threads of the block copy the rows in a strided
// loop, then one __syncthreads.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_body.cuh"

namespace ptx {
namespace {

constexpr int kMaxTables = 8;

struct Table {
  const float* p;
  int rows, cols, stride;
};

struct Tables {
  Table t[kMaxTables];
  int n;
};

__global__ void smem_tables_kernel(const float* x, float* o, int64_t n, Tables tb,
                                   float* staged, int floats) {
  extern __shared__ float smem[];
  float* dst[kMaxTables];
  float* s = smem;
  for (int k = 0; k < tb.n; ++k) {
    dst[k] = s;
    stage_rows(s, tb.t[k].p, tb.t[k].rows, tb.t[k].cols, tb.t[k].stride);
    s += tb.t[k].rows * tb.t[k].cols;
  }
  __syncthreads();
  if (staged != nullptr)
    for (int k = threadIdx.x; k < floats; k += blockDim.x)
      staged[static_cast<size_t>(blockIdx.x) * floats + k] = smem[k];
  float acc = 0.0f;
  for (int k = 0; k < tb.n; ++k) acc = k ? acc + dst[k][0] : dst[k][0];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) o[i] = x[i] + (tb.n ? acc * 1e-9f : 0.0f);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes: `n_tables` tables given as pointers,
// rows, columns and row strides (floats); `blocks` blocks of `threads`
// threads over n = blocks * threads rays; staged [blocks, staged floats]
// or null. Launches on `stream`, does not synchronise, returns the
// launch's cudaError_t.
extern "C" int ptx_smem_tables_launch(const float* x, float* o, int blocks, int threads,
                                      int n_tables, const float* const* ptrs, const int* rows,
                                      const int* cols, const int* strides, float* staged,
                                      void* stream) {
  using namespace ptx;
  if (n_tables < 0 || n_tables > kMaxTables) return static_cast<int>(cudaErrorInvalidValue);
  Tables tb{};
  tb.n = n_tables;
  size_t floats = 0;
  for (int k = 0; k < n_tables; ++k) {
    tb.t[k] = Table{ptrs[k], rows[k], cols[k], strides[k]};
    floats += static_cast<size_t>(rows[k]) * cols[k];
  }
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        smem_tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t n = static_cast<int64_t>(blocks) * threads;
  smem_tables_kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, o, n, tb, staged, static_cast<int>(floats));
  return static_cast<int>(cudaGetLastError());
}
