// X4: the products of the pairwise record test in three formulations, as a
// microbenchmark on Hopper (sm_90a).
//
// Replaces: benchmarks/experiments/exp_dot_formulations.py `kernel` (:20-51,
//   the pallas_call of `run` at :56): one program computes
//   C[j] = B^T A_j for B [16, 512], A [8, 16, 128] -> C [8, 512, 128]; the
//   minimum over the middle axis of C[:, :128] -> R [8, 128]; and the
//   extraction X[j] = E onehot_j [16, 128] of E [16, 128] on the first
//   minimum of each column (:37-43) -> X [8, 16, 128]. All float32.
//   Wrapper and plain versions: cpupathtrace_tpu_torch/experiments/dot_formulations.py.
//
// Forms of C (FORM):
//   0 fma:    float32 multiply and add on the CUDA cores, k = 0..15 in order
//             (unfused: the build's --fmad=false keeps them apart, so the
//             plain version repeats the sums bit for bit);
//   1 tf32:   one TF32 product on the tensor cores (mma.sync m16n8k8, both
//             operands rounded to TF32: ~3 decimal digits);
//   2 3xtf32: a_lo b_hi + a_hi b_lo + a_hi b_hi (mma_tf32.cuh), about
//             float32 accuracy, as precision=HIGHEST asks on the TPU.
// The extraction is a gather of column `first` of E, which equals the
// one-hot product bit for bit (one term is 1 x E, the others 0 x E).
//
// What bounds it: bytes (0.11 MB in, 2.17 MB out; 16.8 MFLOP for C). The
// design: a grid of (4 tiles of 128 rows of C) x (8 matrices j); a block
// stages its [16, 128] slices of B and A_j in shared memory (16 KB) and
// writes its [128, 128] tile of C. fma: thread (r, h) computes column r of
// rows h * 64 .. h * 64 + 63 (coalesced stores, B read as broadcasts). TF32
// forms: warp w computes rows 16 w .. 16 w + 15 as 16 column tiles of 8
// with K = 16 in two k-steps. The row-tile-0 block of each j then reads its
// C tile back (its own stores, visible after the barrier) and reduces each
// column to (min, first argmin) in two halves of 64 rows, the first of
// equal values winning, and gathers X. At this size the launch and the
// blocks' latency, not the bytes, set the time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace ptx {
namespace {

constexpr int kK = 16;
constexpr int kQ = 512;
constexpr int kR = 128;
constexpr int kJ = 8;
constexpr int kQTile = 128;
constexpr int kThreads = 256;

template <int FORM>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const float* B, const float* A, const float* E, float* C, float* R, float* X) {
  const int qt = blockIdx.x, j = blockIdx.y;
  const int q0 = qt * kQTile;
  __shared__ float sB[kK][kQTile];
  __shared__ float sA[kK][kR];
  for (int i = threadIdx.x; i < kK * kQTile; i += kThreads) {
    const int k = i / kQTile, c = i % kQTile;
    sB[k][c] = B[k * kQ + q0 + c];
    sA[k][c] = A[(j * kK + k) * kR + c];
  }
  __syncthreads();
  float* Cj = C + static_cast<size_t>(j) * kQ * kR;
  if constexpr (FORM == 0) {
    const int r = threadIdx.x % kR, h = threadIdx.x / kR;
    float a[kK];
#pragma unroll
    for (int k = 0; k < kK; ++k) a[k] = sA[k][r];
    for (int i = 0; i < kQTile / 2; ++i) {
      const int q = h * (kQTile / 2) + i;
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < kK; ++k) acc = acc + sB[k][q] * a[k];
      Cj[static_cast<size_t>(q0 + q) * kR + r] = acc;
    }
  } else {
    // The MMA's A operand is B^T (rows q, depth k), its B operand A_j
    // (depth k, columns r).
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int m0 = warp * 16;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float v[4] = {sB[ks * 8 + t][m0 + g], sB[ks * 8 + t][m0 + g + 8],
                          sB[ks * 8 + t + 4][m0 + g], sB[ks * 8 + t + 4][m0 + g + 8]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (FORM == 1)
          ah[ks][e] = tf32(v[e]);
        else
          split(v[e], ah[ks][e], al[ks][e]);
      }
    }
    for (int nt = 0; nt < kR / 8; ++nt) {
      float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const float b0 = sA[ks * 8 + t][nt * 8 + g], b1 = sA[ks * 8 + t + 4][nt * 8 + g];
        if constexpr (FORM == 1) {
          mma(d, ah[ks], tf32(b0), tf32(b1));
        } else {
          uint32_t bh0, bl0, bh1, bl1;
          split(b0, bh0, bl0);
          split(b1, bh1, bl1);
          mma(d, al[ks], bh0, bh1);
          mma(d, ah[ks], bl0, bl1);
          mma(d, ah[ks], bh0, bh1);
        }
      }
      float* row = Cj + static_cast<size_t>(q0 + m0 + g) * kR + nt * 8 + 2 * t;
      row[0] = d[0];
      row[1] = d[1];
      row[8 * kR] = d[2];
      row[8 * kR + 1] = d[3];
    }
  }
  if (qt != 0) return;  // the whole block: R and X come from rows 0..127
  __syncthreads();
  __shared__ float s_min[2][kR];
  __shared__ int s_arg[2][kR];
  __shared__ int s_first[kR];
  {
    const int r = threadIdx.x % kR, h = threadIdx.x / kR;
    int arg = h * (kQTile / 2);
    float m = Cj[static_cast<size_t>(arg) * kR + r];
    for (int i = 1; i < kQTile / 2; ++i) {
      const int q = h * (kQTile / 2) + i;
      const float v = Cj[static_cast<size_t>(q) * kR + r];
      if (v < m) {
        m = v;
        arg = q;
      }
    }
    s_min[h][r] = m;
    s_arg[h][r] = arg;
  }
  __syncthreads();
  if (threadIdx.x < kR) {
    const int r = threadIdx.x;
    const bool second = s_min[1][r] < s_min[0][r];
    R[j * kR + r] = second ? s_min[1][r] : s_min[0][r];
    s_first[r] = second ? s_arg[1][r] : s_arg[0][r];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kK * kR; i += kThreads) {
    const int f = i / kR, r = i % kR;
    X[static_cast<size_t>(j) * kK * kR + i] = E[f * kR + s_first[r]];
  }
}

template <int FORM>
cudaError_t launch(const float* B, const float* A, const float* E, float* C, float* R, float* X,
                   cudaStream_t s) {
  dot_kernel<FORM><<<dim3(kQ / kQTile, kJ), kThreads, 0, s>>>(B, A, E, C, R, X);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. form: 0 fma, 1 tf32, 2 3xtf32. B [16, 512],
// A [8, 16, 128], E [16, 128] in; C [8, 512, 128], R [8, 128],
// X [8, 16, 128] out. Launches on `stream`, does not synchronise, returns
// the launch's cudaError_t.
extern "C" int ptx_dot_formulations_launch(int form, const float* B, const float* A,
                                           const float* E, float* C, float* R, float* X,
                                           void* stream) {
  using namespace ptx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: return static_cast<int>(launch<0>(B, A, E, C, R, X, s));
    case 1: return static_cast<int>(launch<1>(B, A, E, C, R, X, s));
    case 2: return static_cast<int>(launch<2>(B, A, E, C, R, X, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
