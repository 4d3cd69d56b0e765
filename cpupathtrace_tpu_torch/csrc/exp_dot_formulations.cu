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
//   1 tf32:   one TF32 product on the tensor cores (both operands rounded
//             to TF32: ~3 decimal digits);
//   2 3xtf32: a_lo b_hi + a_hi b_lo + a_hi b_hi (mma_tf32.cuh), about
//             float32 accuracy, as precision=HIGHEST asks on the TPU.
// The TF32 forms run on mma.sync m16n8k8, each warp 16 rows, its fragments
// read from shared memory as B and A_j lie. A wgmma form (m64n32k8 per
// warpgroup, both operands staged K-major, so transposed) measured no
// faster at this depth of two k-steps of 8 (PERF.md §6, X4) and is not
// kept. The extraction is a gather of column `first` of E, which equals the
// one-hot product bit for bit (one term is 1 x E, the others 0 x E).
//
// What bounds it: bytes (0.11 MB in, 2.17 MB out; 16.8 MFLOP for C). The
// design: a grid of 4 tiles of 128 rows x 4 slices of 32 columns x 8
// matrices j (128 blocks, about one per SM), so rows 0..127 of every
// column lie in the row-tile-0 block of its (slice, j). Every form leaves
// each thread the same part of its block's [128, 32] tile of C in
// registers: rows 16w + g and 16w + g + 8 of warp w, columns 8i + 2t and
// 8i + 2t + 1 (g = lane / 4, t = lane % 4). The tile goes through shared
// memory to 16-byte stores, a warp writing four whole 128-byte row
// segments at a time. The row-tile-0 blocks take R and `first` from the
// registers: each thread its two rows, then warp shuffles over g, then the
// eight warps through shared memory, the first row of equal values winning
// (-0.0 equals +0.0); C is never read back. They then gather X.
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
constexpr int kCols = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// The staged C tile's row: 16-byte aligned, rows 4 banks apart.
constexpr int kCStride = kCols + 4;

// (value, row) pairs: the smaller value, and of equal values the first row.
__device__ __forceinline__ void take_first_min(float& m, int& a, float om, int oa) {
  if (om < m || (om == m && oa < a)) {
    m = om;
    a = oa;
  }
}

template <int FORM>
__global__ void __launch_bounds__(kThreads)
    dot_kernel(const float* B, const float* A, const float* E, float* C, float* R, float* X) {
  const int qt = blockIdx.x, c0 = blockIdx.y * kCols, j = blockIdx.z;
  const int q0 = qt * kQTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int m0 = warp * 16;
  float acc[16];  // acc[4i + e]: row m0 + g + 8 (e / 2), column 8i + 2t + e % 2
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.0f;
  // The row-tile-0 blocks load E now, beside B and A, so that the gather
  // at the end waits for no load; it goes to shared memory (sE, over sB,
  // dead by then) once the products are done.
  constexpr int kEPer = kK * kR / kThreads;
  float ev[kEPer];
  if (qt == 0)
#pragma unroll
    for (int u = 0; u < kEPer; ++u) ev[u] = E[u * kThreads + threadIdx.x];

  __shared__ __align__(16) float sB[kK][kQTile];
  __shared__ __align__(16) float sA[kK][kCols];
  float* const sE = &sB[0][0];
  for (int i = threadIdx.x; i < kK * kQTile / 4; i += kThreads) {
    const int k = i / (kQTile / 4), c4 = i % (kQTile / 4);
    *reinterpret_cast<float4*>(&sB[k][4 * c4]) =
        *reinterpret_cast<const float4*>(B + k * kQ + q0 + 4 * c4);
  }
  for (int i = threadIdx.x; i < kK * kCols / 4; i += kThreads) {
    const int k = i / (kCols / 4), c4 = i % (kCols / 4);
    *reinterpret_cast<float4*>(&sA[k][4 * c4]) =
        *reinterpret_cast<const float4*>(A + (j * kK + k) * kR + c0 + 4 * c4);
  }
  __syncthreads();
  if constexpr (FORM == 0) {
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      const float b0 = sB[k][m0 + g], b1 = sB[k][m0 + g + 8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a0 = sA[k][8 * i + 2 * t], a1 = sA[k][8 * i + 2 * t + 1];
        acc[4 * i] = acc[4 * i] + b0 * a0;
        acc[4 * i + 1] = acc[4 * i + 1] + b0 * a1;
        acc[4 * i + 2] = acc[4 * i + 2] + b1 * a0;
        acc[4 * i + 3] = acc[4 * i + 3] + b1 * a1;
      }
    }
  } else {
    // The MMA's A operand is B^T (rows q, depth k), its B operand A_j
    // (depth k, columns r).
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
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
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
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[4 * nt + e] = d[e];
    }
  }

  // The tile of C through shared memory to coalesced 16-byte stores.
  __shared__ __align__(16) float sC[kQTile][kCStride];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    *reinterpret_cast<float2*>(&sC[m0 + g][8 * i + 2 * t]) =
        make_float2(acc[4 * i], acc[4 * i + 1]);
    *reinterpret_cast<float2*>(&sC[m0 + g + 8][8 * i + 2 * t]) =
        make_float2(acc[4 * i + 2], acc[4 * i + 3]);
  }
  __syncthreads();
  float* Cj = C + static_cast<size_t>(j) * kQ * kR;
#pragma unroll
  for (int it = 0; it < kQTile * kCols / 4 / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x, row = idx / (kCols / 4), c4 = idx % (kCols / 4);
    *reinterpret_cast<float4*>(Cj + static_cast<size_t>(q0 + row) * kR + c0 + 4 * c4) =
        *reinterpret_cast<const float4*>(&sC[row][4 * c4]);
  }
  if (qt != 0) return;  // the whole block: R and X come from rows 0..127

  // (min, first row) per column: the thread's two rows, the warp, the block.
  __shared__ float s_min[kWarps][kCols];
  __shared__ int s_arg[kWarps][kCols];
  __shared__ int s_first[kCols];
#pragma unroll
  for (int u = 0; u < kEPer; ++u) sE[u * kThreads + threadIdx.x] = ev[u];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = acc[4 * i + h];
      int a = m0 + g;
      take_first_min(m, a, acc[4 * i + 2 + h], m0 + g + 8);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        take_first_min(m, a, __shfl_xor_sync(0xffffffffu, m, off),
                       __shfl_xor_sync(0xffffffffu, a, off));
      if (g == 0) {
        s_min[warp][8 * i + 2 * t + h] = m;
        s_arg[warp][8 * i + 2 * t + h] = a;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < kCols) {
    const int col = threadIdx.x;
    float m = s_min[0][col];
    int a = s_arg[0][col];
    for (int w = 1; w < kWarps; ++w) take_first_min(m, a, s_min[w][col], s_arg[w][col]);
    R[j * kR + c0 + col] = m;
    s_first[col] = a;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kK * kCols; i += kThreads) {
    const int f = i / kCols, col = i % kCols;
    X[(static_cast<size_t>(j) * kK + f) * kR + c0 + col] = sE[f * kR + s_first[col]];
  }
}

template <int FORM>
cudaError_t launch(const float* B, const float* A, const float* E, float* C, float* R, float* X,
                   cudaStream_t s) {
  dot_kernel<FORM><<<dim3(kQ / kQTile, kR / kCols, kJ), kThreads, 0, s>>>(B, A, E, C, R, X);
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
