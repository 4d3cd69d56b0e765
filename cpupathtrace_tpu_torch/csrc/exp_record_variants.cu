// X3: the record test in three formulations, as a microbenchmark on Hopper
// (sm_90a): 1024 rays against K record tests of T = 128 triangles, cycling
// over NREC = 32 records; each variant writes bt [8, 128], the running
// nearest t from 100.
//
// Replaces: benchmarks/experiments/exp_record_variants.py (`run_variant`
//   :218, the pallas_call at :229) with its kernels
//   * `kernel_serial` (:183-215): Moller-Trumbore per ray over a 4-record
//     table in fast memory, triangle after triangle;
//   * `kernel_outer` (:142-180): the pairwise Plucker test, features
//     [T, 16] per record, every (triangle, ray) pair;
//   * `kernel_matmul` (:87-139): the Plucker quantities of a record as one
//     product [16, 5T]^T x [16, 128] per row of 128 rays on the matrix unit
//     (precision HIGHEST), then the test epilogue; with `extract`, the
//     one-hot extraction of the winner's barycentrics on row 0.
// Wrapper and plain versions: cpupathtrace_tpu_torch/experiments/record_variants.py.
//
// What bounds them: operations (the tables, 48 KB to 1.3 MB, stay in
// shared memory or L1/L2). The design keeps the TPU's decomposition on
// eight blocks, one per row of 128 rays, one thread per ray for serial and
// outer. matmul runs the product on the tensor cores with mma.sync
// m16n8k8 TF32 in the 3xTF32 split (a = a_hi + a_lo; a_hi b_hi + a_hi b_lo
// + a_lo b_hi), which keeps float32 accuracy as precision=HIGHEST asks:
// each of 4 warps owns 4 column tiles of 8 rays for all 8 triangle tiles,
// so a ray's minimum over the record stays inside one warp (a shuffle over
// the 8 lanes that hold its column). The epilogue reads det, u, v and t of
// the same (triangle, ray) from four accumulator tiles with the same
// fragment layout. extract recomputes row 0's products in a second pass to
// sum the one-hot weighted quantities.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace ptx {
namespace {

constexpr int kT = 128;
constexpr int kNRec = 32;
constexpr int kRays = 1024;
constexpr int kRowRays = 128;
constexpr int kSerRecs = 4;
constexpr int kSerRows = 24;
constexpr int kOpCols = 16;
constexpr int kPfRows = 16;
constexpr int kPfCols = 5 * kT;
constexpr float kEps = 1e-6f;

// ---- serial: Moller-Trumbore per ray over the 4-record table ----
__global__ void __launch_bounds__(kRowRays)
    serial_kernel(const float* ser, const float* rays, float* bt_out, int k_iters) {
  __shared__ float s[kSerRecs * kSerRows * kT];
  for (int i = threadIdx.x; i < kSerRecs * kSerRows * kT; i += blockDim.x) s[i] = ser[i];
  __syncthreads();
  const int i = blockIdx.x * kRowRays + threadIdx.x;
  const float ox = rays[i], oy = rays[kRays + i], oz = rays[2 * kRays + i];
  const float dx = rays[3 * kRays + i], dy = rays[4 * kRays + i], dz = rays[5 * kRays + i];
  float bt = 100.0f;
  for (int k = 0; k < k_iters; ++k) {
    const float* r = s + (k % kSerRecs) * kSerRows * kT;
    for (int t = 0; t < kT; ++t) {
      const float v0x = r[t], v0y = r[kT + t], v0z = r[2 * kT + t];
      const float e1x = r[3 * kT + t], e1y = r[4 * kT + t], e1z = r[5 * kT + t];
      const float e2x = r[6 * kT + t], e2y = r[7 * kT + t], e2z = r[8 * kT + t];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool miss = fabsf(det) <= kEps;
      const float inv = 1.0f / (miss ? 1.0f : det);
      const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv;
      const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv;
      const bool ok = !miss && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
                      tt >= 0.0f && tt < bt;
      bt = ok ? tt : bt;
    }
  }
  bt_out[i] = bt;
}

// ---- outer: the Plucker test of every (triangle, ray) pair ----
__global__ void __launch_bounds__(kRowRays)
    outer_kernel(const float* op, const float* rays, float* bt_out, int k_iters) {
  const int i = blockIdx.x * kRowRays + threadIdx.x;
  const float ox = rays[i], oy = rays[kRays + i], oz = rays[2 * kRays + i];
  const float dx = rays[3 * kRays + i], dy = rays[4 * kRays + i], dz = rays[5 * kRays + i];
  const float mx = oy * dz - oz * dy;
  const float my = oz * dx - ox * dz;
  const float mz = ox * dy - oy * dx;
  float bt = 100.0f;
  for (int k = 0; k < k_iters; ++k) {
    const float* tb = op + static_cast<size_t>(k % kNRec) * kT * kOpCols;
    float tmin = INFINITY;
    for (int t = 0; t < kT; ++t) {
      float c[kOpCols];
      const float4* q = reinterpret_cast<const float4*>(tb + t * kOpCols);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w = __ldg(q + j);
        c[4 * j] = w.x;
        c[4 * j + 1] = w.y;
        c[4 * j + 2] = w.z;
        c[4 * j + 3] = w.w;
      }
      const float det = c[0] * dx + c[1] * dy + c[2] * dz;
      const float un = c[3] * mx + c[4] * my + c[5] * mz + c[6] * dx + c[7] * dy + c[8] * dz;
      const float vn =
          c[9] * mx + c[10] * my + c[11] * mz + c[12] * dx + c[13] * dy + c[14] * dz;
      const float tn = -c[0] * ox - c[1] * oy - c[2] * oz - c[15];
      const float sgn = det >= 0.0f ? 1.0f : -1.0f;
      const float sd = det * sgn, su = un * sgn, sv = vn * sgn, st = tn * sgn;
      const float inside = fminf(fminf(su, sv), sd - su - sv);
      const bool ok = inside >= 0.0f && st >= 0.0f && sd > kEps;
      const float tv = st / (ok ? sd : 1.0f);
      tmin = fminf(tmin, ok && tv < bt ? tv : INFINITY);
    }
    bt = fminf(bt, tmin);
  }
  bt_out[i] = bt;
}

// ---- matmul: the record as a product on the tensor cores (mma_tf32.cuh) ----
// Row `f` of a ray's features (exp_record_variants.py _ray_feats): d(0:3)
// m(3:6) o(6:9) one(9), zero after.
__device__ __forceinline__ float ray_feat(int f, const float* rays, int i) {
  const float ox = rays[i], oy = rays[kRays + i], oz = rays[2 * kRays + i];
  const float dx = rays[3 * kRays + i], dy = rays[4 * kRays + i], dz = rays[5 * kRays + i];
  switch (f) {
    case 0: return dx;
    case 1: return dy;
    case 2: return dz;
    case 3: return oy * dz - oz * dy;
    case 4: return oz * dx - ox * dz;
    case 5: return ox * dy - oy * dx;
    case 6: return ox;
    case 7: return oy;
    case 8: return oz;
    case 9: return 1.0f;
    default: return 0.0f;
  }
}

constexpr int kWarps = 4;
constexpr int kTilesN = kRowRays / 8 / kWarps;  // column tiles of 8 rays per warp
constexpr int kTilesT = kT / 16;               // triangle tiles of 16

// The 5 accumulator tiles (det, u, v, t, cull) of triangle tile `tt` and
// column tile `nt` for record table `pf`, from the B fragments `bh`, `bl`.
__device__ __forceinline__ void record_tile(const float* pf, int tt, const uint32_t (&bh)[2][2],
                                            const uint32_t (&bl)[2][2], float (&acc)[5][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mb = 0; mb < 5; ++mb) {
    acc[mb][0] = acc[mb][1] = acc[mb][2] = acc[mb][3] = 0.0f;
    const int base = mb * kT + tt * 16;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const float* p0 = pf + (ks * 8 + tig) * kPfCols + base;
      const float* p1 = pf + (ks * 8 + tig + 4) * kPfCols + base;
      uint32_t ah[4], al[4];
      split(__ldg(p0 + g), ah[0], al[0]);
      split(__ldg(p0 + g + 8), ah[1], al[1]);
      split(__ldg(p1 + g), ah[2], al[2]);
      split(__ldg(p1 + g + 8), ah[3], al[3]);
      mma(acc[mb], al, bh[ks][0], bh[ks][1]);
      mma(acc[mb], ah, bl[ks][0], bl[ks][1]);
      mma(acc[mb], ah, bh[ks][0], bh[ks][1]);
    }
  }
}

// The test epilogue of one (triangle, ray) element (exp_record_variants.py
// :107-118): the key (t where the test passes below bt, else inf) and the
// sign-normalised su, sv, sd.
__device__ __forceinline__ float test_key(float det, float un, float vn, float tn, float bt,
                                          float& su, float& sv, float& sd) {
  const float sgn = det >= 0.0f ? 1.0f : -1.0f;
  sd = det * sgn;
  su = un * sgn;
  sv = vn * sgn;
  const float st = tn * sgn;
  const float inside = fminf(fminf(su, sv), sd - su - sv);
  const bool ok = inside >= 0.0f && st >= 0.0f && sd > kEps;
  const float tv = st / (ok ? sd : 1.0f);
  return ok && tv < bt ? tv : INFINITY;
}

__device__ __forceinline__ float warp_min8(float v) {
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 4));
  v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 8));
  return fminf(v, __shfl_xor_sync(0xffffffffu, v, 16));
}

__device__ __forceinline__ float warp_sum8(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

template <bool kExtract>
__global__ void __launch_bounds__(kWarps * 32)
    matmul_kernel(const float* pf_all, const float* rays, float* bt_out, int k_iters) {
  const int row = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  // B fragments of this warp's column tiles: B[kk][n] = feature kk of ray n.
  uint32_t bh[kTilesN][2][2], bl[kTilesN][2][2];
  float bt[kTilesN][2];
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) {
    const int ray = row * kRowRays + (warp * kTilesN + j) * 8 + g;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      split(ray_feat(ks * 8 + tig, rays, ray), bh[j][ks][0], bl[j][ks][0]);
      split(ray_feat(ks * 8 + tig + 4, rays, ray), bh[j][ks][1], bl[j][ks][1]);
    }
    bt[j][0] = bt[j][1] = 100.0f;
  }
  for (int k = 0; k < k_iters; ++k) {
    const float* pf = pf_all + static_cast<size_t>(k % kNRec) * kPfRows * kPfCols;
#pragma unroll
    for (int j = 0; j < kTilesN; ++j) {
      float kmin[2] = {INFINITY, INFINITY};
      for (int tt = 0; tt < kTilesT; ++tt) {
        float acc[5][4];
        record_tile(pf, tt, bh[j], bl[j], acc);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float su, sv, sd;
          const float key =
              test_key(acc[0][e], acc[1][e], acc[2][e], acc[3][e], bt[j][e & 1], su, sv, sd);
          kmin[e & 1] = fminf(kmin[e & 1], key);
        }
      }
      const float tmin[2] = {warp_min8(kmin[0]), warp_min8(kmin[1])};
      float corr[2] = {0.0f, 0.0f};
      if (kExtract && row == 0) {
        // One-hot over the record's triangles where key == tmin (every
        // triangle when no test passed: inf == inf), as the script.
        float ssu[2] = {0.0f, 0.0f}, ssv[2] = {0.0f, 0.0f}, ssd[2] = {0.0f, 0.0f};
        for (int tt = 0; tt < kTilesT; ++tt) {
          float acc[5][4];
          record_tile(pf, tt, bh[j], bl[j], acc);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float su, sv, sd;
            const float key =
                test_key(acc[0][e], acc[1][e], acc[2][e], acc[3][e], bt[j][e & 1], su, sv, sd);
            if (key == tmin[e & 1]) {
              ssu[e & 1] += su;
              ssv[e & 1] += sv;
              ssd[e & 1] += sd;
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float sdw = warp_sum8(ssd[c]);
          const float uw = warp_sum8(ssu[c]) / fmaxf(sdw, 1e-30f);
          const float vw = warp_sum8(ssv[c]) / fmaxf(sdw, 1e-30f);
          corr[c] = 1e-12f * (uw + vw);
        }
      }
      bt[j][0] = fminf(bt[j][0], tmin[0]) + corr[0];
      bt[j][1] = fminf(bt[j][1], tmin[1]) + corr[1];
    }
  }
  if (g == 0) {
#pragma unroll
    for (int j = 0; j < kTilesN; ++j) {
      const int col = row * kRowRays + (warp * kTilesN + j) * 8 + 2 * tig;
      bt_out[col] = bt[j][0];
      bt_out[col + 1] = bt[j][1];
    }
  }
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. variant: 0 serial (table [4, 24, T]),
// 1 outer ([NREC, T, 16]), 2 matmul ([NREC, 16, 5T]), 3 matmul + extract.
// rays [6, 1024] (o, d components), bt [1024]. Launches on `stream`, does
// not synchronise, returns the launch's cudaError_t.
extern "C" int ptx_record_variant_launch(int variant, const float* table, const float* rays,
                                         float* bt, int k_iters, void* stream) {
  using namespace ptx;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = kRays / kRowRays;
  switch (variant) {
    case 0: serial_kernel<<<blocks, kRowRays, 0, s>>>(table, rays, bt, k_iters); break;
    case 1: outer_kernel<<<blocks, kRowRays, 0, s>>>(table, rays, bt, k_iters); break;
    case 2: matmul_kernel<false><<<blocks, kWarps * 32, 0, s>>>(table, rays, bt, k_iters); break;
    case 3: matmul_kernel<true><<<blocks, kWarps * 32, 0, s>>>(table, rays, bt, k_iters); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
