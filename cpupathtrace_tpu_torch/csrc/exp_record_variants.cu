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
// Wrapper, plain versions and the plain model of this kernel's split:
// cpupathtrace_tpu_torch/experiments/record_variants.py.
//
// What bounds them: operations (the tables, 48 KB to 1.3 MB, stay in L2;
// each block stages the records it tests in shared memory). The TPU ran
// the record tests one after another on one core; the card has 132 SMs.
//
// The design: the record tests are split over the card. bt after K tests
// is min(100, every passing t), whatever the order, so block (row, chunk)
// tests one row of 128 rays against the contiguous range of record tests
// [K c / C, K (c + 1) / C) of chunk c (record k % NREC, or k % 4 for
// serial: the cycle runs across the chunks), from 100, and writes its
// partial minimum (+inf for an empty range) to partial [C, 1024];
// `combine_kernel` folds the partials of each ray from 100 in chunk order,
// keeping the first of equal values as the sequential loop's `t < bt`
// filter does, so the result has the sequential kernel's bits, signed
// zeros included.
// The wrapper picks C from the occupancy (one wave of resident blocks).
//   * serial, outer: a thread a ray. serial stages rows 0-8 (v0, e1, e2) of
//     its 4 records once (18 KB, bulk copies); outer double-buffers its
//     records (8 KB each, bulk copies on two mbarriers), one barrier a
//     record.
//   * matmul: 8 warps a row, 2 column tiles of 8 rays a warp. Each record
//     is bulk-copied once per block (the 4 quantity blocks det, u, v, t:
//     the fifth, cull, is never read) and split once per block into TF32
//     hi / lo fragments in shared memory in mma.sync m16n8k8 operand order,
//     read by each warp with two 16-byte loads per 16 x 8 tile and used for
//     both of its column tiles; the next record's copy lands while the
//     block computes. The product is 3xTF32 (a_lo b_hi + a_hi b_lo +
//     a_hi b_hi, mma_tf32.cuh), which keeps float32 accuracy as
//     precision=HIGHEST asks.
//   * matmul_extract: row 0's bt after record test k carries the
//     correction of test k - 1 through the `tv < bt` filter and the
//     one-hot, so its corrections run in order. But the filter acts only
//     through the record's least t: every t of a record is >= its least, m0,
//     so some t passes iff m0 < bt, and then the one-hot takes the
//     triangles whose t is m0; if none passes, it takes every triangle. So
//     each record test of a row-0 ray reduces, without bt, to m0 and the
//     two corrections the script may add: 1e-12 (uw + vw) from the sums of
//     su, sv, sd over the triangles at m0, and from those over all. Row 0's
//     blocks run matmul's products and test (with no running bt) split
//     over k like every row, and write that summary a test and ray;
//     `extract_scan_kernel` then runs the recurrence over the summaries in
//     test order, a thread a ray: a compare, two selects, a min and an add
//     a test. Rows 1-7 are matmul's.
// With `counts` non-null (the counting instance, never timed), each warp
// adds the ray-record tests it ran to counts[k % NREC] ([k % 4] for
// serial), and each scan thread its k_iters extraction passes to
// counts[NREC]; the timed instance is the same template without them.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "mma_tf32.cuh"

namespace ptx {
namespace {

constexpr int kT = 128;
constexpr int kNRec = 32;
constexpr int kRays = 1024;
constexpr int kRowRays = 128;
constexpr int kRows = kRays / kRowRays;
constexpr int kSerRecs = 4;
constexpr int kSerRows = 24;
constexpr int kSerUsed = 9;  // v0, e1, e2: the rows the test reads
constexpr int kOpCols = 16;
constexpr int kPfRows = 16;
constexpr int kPfCols = 5 * kT;
constexpr int kQuant = 4;  // det, u, v, t: the quantity blocks the test reads
constexpr float kEps = 1e-6f;
constexpr float kStart = 100.0f;
constexpr int kRowThreads = kRowRays;  // serial, outer: a thread a ray
constexpr int kMmaWarps = 8;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kTilesT = kT / 16;                   // triangle tiles of 16
constexpr int kTilesN = kRowRays / 8 / kMmaWarps;  // column tiles of 8 rays a warp
// matmul_extract's summary of a row-0 ray's record test: the least t
// (inf where none passes), the correction from the triangles at it, and
// the one from every triangle.
constexpr int kSumQ = 3;
constexpr int kScanAhead = 32;  // extract_scan_kernel: record tests a load
constexpr int kFrags = kQuant * kTilesT * 2;       // A tiles of a record: (quantity, tile, k-step)
// A staged pf row: 512 floats + 8, so the split's reads (rows t, columns g)
// fall on 32 distinct banks.
constexpr int kRawStride = kQuant * kT + 8;
constexpr size_t kRawBytes = static_cast<size_t>(kPfRows) * kRawStride * sizeof(float);
constexpr size_t kMmaSmem = kRawBytes + 2 * static_cast<size_t>(kFrags) * 32 * sizeof(uint4);
constexpr int kCombineRays = 32;  // combine_kernel: rays a block ...
constexpr int kCombineParts = 32;  // ... and contiguous runs of chunks a ray

// The first record test of chunk c of `chunks` over k_iters tests.
__device__ __forceinline__ int chunk_begin(int c, int chunks, int k_iters) {
  return static_cast<int>(static_cast<long long>(k_iters) * c / chunks);
}

__device__ __forceinline__ void add_count(unsigned long long* counts, int slot,
                                          unsigned long long n) {
  atomicAdd(counts + slot, n);
}

// ---- serial: Moller-Trumbore per ray over the 4-record table ----
template <bool kCount>
__global__ void __launch_bounds__(kRowThreads)
    serial_kernel(const float* ser, const float* rays, float* partial, int k_iters, int chunks,
                  unsigned long long* counts) {
  __shared__ __align__(16) float s[kSerRecs * kSerUsed * kT];
  __shared__ __align__(8) uint64_t bar;
  const int row = blockIdx.x % kRows, chunk = blockIdx.x / kRows;
  const int k0 = chunk_begin(chunk, chunks, k_iters);
  const int k1 = chunk_begin(chunk + 1, chunks, k_iters);
  const int i = row * kRowRays + threadIdx.x;
  float bt = INFINITY;
  if (k0 < k1) {
    constexpr uint32_t kBytes = kSerUsed * kT * sizeof(float);
    if (threadIdx.x == 0) mbar_init(&bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&bar, kSerRecs * kBytes);
      for (int r = 0; r < kSerRecs; ++r)
        bulk_g2s(s + r * kSerUsed * kT, ser + r * kSerRows * kT, kBytes, &bar);
    }
    const float ox = rays[i], oy = rays[kRays + i], oz = rays[2 * kRays + i];
    const float dx = rays[3 * kRays + i], dy = rays[4 * kRays + i], dz = rays[5 * kRays + i];
    mbar_wait(&bar, 0);
    bt = kStart;
    for (int k = k0; k < k1; ++k) {
      const float* r = s + (k % kSerRecs) * kSerUsed * kT;
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
      if (kCount && (threadIdx.x & 31) == 0) add_count(counts, k % kSerRecs, 32);
    }
  }
  partial[static_cast<size_t>(chunk) * kRays + i] = bt;
}

// ---- outer: the Plucker test of every (triangle, ray) pair ----
template <bool kCount>
__global__ void __launch_bounds__(kRowThreads)
    outer_kernel(const float* op, const float* rays, float* partial, int k_iters, int chunks,
                 unsigned long long* counts) {
  constexpr int kRec = kT * kOpCols;
  constexpr uint32_t kBytes = kRec * sizeof(float);
  __shared__ __align__(16) float s[2][kRec];
  __shared__ __align__(8) uint64_t bar[2];
  const int row = blockIdx.x % kRows, chunk = blockIdx.x / kRows;
  const int k0 = chunk_begin(chunk, chunks, k_iters);
  const int k1 = chunk_begin(chunk + 1, chunks, k_iters);
  const int i = row * kRowRays + threadIdx.x;
  float bt = INFINITY;
  if (k0 < k1) {
    if (threadIdx.x == 0) {
      mbar_init(&bar[0], 1);
      mbar_init(&bar[1], 1);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < 2 && k0 + j < k1; ++j) {
        mbar_arrive_expect_tx(&bar[j], kBytes);
        bulk_g2s(s[j], op + static_cast<size_t>((k0 + j) % kNRec) * kRec, kBytes, &bar[j]);
      }
    }
    const float ox = rays[i], oy = rays[kRays + i], oz = rays[2 * kRays + i];
    const float dx = rays[3 * kRays + i], dy = rays[4 * kRays + i], dz = rays[5 * kRays + i];
    const float mx = oy * dz - oz * dy;
    const float my = oz * dx - ox * dz;
    const float mz = ox * dy - oy * dx;
    bt = kStart;
    for (int k = k0; k < k1; ++k) {
      const int n = k - k0, buf = n & 1;
      mbar_wait(&bar[buf], (n >> 1) & 1);
      const float4* tb = reinterpret_cast<const float4*>(s[buf]);
      float tmin = INFINITY;
      for (int t = 0; t < kT; ++t) {
        float c[kOpCols];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 w = tb[t * 4 + j];  // the same address in every lane: a broadcast
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
      if (kCount && (threadIdx.x & 31) == 0) add_count(counts, k % kNRec, 32);
      // Every thread is done with this buffer before its next record lands.
      __syncthreads();
      if (threadIdx.x == 0 && k + 2 < k1) {
        mbar_arrive_expect_tx(&bar[buf], kBytes);
        bulk_g2s(s[buf], op + static_cast<size_t>((k + 2) % kNRec) * kRec, kBytes, &bar[buf]);
      }
    }
  }
  partial[static_cast<size_t>(chunk) * kRays + i] = bt;
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

// B fragments of the column tile of 8 rays from `ray0`: B[kk][n] = feature
// kk of ray ray0 + n, split to TF32 hi / lo.
__device__ __forceinline__ void ray_fragments(const float* rays, int ray0, uint32_t (&bh)[2][2],
                                              uint32_t (&bl)[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    split(ray_feat(ks * 8 + tig, rays, ray0 + g), bh[ks][0], bl[ks][0]);
    split(ray_feat(ks * 8 + tig + 4, rays, ray0 + g), bh[ks][1], bl[ks][1]);
  }
}

// The four A values of lane (g, tig) in tile (mb, tt, ks) of record `pf`
// (a row-major [16, row_stride] table): A[m][kk] = pf[ks 8 + kk][mb T + tt 16 + m].
__device__ __forceinline__ void a_values(const float* pf, int row_stride, int mb, int tt, int ks,
                                         int g, int tig, float (&a)[4]) {
  const float* p0 = pf + (ks * 8 + tig) * row_stride + mb * kT + tt * 16;
  const float* p1 = p0 + 4 * row_stride;
  a[0] = p0[g];
  a[1] = p0[g + 8];
  a[2] = p1[g];
  a[3] = p1[g + 8];
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

// Bulk-copy the 4 quantity blocks of record `rec` (16 rows of 512 floats)
// into `raw` (row stride kRawStride), completing on `bar`.
__device__ __forceinline__ void issue_record(float* raw, const float* pf_all, int rec,
                                             uint64_t* bar) {
  constexpr uint32_t kRowBytes = kQuant * kT * sizeof(float);
  const float* pf = pf_all + static_cast<size_t>(rec) * kPfRows * kPfCols;
  mbar_arrive_expect_tx(bar, kPfRows * kRowBytes);
  for (int f = 0; f < kPfRows; ++f) bulk_g2s(raw + f * kRawStride, pf + f * kPfCols, kRowBytes, bar);
}

// Split the staged record into hi / lo A fragments: fragment (mb tt 2 + ks)
// holds each lane's four values, one uint4 a lane.
__device__ __forceinline__ void split_record(const float* raw, uint4* hi, uint4* lo) {
  for (int idx = threadIdx.x; idx < kFrags * 32; idx += blockDim.x) {
    const int frag = idx >> 5, lane = idx & 31;
    const int ks = frag & 1, mt = frag >> 1;
    float a[4];
    a_values(raw, kRawStride, mt / kTilesT, mt % kTilesT, ks, lane >> 2, lane & 3, a);
    uint32_t h[4], l[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) split(a[q], h[q], l[q]);
    hi[idx] = make_uint4(h[0], h[1], h[2], h[3]);
    lo[idx] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Merge two (least t, sums at it) of the same ray: the least, and the sums
// of the sides that hold it.
__device__ __forceinline__ void merge_least(float& m, float (&a)[3], float mo,
                                            const float (&ao)[3]) {
  const float mn = fminf(m, mo);
#pragma unroll
  for (int q = 0; q < 3; ++q) a[q] = (m == mn ? a[q] : 0.0f) + (mo == mn ? ao[q] : 0.0f);
  m = mn;
}

// The script's correction from one-hot sums of su, sv, sd.
__device__ __forceinline__ float correction(float suw, float svw, float sdw) {
  const float uw = suw / fmaxf(sdw, 1e-30f);
  const float vw = svw / fmaxf(sdw, 1e-30f);
  return 1e-12f * (uw + vw);
}

// One row of 128 rays against the chunk's records [k0, k1): warp w takes
// column tiles 2w, 2w + 1. Writes the partial minima, or with kSummary
// (row 0 of matmul_extract) each record test's summary of each ray to
// summary [k_iters, kSumQ, 128].
template <bool kCount, bool kSummary>
__device__ void matmul_rows(const float* pf_all, const float* rays, float* partial, float* summary,
                            int row, int chunk, int k0, int k1, unsigned long long* counts) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  uint4* hi = reinterpret_cast<uint4*>(smem + static_cast<size_t>(kPfRows) * kRawStride * 4);
  uint4* lo = hi + kFrags * 32;
  __shared__ __align__(8) uint64_t bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  float bt[kTilesN][2];
#pragma unroll
  for (int j = 0; j < kTilesN; ++j) bt[j][0] = bt[j][1] = k0 < k1 ? kStart : INFINITY;
  if (k0 < k1) {
    if (threadIdx.x == 0) mbar_init(&bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) issue_record(raw, pf_all, k0 % kNRec, &bar);
    uint32_t bh[kTilesN][2][2], bl[kTilesN][2][2];
#pragma unroll
    for (int j = 0; j < kTilesN; ++j)
      ray_fragments(rays, row * kRowRays + (warp * kTilesN + j) * 8, bh[j], bl[j]);
    for (int k = k0; k < k1; ++k) {
      mbar_wait(&bar, (k - k0) & 1);
      split_record(raw, hi, lo);
      __syncthreads();  // the fragments are in; raw is free for the next record
      if (threadIdx.x == 0 && k + 1 < k1) issue_record(raw, pf_all, (k + 1) % kNRec, &bar);
      float kmin[kTilesN][2];  // the least key, or with kSummary the least t
      float s1[kTilesN][2][3], sa[kTilesN][2][3];  // kSummary: sums at the least t, over all
#pragma unroll
      for (int j = 0; j < kTilesN; ++j) {
        kmin[j][0] = kmin[j][1] = INFINITY;
#pragma unroll
        for (int q = 0; q < 3; ++q) s1[j][0][q] = s1[j][1][q] = sa[j][0][q] = sa[j][1][q] = 0.0f;
      }
      for (int tt = 0; tt < kTilesT; ++tt) {
        float acc[kTilesN][kQuant][4];
#pragma unroll
        for (int mb = 0; mb < kQuant; ++mb) {
#pragma unroll
          for (int j = 0; j < kTilesN; ++j) acc[j][mb][0] = acc[j][mb][1] = acc[j][mb][2] =
              acc[j][mb][3] = 0.0f;
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const int f = ((mb * kTilesT + tt) * 2 + ks) * 32 + lane;
            const uint4 h = hi[f], l = lo[f];
            const uint32_t ah[4] = {h.x, h.y, h.z, h.w}, al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
            for (int j = 0; j < kTilesN; ++j) {
              mma(acc[j][mb], al, bh[j][ks][0], bh[j][ks][1]);
              mma(acc[j][mb], ah, bl[j][ks][0], bl[j][ks][1]);
              mma(acc[j][mb], ah, bh[j][ks][0], bh[j][ks][1]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kTilesN; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float su, sv, sd;
            // kSummary: no running bt (inf), so the key is t where the test passes.
            const float key = test_key(acc[j][0][e], acc[j][1][e], acc[j][2][e], acc[j][3][e],
                                       kSummary ? INFINITY : bt[j][e & 1], su, sv, sd);
            if constexpr (kSummary) {
              const float x[3] = {su, sv, sd};
              merge_least(kmin[j][e & 1], s1[j][e & 1], key, x);
#pragma unroll
              for (int q = 0; q < 3; ++q) sa[j][e & 1][q] += x[q];
            } else {
              kmin[j][e & 1] = fminf(kmin[j][e & 1], key);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kTilesN; ++j) {
        if constexpr (kSummary) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // Over the 8 lanes of the ray (triangles g, g + 8 each).
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              float ao[3];
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                ao[q] = __shfl_xor_sync(0xffffffffu, s1[j][h][q], off);
                sa[j][h][q] += __shfl_xor_sync(0xffffffffu, sa[j][h][q], off);
              }
              merge_least(kmin[j][h], s1[j][h], __shfl_xor_sync(0xffffffffu, kmin[j][h], off), ao);
            }
            if (g == 0) {
              float* out = summary + static_cast<size_t>(k) * kSumQ * kRowRays +
                           (warp * kTilesN + j) * 8 + 2 * tig + h;
              const float v[kSumQ] = {kmin[j][h],
                                      correction(s1[j][h][0], s1[j][h][1], s1[j][h][2]),
                                      correction(sa[j][h][0], sa[j][h][1], sa[j][h][2])};
#pragma unroll
              for (int q = 0; q < kSumQ; ++q) out[q * kRowRays] = v[q];
            }
          }
        } else {
          bt[j][0] = fminf(bt[j][0], warp_min8(kmin[j][0]));
          bt[j][1] = fminf(bt[j][1], warp_min8(kmin[j][1]));
        }
      }
      if (kCount && lane == 0) add_count(counts, k % kNRec, kTilesN * 8);
      __syncthreads();  // every warp is done with the fragments
    }
  }
  if (g == 0 && !kSummary) {
#pragma unroll
    for (int j = 0; j < kTilesN; ++j) {
      const int col = row * kRowRays + (warp * kTilesN + j) * 8 + 2 * tig;
      partial[static_cast<size_t>(chunk) * kRays + col] = bt[j][0];
      partial[static_cast<size_t>(chunk) * kRays + col + 1] = bt[j][1];
    }
  }
}

// Blocks (row, chunk) = (b % 8, b / 8); with kExtract row 0 writes the
// summaries.
template <bool kExtract, bool kCount>
__global__ void __launch_bounds__(kMmaThreads, 2)
    matmul_kernel(const float* pf_all, const float* rays, float* partial, float* summary,
                  int k_iters, int chunks, unsigned long long* counts) {
  const int row = blockIdx.x % kRows, chunk = blockIdx.x / kRows;
  const int k0 = chunk_begin(chunk, chunks, k_iters), k1 = chunk_begin(chunk + 1, chunks, k_iters);
  if (kExtract && row == 0)
    matmul_rows<kCount, true>(pf_all, rays, partial, summary, row, chunk, k0, k1, counts);
  else
    matmul_rows<kCount, false>(pf_all, rays, partial, summary, row, chunk, k0, k1, counts);
}

// Load record tests [k0, k0 + kScanAhead) of ray r's summaries (0 past
// k_iters).
__device__ __forceinline__ void load_summaries(const float* summary, int k0, int k_iters, int r,
                                               float (&v)[kScanAhead][kSumQ]) {
#pragma unroll
  for (int i = 0; i < kScanAhead; ++i)
#pragma unroll
    for (int q = 0; q < kSumQ; ++q)
      v[i][q] = k0 + i < k_iters
                    ? __ldg(summary + (static_cast<size_t>(k0 + i) * kSumQ + q) * kRowRays + r)
                    : 0.0f;
}

// The recurrence over record tests [k0, k0 + kScanAhead) (< k_iters): the
// filter passes m0 iff m0 < bt, and the one-hot's correction is the one at
// m0 then, else the one over all triangles (every key inf).
__device__ __forceinline__ void scan_summaries(const float (&v)[kScanAhead][kSumQ], int k0,
                                               int k_iters, float& bt) {
#pragma unroll
  for (int i = 0; i < kScanAhead; ++i) {
    if (k0 + i < k_iters) {
      const bool hit = v[i][0] < bt;
      bt = fminf(bt, hit ? v[i][0] : INFINITY) + (hit ? v[i][1] : v[i][2]);
    }
  }
}

// matmul_extract's row 0, a thread a ray: the recurrence from 100 over the
// summaries in record-test order. They do not depend on bt, so the next
// kScanAhead tests load while these run.
template <bool kCount>
__global__ void __launch_bounds__(kRowRays)
    extract_scan_kernel(const float* summary, int k_iters, float* bt_out,
                        unsigned long long* counts) {
  const int r = threadIdx.x;
  float bt = kStart;
  float a[kScanAhead][kSumQ], b[kScanAhead][kSumQ];
  load_summaries(summary, 0, k_iters, r, a);
  for (int k0 = 0; k0 < k_iters; k0 += 2 * kScanAhead) {
    load_summaries(summary, k0 + kScanAhead, k_iters, r, b);
    scan_summaries(a, k0, k_iters, bt);
    load_summaries(summary, k0 + 2 * kScanAhead, k_iters, r, a);
    scan_summaries(b, k0 + kScanAhead, k_iters, bt);
  }
  if (kCount) add_count(counts, kNRec, k_iters);
  bt_out[r] = bt;
}

// bt[i] for rays i >= first_ray: the partials folded from 100 in chunk
// order, keeping the first of equal values (v < acc): in the sequential
// loop a t passes only below the running bt, so of equal values (-0.0 and
// +0.0) the first one found stays. Block: kCombineRays rays x
// kCombineParts runs of contiguous chunks; each run folds its chunks in
// order, then the runs are folded in order: the fold is associative, so
// this is the sequential order's result.
__global__ void __launch_bounds__(kCombineRays* kCombineParts)
    combine_kernel(const float* partial, int chunks, float* bt, int first_ray) {
  __shared__ float s[kCombineParts][kCombineRays];
  const int r = threadIdx.x % kCombineRays, part = threadIdx.x / kCombineRays;
  const int i = first_ray + blockIdx.x * kCombineRays + r;
  const int c0 = chunk_begin(part, kCombineParts, chunks);
  const int c1 = chunk_begin(part + 1, kCombineParts, chunks);
  float acc = INFINITY;
  if (i < kRays) {
    for (int c = c0; c < c1; ++c) {
      const float v = partial[static_cast<size_t>(c) * kRays + i];
      acc = v < acc ? v : acc;
    }
  }
  s[part][r] = acc;
  __syncthreads();
  if (part == 0 && i < kRays) {
    float out = kStart;
    for (int p = 0; p < kCombineParts; ++p) {
      const float v = s[p][r];
      out = v < out ? v : out;
    }
    bt[i] = out;
  }
}

template <bool kCount>
cudaError_t launch_variant(int variant, const float* table, const float* rays, float* bt,
                           float* partial, float* summary, int k_iters, int chunks,
                           unsigned long long* counts, cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  switch (variant) {
    case 0:
      serial_kernel<kCount><<<kRows * chunks, kRowThreads, 0, s>>>(table, rays, partial, k_iters,
                                                                   chunks, counts);
      break;
    case 1:
      outer_kernel<kCount><<<kRows * chunks, kRowThreads, 0, s>>>(table, rays, partial, k_iters,
                                                                  chunks, counts);
      break;
    case 2:
    case 3: {
      const bool extract = variant == 3;
      auto* kernel = extract ? matmul_kernel<true, kCount> : matmul_kernel<false, kCount>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMmaSmem));
      if (err != cudaSuccess) return err;
      kernel<<<kRows * chunks, kMmaThreads, kMmaSmem, s>>>(table, rays, partial, summary, k_iters,
                                                          chunks, counts);
      if (extract) {
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        extract_scan_kernel<kCount><<<1, kRowRays, 0, s>>>(summary, k_iters, bt, counts);
      }
      break;
    }
    default:
      return cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int first_ray = variant == 3 ? kRowRays : 0;
  const int grid = (kRays - first_ray + kCombineRays - 1) / kCombineRays;
  combine_kernel<<<grid, kCombineRays * kCombineParts, 0, s>>>(partial, chunks, bt, first_ray);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. variant: 0 serial (table [4, 24, T]),
// 1 outer ([NREC, T, 16]), 2 matmul ([NREC, 16, 5T]), 3 matmul + extract;
// tables 16-byte aligned. rays [6, 1024] (o, d components), bt [1024],
// partial: scratch [chunks, 1024], chunks >= 1; summary: scratch
// [k_iters, 3, 128] for matmul + extract (row 0's summaries), else unused;
// counts null (the timed instance) or zeroed int64 [4] (serial), [NREC]
// (outer, matmul) or [NREC + 1] (matmul + extract). Launches the variant's
// kernels and the combine on `stream`, does not synchronise, returns the
// first cudaError_t.
extern "C" int ptx_record_variant_launch(int variant, const float* table, const float* rays,
                                         float* bt, int k_iters, int chunks, float* partial,
                                         float* summary, unsigned long long* counts,
                                         void* stream) {
  using namespace ptx;
  if (chunks < 1 || k_iters < 0 || (variant == 3 && summary == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      counts == nullptr ? launch_variant<false>(variant, table, rays, bt, partial, summary,
                                                k_iters, chunks, nullptr, s)
                        : launch_variant<true>(variant, table, rays, bt, partial, summary,
                                               k_iters, chunks, counts, s));
}

// The timed instance of `variant`: resident blocks a SM, threads and
// dynamic shared memory a block.
extern "C" int ptx_record_variant_occupancy(int variant, int* blocks_per_sm, int* threads,
                                            int* smem) {
  using namespace ptx;
  cudaError_t err = cudaErrorInvalidValue;
  switch (variant) {
    case 0:
      *threads = kRowThreads;
      *smem = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, serial_kernel<false>,
                                                          kRowThreads, 0);
      break;
    case 1:
      *threads = kRowThreads;
      *smem = 0;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, outer_kernel<false>,
                                                          kRowThreads, 0);
      break;
    case 2:
    case 3: {
      auto* kernel = variant == 3 ? matmul_kernel<true, false> : matmul_kernel<false, false>;
      *threads = kMmaThreads;
      *smem = static_cast<int>(kMmaSmem);
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(kMmaSmem));
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kMmaThreads,
                                                            kMmaSmem);
      break;
    }
    default:
      break;
  }
  return static_cast<int>(err);
}
