// K8: the cluster-major compute stage of the bin-by-cluster intersector for
// Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/accel/pallas_binned.py `_cluster_kernel` (:62),
//   launched by `_cluster_call` (pallas_call :170): for every binned (ray,
//   cluster) pair, the nearest (t, prim) over the cluster's triangles
//   (Moller-Trumbore, eps 1e-6, the cull rule, an IEEE 1/det). The wrapper is
//   cpupathtrace_tpu_torch/accel/cluster_major.py `test_candidates`; the plain
//   version is its `_test_candidates`, and `split_stage_model` there is the
//   plain model of this kernel's split and merge.
//
// What bounds it on this card: operations. A pair reads 24 bytes of ray and
// writes 12, and does ~64 float operations per triangle of its cluster
// (~390 on the 200k dragon); with --fmad=false every product and sum issues
// alone. One query gives few pairs a cluster (~48 on the dragon at M = 4),
// so a kernel that gives each warp all of its cluster's rows keeps ~1,000
// warps busy on a card that holds 8,448, and lasts as long as one warp's
// chain of ~50-64 eight-row groups.
//
// What the design does about it:
//   - Shorter chains. A work item is one cluster x 32 (W / S) pairs, held by
//     a block of W warps: warp w takes the pairs of slot w / S and the row
//     range w % S of S ranges that cut the cluster's rows up to its last
//     filled 8-row group (`groups`) at group boundaries, range j the groups
//     [j g / S, (j + 1) g / S). The wrapper picks S from the shapes alone.
//   - The merge. The S warps of a slot write their partial (t, prim) to
//     shared memory; the range-0 warp takes ranges 1 .. S-1 in order, each
//     only by a strictly smaller t. The ranges are contiguous and in group
//     order, so this is the merge by the key (t, group, prim): the least t,
//     then the earlier group, and inside a group the smaller prim (which the
//     range's own group rule already picked). That is the sequential group
//     rule bit for bit.
//   - No host read sizes the launch: the grid is the resident blocks (at
//     most the items' bound from the shapes), striding over the work list
//     built on the device from the bin offsets (`chunk_start`).
//   - The stage's gather and scatters fused: a pair's ray is read through
//     the binned `order` (ray = order[pair] / M) and its (t, prim) written
//     straight to its slot, prim as int64; the slots sorted past the last
//     cluster (empty candidates) get (inf, -1) here, so the outputs need no
//     fill.
//   - Rows staged: one bulk copy of the cluster's rows up to its last
//     filled group into shared memory a work item (`staged`), or read by
//     broadcast loads (every lane of a warp the same row) through L1.
//     experiments/cluster_major_sweep.py measured both at every S, blocks of
//     64 / 128 / 256 threads and a register cap (both from copies of this
//     file with kThreads / kMinWarps rewritten; PERF.md §6): the wrapper
//     stages (to 96 KB of rows), S = 4 on the 200k dragon's 512-row clusters.
// Blocks of kThreads threads; S a power of two up to the block's warps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "dense_intersect.cuh"

namespace ptx {
namespace {

// Warps a SM that __launch_bounds__ asks registers for (0: no cap; 32 caps
// them at 64 a thread), swept by experiments/cluster_major_sweep.py
// (PERF.md §6).
constexpr int kMinWarps = 0;
constexpr int kThreads = 128;  // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kBlkCols = 16;  // v0 e1 e2 cull prim, zeros
constexpr int kRowBytes = kBlkCols * 4;
constexpr int kGroup = 8;

struct Params {
  const float* blocks;     // [C, L, 16]
  int n_clusters;
  int rows;                // L, a multiple of 8
  const float* o;          // [R, 3]
  const float* d;          // [R, 3]
  const int64_t* order;    // [n_slots] the slots ordered by cluster (binned)
  int n_slots;             // R * M
  int m;                   // M, candidate slots a ray
  const int* offs;         // [C + 1] first binned pair of each cluster
  const int* chunk_start;  // [C + 1] first work item of each cluster
  const int* groups;       // [C] 8-row groups up to the last filled one
  int splits;              // S, row ranges a pair
  float* t_out;            // [n_slots], slot order
  int64_t* prim_out;       // [n_slots], slot order
};

struct PairRay {
  float ox, oy, oz, dx, dy, dz;
};

template <bool kShared>
__device__ __forceinline__ float4 piece(const float4* p) {
  if constexpr (kShared) return *p;
  else return __ldg(p);
}

// The group rule over the groups [g0, g1) of `rows` (4 float4 pieces a row):
// per group the least t of its 8 rows and the smallest prim among the rows at
// it, a later group taken only by strict improvement of (bt, bp).
template <bool kShared>
__device__ __forceinline__ void test_groups(const float4* rows, int g0, int g1, const PairRay& r,
                                            float& bt, float& bp) {
  for (int g = g0; g < g1; ++g) {
    float th[kGroup], pr[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float4* row = rows + 4 * (g * kGroup + k);
      const float4 a = piece<kShared>(row), b = piece<kShared>(row + 1),
                   c = piece<kShared>(row + 2);
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w, e2z = c.x;
      const float cull = c.y;
      pr[k] = c.z;
      const float px = r.dy * e2z - r.dz * e2y;
      const float py = r.dz * e2x - r.dx * e2z;
      const float pz = r.dx * e2y - r.dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool miss_det = cull > 0.5f ? det <= kTriEps : fabsf(det) <= kTriEps;
      const float inv_det = 1.0f / (miss_det ? 1.0f : det);
      const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool ok = pr[k] >= 0.0f && !miss_det && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                      u + v <= 1.0f && t >= 0.0f;
      th[k] = ok ? t : INFINITY;
    }
    float tmin = th[0];
#pragma unroll
    for (int k = 1; k < kGroup; ++k) tmin = fminf(tmin, th[k]);
    float pmin = 3e38f;
#pragma unroll
    for (int k = 0; k < kGroup; ++k) pmin = th[k] <= tmin ? fminf(pmin, pr[k]) : pmin;
    if (tmin < bt) {
      bt = tmin;
      bp = pmin;
    }
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinWarps > 0 ? kMinWarps / kWarps : 1)
    cluster_major_kernel(const Params p) {
  extern __shared__ __align__(128) float4 s_rows[];  // staged: the item's cluster rows
  __shared__ float s_t[kWarps][32], s_p[kWarps][32];
  __shared__ __align__(8) uint64_t s_bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int S = p.splits;
  const int slot = warp / S, range = warp - slot * S;
  const int item_pairs = 32 * (kWarps / S);
  const int n_items = p.chunk_start[p.n_clusters];
  if constexpr (kStaged) {
    if (threadIdx.x == 0) mbar_init(&s_bar, 1);
    __syncthreads();
  }
  uint32_t parity = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    // The cluster whose chunk range holds the item.
    int lo = 0, hi = p.n_clusters;  // chunk_start[lo] <= item < chunk_start[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (p.chunk_start[mid] <= item) lo = mid; else hi = mid;
    }
    const int c = lo;
    const int g = p.groups[c];
    const int end = p.offs[c + 1];
    const int first = p.offs[c] + (item - p.chunk_start[c]) * item_pairs + slot * 32;
    const int pair = first + lane;
    const float4* rows =
        reinterpret_cast<const float4*>(p.blocks + static_cast<int64_t>(c) * p.rows * kBlkCols);
    if constexpr (kStaged) {
      if (g > 0) {  // block-uniform
        if (threadIdx.x == 0) {
          const uint32_t bytes = static_cast<uint32_t>(g) * kGroup * kRowBytes;
          mbar_arrive_expect_tx(&s_bar, bytes);
          bulk_g2s(s_rows, rows, bytes, &s_bar);
        }
        mbar_wait(&s_bar, parity);
        parity ^= 1;
      }
      rows = s_rows;
    }
    int64_t slot_id = 0;
    PairRay r{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
    if (pair < end) {
      slot_id = p.order[pair];
      const int64_t ray = slot_id / p.m;
      r = PairRay{p.o[3 * ray], p.o[3 * ray + 1], p.o[3 * ray + 2],
                  p.d[3 * ray], p.d[3 * ray + 1], p.d[3 * ray + 2]};
    }
    float bt = INFINITY, bp = -1.0f;
    if (first < end)  // warp-uniform: the slot holds a pair
      test_groups<kStaged>(rows, range * g / S, (range + 1) * g / S, r, bt, bp);
    if (S > 1) {  // block-uniform
      s_t[warp][lane] = bt;
      s_p[warp][lane] = bp;
      __syncthreads();
      if (range == 0) {
        for (int j = 1; j < S; ++j) {
          const float t = s_t[warp + j][lane];
          if (t < bt) {
            bt = t;
            bp = s_p[warp + j][lane];
          }
        }
      }
    }
    if (range == 0 && pair < end) {
      p.t_out[slot_id] = bt;
      p.prim_out[slot_id] = bt < INFINITY ? static_cast<int64_t>(bp) : -1;
    }
    if (S > 1 || kStaged) __syncthreads();  // shared memory is reused by the next item
  }
  // The empty slots, sorted past the last cluster's range.
  for (int pair = p.offs[p.n_clusters] + blockIdx.x * kThreads + threadIdx.x; pair < p.n_slots;
       pair += gridDim.x * kThreads) {
    const int64_t s = p.order[pair];
    p.t_out[s] = INFINITY;
    p.prim_out[s] = -1;
  }
}

template <bool kStaged>
cudaError_t set_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(cluster_major_kernel<kStaged>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

template <bool kStaged>
cudaError_t launch(const Params& p, int grid, size_t smem, cudaStream_t stream) {
  const cudaError_t err = set_smem<kStaged>(smem);
  if (err != cudaSuccess) return err;
  cluster_major_kernel<kStaged><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kStaged>
cudaError_t occupancy(int* blocks, size_t smem) {
  const cudaError_t err = set_smem<kStaged>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, cluster_major_kernel<kStaged>,
                                                       kThreads, smem);
}

}  // namespace
}  // namespace ptx

// Dynamic shared memory of a launch: the cluster rows when staged, else none.
static size_t stage_smem(int rows, int staged) {
  return staged ? static_cast<size_t>(rows) * ptx::kRowBytes : 0;
}

// Plain C entry point for ctypes. Launches `grid` blocks of kThreads threads
// on `stream`, each striding over the work items of `chunk_start` with
// `splits` row ranges a pair (a power of two up to kThreads / 32), rows from
// global memory (`staged` 0) or staged in shared memory (1); does not
// synchronise, allocates nothing, returns the launch's cudaError_t
// (cudaErrorInvalidValue for a row count that is not a positive multiple of
// 8, blocks not 16-byte aligned, or an S it does not take). Writes every
// slot of t_out and prim_out.
extern "C" int ptx_cluster_major_launch(const float* blocks, int n_clusters, int rows,
                                        const float* o, const float* d, const int64_t* order,
                                        int n_slots, int m, const int* offs,
                                        const int* chunk_start, const int* groups, int grid,
                                        int splits, int staged, float* t_out, int64_t* prim_out,
                                        void* stream) {
  using namespace ptx;
  if (rows % kGroup != 0 || rows <= 0 || m < 1 || grid < 1 ||
      (reinterpret_cast<uintptr_t>(blocks) & 15) || splits < 1 || (splits & (splits - 1)) ||
      splits > kWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots <= 0) return static_cast<int>(cudaSuccess);
  const Params p{blocks, n_clusters, rows, o, d, order, n_slots, m, offs, chunk_start, groups,
                 splits, t_out, prim_out};
  const size_t smem = stage_smem(rows, staged);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = staged ? launch<true>(p, grid, smem, s) : launch<false>(p, grid, smem, s);
  return static_cast<int>(err);
}

// The launch's shape at L = `rows`: the block's threads (kThreads) and the
// resident blocks per SM of the instance `staged`.
extern "C" int ptx_cluster_major_shape(int staged, int rows, int* threads, int* blocks) {
  using namespace ptx;
  if (rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *threads = kThreads;
  const size_t smem = stage_smem(rows, staged);
  return static_cast<int>(staged ? occupancy<true>(blocks, smem) : occupancy<false>(blocks, smem));
}
