// K7: the cluster-major intersect of the binned wavefront for Hopper
// (sm_90a). K8's entry point (accel/cluster_major.py), whose TPU kernel
// computes the same per-pair function on another layout, has its own kernel
// (csrc/cluster_major.cu).
//
// Replaces: cpupathtrace_tpu/accel/pallas_traverse.py `_isect_kernel` (:238),
//   launched by `_isect_call` (:370, pallas_call :382): for every binned
//   (ray, cluster) pair, the nearest (t, prim) over the
//   cluster's triangles (Moller-Trumbore, eps 1e-6, the cull rule). The
//   wrapper is cpupathtrace_tpu_torch/accel/traverse.py `isect`; the plain
//   version is its `isect_reference` (`nearest_in_rows`).
//
// What bounds it on this card: operations. A pair reads 24 bytes of ray and
// writes 8, and does ~64 float operations per triangle of its cluster (L =
// 128..512 on the 200k dragon, ~3,500 on the 7.2M one), so it is
// compute-bound at every cluster size the builder makes; with --fmad=false
// every product and sum issues alone, so the issue rate of the row tests is
// the limit, and every lane-row test that is not a pair's triangle is lost.
//
// What the design does about it:
//   - Work items that fill the lanes. The grid runs over a work list of
//     (cluster, chunk of kItemPairs pairs) items, built on the device from
//     the bin offsets (the grid is an upper bound on the item count, so no
//     host read sizes it; blocks past the last item return). With P =
//     kPairs pairs a thread, warp w of an item holds its pairs [32 P w,
//     32 P (w + 1)), lane l the pairs 32 P w + 32 s + l of its slots s < P,
//     and a warp tests as many slots as it has pairs for (warp-uniform): a
//     cluster's pairs fill ceil(n / 32) slots, so an empty lane costs at
//     most one slot of one warp of its cluster, and an empty warp no test.
//   - P pairs a thread would read each staged row once for all of them, as
//     P independent chains; P = 1, since the sweep (experiments/
//     query_sweep.py, PERF.md §6) measured P = 2 and 4 slower: their
//     registers cost more resident warps than the shared row saves. The 8
//     rows of a tie group are unrolled, so one pair's row tests are
//     independent chains.
//   - No padding rows: a cluster's rows stop at its last filled 8-row group
//     (`groups`, per cluster, from the wrapper). A group of padding rows
//     (prim -1) gives t = inf for every row and never wins, so the result
//     is the same; padding groups before the last filled one are tested.
//   - Staging overlapped with the tests: the cluster's rows come in tiles of
//     kTile rows by one bulk async copy each (cp.async.bulk on an mbarrier,
//     csrc/bulk_copy.cuh), double-buffered: tile k + 1 is in flight while
//     the block tests tile k. Clusters of any size stream through the tiles.
//     Every lane reads the same row at once (a broadcast).
// Each pair is masked to its own cluster's range: CUDA blocks run in no
// order, so the TPU's tail spill into the next cluster's range (safe there
// only because its grid runs in order, :245-250) and K8's read-modify-write
// of the tail (pallas_binned.py:135-144) are not carried over, nor are the
// 128-aligned filler keys that only Mosaic's DMA needed.
//
// The tie rule is the TPU kernels': rows are tested in groups of 8
// consecutive rows (row = tile*64 + octet*8 + sub there); inside a group the
// smallest prim among the rows at the group's minimum t wins; a later group
// wins only by strict improvement. 1/det is an IEEE division (built with
// --fmad=false), as the TPU kernel computes it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "dense_intersect.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 128;
constexpr int kPairs = 1;                         // pairs a thread
constexpr int kWarpPairs = 32 * kPairs;
constexpr int kItemPairs = kThreads * kPairs;     // pairs a work item (ITEM_PAIRS)
constexpr int kMinBlocks = 1;                     // __launch_bounds__'s blocks a SM (swept)
constexpr int kTile = 128;                        // triangle rows staged at once
constexpr int kBlkCols = 16;                      // v0 e1 e2 cull prim, zeros
constexpr int kRowBytes = kBlkCols * 4;
constexpr int kGroup = 8;

struct Params {
  const float* blocks;  // [C, L, 16]
  int n_clusters;
  int rows;            // L, a multiple of 8
  const float* rays;   // [6, n_pairs] planes, ordered by cluster
  int n_pairs;
  const int* offs;         // [C + 1] first pair of each cluster
  const int* chunk_start;  // [C + 1] first work item of each cluster
  const int* groups;       // [C] 8-row groups up to the last filled one
  float* t_out;            // [n_pairs], inf before the launch
  int* prim_out;           // [n_pairs], -1 before the launch
};

struct PairRay {
  float ox, oy, oz, dx, dy, dz;
};

// Tests S pair slots of this thread against the `n` staged rows of `tile`
// (a multiple of 8), updating each slot's (bt, bp) by the group rule: the
// group's minimum t, the smallest prim among its rows at it, and the group
// taken only by strict improvement.
template <int S>
__device__ __forceinline__ void test_rows(const float4* tile, int n, const PairRay (&ray)[kPairs],
                                          float (&bt)[kPairs], float (&bp)[kPairs]) {
  for (int g = 0; g < n; g += kGroup) {
    float th[S][kGroup], pr[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float4 a = tile[4 * (g + k)], b = tile[4 * (g + k) + 1], c = tile[4 * (g + k) + 2];
      const float v0x = a.x, v0y = a.y, v0z = a.z;
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w, e2z = c.x;
      const float cull = c.y;
      pr[k] = c.z;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const PairRay& r = ray[s];
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
        th[s][k] = ok ? t : INFINITY;
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float tmin = th[s][0];
#pragma unroll
      for (int k = 1; k < kGroup; ++k) tmin = fminf(tmin, th[s][k]);
      float pmin = 3e38f;
#pragma unroll
      for (int k = 0; k < kGroup; ++k) pmin = th[s][k] <= tmin ? fminf(pmin, pr[k]) : pmin;
      if (tmin < bt[s]) {
        bt[s] = tmin;
        bp[s] = pmin;
      }
    }
  }
}

// test_rows<S> for the warp's `slots` (0 .. S): nothing for 0.
template <int S>
__device__ __forceinline__ void test_slots(int slots, const float4* tile, int n,
                                           const PairRay (&ray)[kPairs], float (&bt)[kPairs],
                                           float (&bp)[kPairs]) {
  if (slots == S)
    test_rows<S>(tile, n, ray, bt, bp);
  else if constexpr (S > 1)
    test_slots<S - 1>(slots, tile, n, ray, bt, bp);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks) binned_isect_kernel(const Params p) {
  __shared__ __align__(128) float4 s_tile[2][kTile * kBlkCols / 4];
  __shared__ __align__(8) uint64_t s_bar[2];
  // This block's work item: the cluster whose chunk range holds it.
  const int item = blockIdx.x;
  if (item >= p.chunk_start[p.n_clusters]) return;
  int lo = 0, hi = p.n_clusters;  // chunk_start[lo] <= item < chunk_start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (p.chunk_start[mid] <= item) lo = mid; else hi = mid;
  }
  const int c = lo;
  // No filled row: every pair keeps the (inf, -1) it was given.
  const int rows = p.groups[c] * kGroup;
  if (rows == 0) return;
  const int end = p.offs[c + 1];
  const int warp_first = p.offs[c] + (item - p.chunk_start[c]) * kItemPairs +
                         (threadIdx.x >> 5) * kWarpPairs;
  // The warp's 32-pair slots that hold a pair (warp-uniform).
  const int slots = (min(max(end - warp_first, 0), kWarpPairs) + 31) / 32;

  if (threadIdx.x == 0) {
    mbar_init(&s_bar[0], 1);
    mbar_init(&s_bar[1], 1);
  }
  __syncthreads();
  const char* src = reinterpret_cast<const char*>(p.blocks) +
                    static_cast<int64_t>(c) * p.rows * kRowBytes;
  const int n_tiles = (rows + kTile - 1) / kTile;
  // One thread copies tile k into buffer k % 2, completing on its barrier.
  auto issue = [&](int k) {
    const uint32_t bytes = min(kTile, rows - k * kTile) * kRowBytes;
    mbar_arrive_expect_tx(&s_bar[k & 1], bytes);
    bulk_g2s(s_tile[k & 1], src + static_cast<int64_t>(k) * kTile * kRowBytes, bytes,
             &s_bar[k & 1]);
  };
  if (threadIdx.x == 0) issue(0);

  PairRay ray[kPairs];
  float bt[kPairs], bp[kPairs];
  const int64_t n = p.n_pairs;
#pragma unroll
  for (int s = 0; s < kPairs; ++s) {
    const int pair = warp_first + 32 * s + (threadIdx.x & 31);
    ray[s] = PairRay{0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
    if (pair < end)
      ray[s] = PairRay{p.rays[pair], p.rays[n + pair], p.rays[2 * n + pair],
                       p.rays[3 * n + pair], p.rays[4 * n + pair], p.rays[5 * n + pair]};
    bt[s] = INFINITY;
    bp[s] = -1.0f;
  }
  for (int k = 0; k < n_tiles; ++k) {
    if (threadIdx.x == 0 && k + 1 < n_tiles) issue(k + 1);
    mbar_wait(&s_bar[k & 1], (k >> 1) & 1);
    const int n_rows = min(kTile, rows - k * kTile);
    test_slots<kPairs>(slots, s_tile[k & 1], n_rows, ray, bt, bp);
    __syncthreads();  // buffer k % 2 is read by all before tile k + 2 refills it
  }
#pragma unroll
  for (int s = 0; s < kPairs; ++s) {
    const int pair = warp_first + 32 * s + (threadIdx.x & 31);
    if (s < slots && pair < end) {
      p.t_out[pair] = bt[s];
      p.prim_out[pair] = bt[s] < INFINITY ? static_cast<int>(bp[s]) : -1;
    }
  }
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches `n_items` blocks of 128 threads on
// `stream` (n_items >= chunk_start[n_clusters]), does not synchronise,
// allocates nothing, returns the launch's cudaError_t (cudaErrorInvalidValue
// for a row count that is not a multiple of 8 or blocks not 16-byte
// aligned). t_out and prim_out hold (inf, -1) before the launch; the kernel
// writes the pairs of clusters with a filled row.
extern "C" int ptx_binned_isect_launch(const float* blocks, int n_clusters, int rows,
                                       const float* rays, int n_pairs, const int* offs,
                                       const int* chunk_start, const int* groups, int n_items,
                                       float* t_out, int* prim_out, void* stream) {
  using namespace ptx;
  if (rows % kGroup != 0 || rows <= 0 || (reinterpret_cast<uintptr_t>(blocks) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return static_cast<int>(cudaSuccess);
  const Params p{blocks, n_clusters, rows, rays, n_pairs, offs, chunk_start, groups,
                 t_out, prim_out};
  binned_isect_kernel<<<n_items, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM and threads per block of the kernel, and the pairs
// of a work item (accel/traverse.py ITEM_PAIRS).
extern "C" int ptx_binned_isect_occupancy(int* blocks, int* threads, int* item_pairs) {
  using namespace ptx;
  *threads = kThreads;
  *item_pairs = kItemPairs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, binned_isect_kernel, kThreads, 0));
}
