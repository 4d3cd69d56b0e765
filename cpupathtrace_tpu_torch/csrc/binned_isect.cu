// K7: the cluster-major intersect of the binned wavefront for Hopper
// (sm_90a). It also serves K8's entry point (accel/cluster_major.py), whose
// TPU kernel computes the same per-pair function on another layout.
//
// Replaces: cpupathtrace_tpu/accel/pallas_traverse.py `_isect_kernel` (:238),
//   launched by `_isect_call` (:370, pallas_call :382), and
//   cpupathtrace_tpu/accel/pallas_binned.py `_cluster_kernel` (:62, pallas_call
//   :170): for every binned (ray, cluster) pair, the nearest (t, prim) over the
//   cluster's triangles (Moller-Trumbore, eps 1e-6, the cull rule). The
//   wrapper is cpupathtrace_tpu_torch/accel/traverse.py `isect`; the plain
//   version is its `isect_reference` (`nearest_in_rows`).
//
// What bounds it on this card: operations. A pair reads 24 bytes of ray and
// writes 8, and does ~64 float operations per triangle of its cluster (L =
// 128..512 on the 200k dragon, ~3,500 on the 7.2M one), so it is
// compute-bound at every cluster size the builder makes.
//
// What the design does about it: the grid runs over a work list of (cluster,
// chunk of 128 pairs) items, built on the device from the bin offsets (the
// grid is an upper bound on the item count, so no host read sizes it; blocks
// past the last item return). One thread per pair. The block streams its
// cluster's triangles through shared memory in tiles of 256 rows (16 KB), so
// a cluster of any size works; every lane reads the same row at once (a
// broadcast). Each pair is masked to its own cluster's range: CUDA blocks run
// in no order, so the TPU's tail spill into the next cluster's range (safe
// there only because its grid runs in order, :245-250) and K8's
// read-modify-write of the tail (pallas_binned.py:135-144) are not carried
// over, nor are the 128-aligned filler keys that only Mosaic's DMA needed.
//
// The tie rule is the TPU kernels': rows are tested in groups of 8
// consecutive rows (row = tile*64 + octet*8 + sub there); inside a group the
// smallest prim among the rows at the group's minimum t wins; a later group
// wins only by strict improvement. 1/det is an IEEE division (built with
// --fmad=false), as the TPU kernel computes it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_intersect.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 128;  // pairs per work item (PAIRS_PER_BLOCK)
constexpr int kTile = 256;     // triangle rows staged at once
constexpr int kBlkCols = 16;   // v0 e1 e2 cull prim, zeros
constexpr int kGroup = 8;

struct Params {
  const float* blocks;  // [C, L, 16]
  int n_clusters;
  int rows;            // L, a multiple of 8
  const float* rays;   // [6, n_pairs] planes, ordered by cluster
  int n_pairs;
  const int* offs;         // [C + 1] first pair of each cluster
  const int* chunk_start;  // [C + 1] first work item of each cluster
  float* t_out;            // [n_pairs]
  int* prim_out;           // [n_pairs]
};

__global__ void __launch_bounds__(kThreads) binned_isect_kernel(const Params p) {
  __shared__ float4 s_tri[kTile * kBlkCols / 4];
  // This block's work item: the cluster whose chunk range holds it.
  const int item = blockIdx.x;
  if (item >= p.chunk_start[p.n_clusters]) return;
  int lo = 0, hi = p.n_clusters;  // chunk_start[lo] <= item < chunk_start[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (p.chunk_start[mid] <= item) lo = mid; else hi = mid;
  }
  const int c = lo;
  const int first = p.offs[c] + (item - p.chunk_start[c]) * kThreads;
  const int pair = first + threadIdx.x;
  const bool mine = pair < p.offs[c + 1];
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 1.f;
  if (mine) {
    const int64_t n = p.n_pairs;
    ox = p.rays[pair];
    oy = p.rays[n + pair];
    oz = p.rays[2 * n + pair];
    dx = p.rays[3 * n + pair];
    dy = p.rays[4 * n + pair];
    dz = p.rays[5 * n + pair];
  }
  float bt = INFINITY, bp = -1.0f;
  const float4* blk = reinterpret_cast<const float4*>(
      p.blocks + static_cast<int64_t>(c) * p.rows * kBlkCols);
  for (int base = 0; base < p.rows; base += kTile) {
    const int rows = min(kTile, p.rows - base);
    __syncthreads();  // the previous tile is no longer read
    for (int i = threadIdx.x; i < rows * kBlkCols / 4; i += blockDim.x)
      s_tri[i] = blk[base * kBlkCols / 4 + i];
    __syncthreads();
    if (!mine) continue;
    const float* tri = reinterpret_cast<const float*>(s_tri);
    for (int g = 0; g < rows; g += kGroup) {
      float th[kGroup], pr[kGroup];
#pragma unroll
      for (int s = 0; s < kGroup; ++s) {
        const float* q = tri + (g + s) * kBlkCols;
        const float v0x = q[0], v0y = q[1], v0z = q[2];
        const float e1x = q[3], e1y = q[4], e1z = q[5];
        const float e2x = q[6], e2y = q[7], e2z = q[8];
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool miss_det = q[9] > 0.5f ? det <= kTriEps : fabsf(det) <= kTriEps;
        const float inv_det = 1.0f / (miss_det ? 1.0f : det);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float u = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const bool ok = q[10] >= 0.0f && !miss_det && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                        u + v <= 1.0f && t >= 0.0f;
        th[s] = ok ? t : INFINITY;
        pr[s] = q[10];
      }
      float tmin = th[0];
#pragma unroll
      for (int s = 1; s < kGroup; ++s) tmin = fminf(tmin, th[s]);
      float pmin = 3e38f;
#pragma unroll
      for (int s = 0; s < kGroup; ++s) pmin = th[s] <= tmin ? fminf(pmin, pr[s]) : pmin;
      if (tmin < bt) {
        bt = tmin;
        bp = pmin;
      }
    }
  }
  if (mine) {
    p.t_out[pair] = bt;
    p.prim_out[pair] = bt < INFINITY ? static_cast<int>(bp) : -1;
  }
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches `n_items` blocks of 128 threads on
// `stream` (n_items >= chunk_start[n_clusters]), does not synchronise,
// allocates nothing, returns the launch's cudaError_t (cudaErrorInvalidValue
// for a row count that is not a multiple of 8).
extern "C" int ptx_binned_isect_launch(const float* blocks, int n_clusters, int rows,
                                       const float* rays, int n_pairs, const int* offs,
                                       const int* chunk_start, int n_items, float* t_out,
                                       int* prim_out, void* stream) {
  using namespace ptx;
  if (rows % kGroup != 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return static_cast<int>(cudaSuccess);
  const Params p{blocks, n_clusters, rows, rays, n_pairs, offs, chunk_start, t_out, prim_out};
  binned_isect_kernel<<<n_items, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
