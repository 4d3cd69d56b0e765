// X1: the cost of the supercluster-tier slab pass per query, as a
// microbenchmark on Hopper (sm_90a).
//
// Replaces: benchmarks/experiments/microbench_supscan.py `make_kernel` /
//   `run` (:20-62): 64 blocks of `rows` x 128 rays; for n_iter iterations
//   every ray takes its slab entry into each of `sp` supercluster boxes
//   (pair_slab_entries there, the port's slab_entry of cluster_traverse.cuh
//   here), the block reduces a flag (any entry < 1e30) into `acc`, and the
//   next iteration's origins move by acc * 1e-9 so no iteration can be
//   hoisted. Output: the block's first 8 rows of x plus acc; with `ent`
//   non-null, also each ray's least entry over the boxes in the last
//   iteration (the check's view of every slab test; null when timed).
//   Wrapper, plain version and the plain model of this kernel's map and
//   flag: cpupathtrace_tpu_torch/experiments/supscan.py.
//
// What bounds it: operations. Per iteration and ray, sp slab tests of ~31
// float operations against boxes in shared memory (broadcast reads); the
// inputs are 8 KB a block. The TPU script fixes 64 blocks, which as one CTA
// each fill 64 of the card's 132 SMs.
//
// The design: each logical block is a thread-block cluster of two CTAs
// (`__cluster_dims__(2, 1, 1)`), so the 64 blocks run on 128 SMs. CTA r of
// block b takes the block's rays [r H, (r + 1) H), H = rows * 64, one ray
// a thread: ray r H + q is thread q of CTA r (H threads: 1,024 at rows 16,
// 512 at rows 8). Every entry is computed (no early exit, as the TPU's
// vector pass). kRayLanes = L > 1 (measured only, by the sweep in
// experiments/supscan.py from copies of this file with it rewritten; PERF.md
// §6) makes ray r H + q + k (T / L) the k-th ray of the thread group q of L
// lanes (T = min(1024, H L) threads), whose lanes split the sp boxes (lane
// j the boxes j mod L) and join their least entries with shuffle fminf:
// entries are never NaN or -0, so the order of the minimum does not change
// its bits. The flag: each CTA reduces its own with
// __syncthreads_or, one thread writes it into its peer's shared memory
// (distributed shared memory, a slot per iteration parity), both CTAs cross
// the cluster barrier and add the OR of the two flags, so acc is the same in
// both. Each CTA writes its half of the block's output rows.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_traverse.cuh"
#include "rng.cuh"

namespace cg = cooperative_groups;

namespace ptx {
namespace {

constexpr int kCtas = 2;       // CTAs a logical block (the thread-block cluster)
constexpr int kMaxThreads = 1024;
constexpr int kXRows = 16;     // rows of x per block (the TPU's (16, 128) block)
constexpr int kOutRows = 8;
constexpr int kRayLanes = 1;   // lanes a ray: 1, 2, 4 or 8

__host__ __device__ constexpr int cta_threads(int rows) {
  return rows * kLanes / kCtas * kRayLanes < kMaxThreads ? rows * kLanes / kCtas * kRayLanes
                                                             : kMaxThreads;
}

__global__ void __cluster_dims__(kCtas, 1, 1) __launch_bounds__(kMaxThreads, 1)
    supscan_kernel(const float* sup, int sp, const float* x, float* o, float* ent, int rows,
                   int n_iter) {
  extern __shared__ __align__(16) float s_sup[];
  __shared__ int s_flag[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int block = blockIdx.x / kCtas;
  for (int i = threadIdx.x; i < sp * kBndCols; i += blockDim.x) s_sup[i] = sup[i];
  // The boxes staged, and the peer running before its shared memory is written.
  cluster.sync();
  const float4* s_box = reinterpret_cast<const float4*>(s_sup);
  const float* xb = x + static_cast<size_t>(block) * kXRows * kLanes;
  const int half = rows * kLanes / kCtas;
  const int n_groups = blockDim.x / kRayLanes;
  const int group = threadIdx.x / kRayLanes, lane = threadIdx.x - group * kRayLanes;
  const int per = half / n_groups;  // rays a group, at most kRayLanes
  float ox[kRayLanes], oy[kRayLanes], oz[kRayLanes];
  InvDir inv[kRayLanes];
#pragma unroll
  for (int k = 0; k < kRayLanes; ++k) {
    const float xv = k < per ? xb[rank * half + group + k * n_groups] : 0.0f;
    ox[k] = xv * 0.1f;
    oy[k] = xv * 0.2f;
    oz[k] = xv * 0.3f;
    inv[k] = InvDir{inv_dir(xv + 1.0f), inv_dir(xv + 2.0f), inv_dir(xv + 3.0f)};
  }
  int* peer_flag = cluster.map_shared_rank(s_flag, rank ^ 1);
  float acc = 0.0f;
  for (int it = 0; it < n_iter; ++it) {
    float m = INFINITY;
#pragma unroll
    for (int k = 0; k < kRayLanes; ++k) {
      if (k >= per) break;
      const Ray r{ox[k] + acc * 1e-9f, oy[k], oz[k], 0.0f, 0.0f, 0.0f};
      float mk = INFINITY;
#pragma unroll 4
      for (int b = lane; b < sp; b += kRayLanes) {
        const float4 lo = s_box[2 * b], hi = s_box[2 * b + 1];  // two 16-byte loads a box
        const float box[7] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z};
        mk = fminf(mk, slab_entry(box, r, inv[k]));
      }
#pragma unroll
      for (int off = kRayLanes / 2; off > 0; off /= 2)
        mk = fminf(mk, __shfl_xor_sync(0xffffffffu, mk, off));
      if (ent != nullptr && it == n_iter - 1 && lane == 0)
        ent[static_cast<size_t>(block) * rows * kLanes + rank * half + group + k * n_groups] = mk;
      m = fminf(m, mk);
    }
    const int flag = __syncthreads_or(m < 1e30f);
    if (threadIdx.x == 0) peer_flag[it & 1] = flag;
    // Release and acquire: the peer's flag of this iteration is in s_flag.
    // A slot is written again two iterations on, after both CTAs crossed the
    // next barrier, so after this CTA read it.
    cluster.sync();
    acc = acc + ((flag | s_flag[it & 1]) ? 1.0f : 0.0f);
  }
  const int out_half = kOutRows * kLanes / kCtas;
  float* ob = o + static_cast<size_t>(block) * kOutRows * kLanes + rank * out_half;
  const float* xo = xb + rank * out_half;
  for (int i = threadIdx.x; i < out_half; i += blockDim.x) ob[i] = xo[i] + acc;
}

cudaError_t launch(const float* sup, int sp, const float* x, float* o, float* ent, int blocks,
                   int rows, int n_iter, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        supscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  supscan_kernel<<<blocks * kCtas, cta_threads(rows), smem, stream>>>(sup, sp, x, o, ent, rows,
                                                                      n_iter);
  return cudaGetLastError();
}

cudaError_t active_clusters(int* clusters, int rows, size_t smem, int blocks) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks * kCtas);
  config.blockDim = dim3(cta_threads(rows));
  config.dynamicSmemBytes = smem;
  return cudaOccupancyMaxActiveClusters(clusters, supscan_kernel, &config);
}

}  // namespace
}  // namespace ptx

// rows 8 or 16 (the script's sweep): a CTA's rays then fill its thread
// groups evenly at every lane count.
static bool supscan_shape(int rows) { return rows == 8 || rows == ptx::kXRows; }

// Plain C entry point for ctypes: sup [sp, 8], x [16 * blocks, 128],
// o [8 * blocks, 128], ent [blocks * rows * 128] or null, rows 8 or 16.
// Launches `blocks` clusters of 2 CTAs on `stream`, does not synchronise,
// returns the launch's cudaError_t.
extern "C" int ptx_supscan_launch(const float* sup, int sp, const float* x, float* o, float* ent,
                                  int blocks, int rows, int n_iter, void* stream) {
  using namespace ptx;
  if (!supscan_shape(rows) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(sp) * kBndCols * sizeof(float);
  return static_cast<int>(
      launch(sup, sp, x, o, ent, blocks, rows, n_iter, smem, static_cast<cudaStream_t>(stream)));
}

// The launch's shape: CTAs a cluster, threads a CTA, and the clusters that
// can be resident at once (cudaOccupancyMaxActiveClusters) for `blocks`
// clusters at (rows, sp).
extern "C" int ptx_supscan_layout(int rows, int sp, int blocks, int* ctas, int* threads,
                                  int* clusters) {
  using namespace ptx;
  if (!supscan_shape(rows) || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  *ctas = kCtas;
  *threads = cta_threads(rows);
  const size_t smem = static_cast<size_t>(sp) * kBndCols * sizeof(float);
  return static_cast<int>(active_clusters(clusters, rows, smem, blocks));
}
