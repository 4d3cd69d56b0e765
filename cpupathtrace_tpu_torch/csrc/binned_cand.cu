// K6: the candidate scan of the binned wavefront for Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/accel/pallas_traverse.py `_cand_kernel` (:121),
//   launched by `_cand_call` (:207, pallas_call :221): per ray, the slab test
//   against every cluster box, keeping the top-M (entry, id) candidates in
//   (entry, id)-lexicographic order above the bound (t_lo, id_lo) and below
//   the ray's best hit, plus the (M+1)-th as the overflow row. The wrapper is
//   cpupathtrace_tpu_torch/accel/traverse.py `candidates`; the plain version
//   is its `candidates_reference`, and `split_scan_model` there is the plain
//   model of this kernel's split scan and merge.
//
// What bounds it on this card: operations. A ray reads 36 bytes and writes
// 8 (M+1) bytes, and does ~40 float operations per cluster (the slab test and
// the insertion), so at hundreds of clusters it is compute-bound by far; one
// ray's scan is one dependent chain, so the card needs many chains in flight.
//
// What the design does about it:
//   - A ray's scan is split over a group of lanes. Lane j of a group of G
//     scans the clusters c = j, j + G, ... in ascending order (a lane scans
//     one cluster fewer where C is not a multiple of G) into its own M+1
//     sorted (entry, id) slots, with the insertion of `_cand_kernel`. The
//     group then merges its lists in log2(G) rounds of __shfl_xor_sync, each
//     keeping the least M+1 of the two lists in order (`merge`, by
//     selection). Cluster ids are distinct, so (entry, id) orders the
//     candidates totally (NaN and +inf entries never pass the test): the
//     serial insertion leaves the least M+1 candidates sorted in its slots,
//     and so does the merge, bit for bit.
//   - Pending rays are compacted per block. A block takes windows of
//     kThreads / G consecutive rays; the window's first threads read
//     t_lo, write a ray with nothing pending (t_lo = +inf) as empty slots
//     (-1 ids, +inf entries, as the TPU's skip of a whole block leaves
//     them), and append the pending ones to a list in shared memory; group
//     g then scans the list's g-th ray, so warps past the list's end idle
//     through the window. One __syncthreads a window: the lists rotate
//     through three buffers, so a buffer is cleared two windows after its
//     last reader passed a barrier.
//   - The groups adapt to the launch and to the window. The launch's
//     lanes a ray are an argument (2^lanes_log2): the wrapper gives each
//     ray as many lanes as the resident threads hold, from one up to a
//     warp (traverse.cand_grid), so a small launch spreads over the card;
//     a window whose pending rays would not fill the block doubles its
//     groups again, up to a warp. A full round-1 launch of the dragon
//     frame runs 4 lanes a ray; the few pending rays of a later round run
//     on whole warps, so their chains are short.
//   - A persistent grid: the resident blocks, at most one a window (the
//     wrapper sizes it from ptx_binned_cand_occupancy with the same lanes
//     a ray), each taking every gridDim.x-th window.
//     The bounds table (32 bytes a cluster, 128 KB at the 4096-cluster
//     limit) is staged once per resident block, split into two float4
//     planes (columns 0-3 and 4-7), so the lanes that read consecutive
//     clusters at once read consecutive 16-byte words.
// M is a template parameter, so the slots, the insertion and the merge
// unroll into registers, as in the TPU kernel.
//
// The arithmetic is `_cand_kernel`'s float32 operations in its order (built
// with --fmad=false, IEEE division); the cluster id is carried as a float, as
// on the TPU, so the lexicographic comparisons are bit-exact with the plain
// version, and the exactness rounds of the pipeline terminate.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "dense_intersect.cuh"

namespace ptx {
namespace {

// The block, chosen by experiments/intersect_sweep.py (PERF.md §6).
constexpr int kThreads = 256;
constexpr int kBndCols = 8;  // lo3 hi3 valid pad
constexpr int kLists = 3;    // rotating pending lists (one barrier a window)
static_assert(kThreads % 32 == 0, "kThreads: whole warps");

__device__ __forceinline__ float slab_inv(float d) { return fabsf(d) > 0.0f ? 1.0f / d : FLT_MAX; }

// (ce, ci) into the sorted slots (e, cid): `_cand_kernel`'s insertion, the
// M kept slots by compare-and-swap, then the overflow slot by replacement.
template <int M>
__device__ __forceinline__ void insert(float (&e)[M + 1], float (&cid)[M + 1], float ce,
                                       float ci) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const bool less = ce < e[j] || (ce == e[j] && ci < cid[j]);
    const float te = e[j], ti = cid[j];
    e[j] = less ? ce : te;
    cid[j] = less ? ci : ti;
    ce = less ? te : ce;
    ci = less ? ti : ci;
  }
  const bool less = ce < e[M] || (ce == e[M] && ci < cid[M]);
  e[M] = less ? ce : e[M];
  cid[M] = less ? ci : cid[M];
}

__device__ __forceinline__ bool lex_less(float ae, float ac, float be, float bc) {
  return ae < be || (ae == be && ac < bc);
}

// The least M+1 of two sorted slot lists A = (e, cid) and B = (pe, pc), in
// order, into (e, cid), by selection: slot k is the least of B[k], A[k] and
// max(A[i-1], B[k-i]) for 0 < i <= k, the k-th least of the union. The
// maxima are independent, so the chain is M+2 selects deep (inserting B's
// slots one by one is a chain of (M+1)^2 compare-and-swaps).
template <int M>
__device__ __forceinline__ void merge(float (&e)[M + 1], float (&cid)[M + 1],
                                      const float (&pe)[M + 1], const float (&pc)[M + 1]) {
  float oe[M + 1], oc[M + 1];
#pragma unroll
  for (int k = 0; k <= M; ++k) {
    const bool a_less = lex_less(e[k], cid[k], pe[k], pc[k]);
    float me = a_less ? e[k] : pe[k], mc = a_less ? cid[k] : pc[k];
#pragma unroll
    for (int i = 1; i <= k; ++i) {
      const bool b_more = lex_less(e[i - 1], cid[i - 1], pe[k - i], pc[k - i]);
      const float xe = b_more ? pe[k - i] : e[i - 1], xc = b_more ? pc[k - i] : cid[i - 1];
      const bool x_less = lex_less(xe, xc, me, mc);
      me = x_less ? xe : me;
      mc = x_less ? xc : mc;
    }
    oe[k] = me;
    oc[k] = mc;
  }
#pragma unroll
  for (int k = 0; k <= M; ++k) {
    e[k] = oe[k];
    cid[k] = oc[k];
  }
}

__device__ __forceinline__ void empty_slots(int m1, int64_t n, int64_t r, int* ids, float* ent) {
  for (int j = 0; j < m1; ++j) {
    ent[j * n + r] = INFINITY;
    ids[j * n + r] = -1;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
    binned_cand_kernel(const float* __restrict__ bounds, int n_clusters,
                       const float* __restrict__ rays, int n, int* __restrict__ ids_out,
                       float* __restrict__ ent_out, int lanes_log2) {
  extern __shared__ float4 s_bnd[];  // [2][n_clusters]: columns 0-3, then 4-7
  __shared__ int s_count[kLists];
  __shared__ int s_list[kLists][kThreads];  // the widest window: one lane a ray
  const float4* b4 = reinterpret_cast<const float4*>(bounds);
  for (int i = threadIdx.x; i < 2 * n_clusters; i += kThreads)
    s_bnd[(i & 1) * n_clusters + (i >> 1)] = b4[i];
  if (threadIdx.x < kLists) s_count[threadIdx.x] = 0;
  __syncthreads();

  const int64_t n64 = n;
  const int lg0 = lanes_log2;  // the launch's lanes a ray: windows of kThreads >> lg0
  const int window = kThreads >> lg0;
  const int n_windows = (n + window - 1) / window;
  int buf = 0;
  for (int w = blockIdx.x; w < n_windows; w += gridDim.x) {
    // Claim: the window's pending rays into list `buf`, the others written
    // out empty; list buf + 1 (last read two windows ago) is cleared.
    if (threadIdx.x < window) {
      const int64_t r = static_cast<int64_t>(w) * window + threadIdx.x;
      if (r < n) {
        if (rays[7 * n64 + r] < INFINITY)
          s_list[buf][atomicAdd(&s_count[buf], 1)] = static_cast<int>(r);
        else
          empty_slots(M + 1, n64, r, ids_out, ent_out);
      }
    }
    const int next = buf == kLists - 1 ? 0 : buf + 1;
    if (threadIdx.x == 0) s_count[next] = 0;
    __syncthreads();
    const int pending = s_count[buf];
    // 2^lg lanes a ray: the launch's, doubled (up to a warp) while the
    // window's pending rays would still fill the block.
    int lg = lg0;
    while (lg < 5 && (pending << (lg + 1)) <= kThreads) ++lg;
    const int gs = 1 << lg;
    const int g = threadIdx.x >> lg;        // the group: the window's g-th pending ray
    const int j = threadIdx.x & (gs - 1);   // the lane in the group
    if (((threadIdx.x & ~31) >> lg) < pending) {  // warp-uniform: a group of the warp has a ray
      const bool has_ray = g < pending;
      const int64_t r = has_ray ? s_list[buf][g] : 0;
      float e[M + 1], cid[M + 1];
#pragma unroll
      for (int k = 0; k <= M; ++k) {
        e[k] = INFINITY;
        cid[k] = INFINITY;
      }
      if (has_ray) {
        const float ox = rays[r], oy = rays[n64 + r], oz = rays[2 * n64 + r];
        const float dx = rays[3 * n64 + r], dy = rays[4 * n64 + r], dz = rays[5 * n64 + r];
        const float best = rays[6 * n64 + r];
        const float t_lo = rays[7 * n64 + r], id_lo = rays[8 * n64 + r];
        const float ix = slab_inv(dx), iy = slab_inv(dy), iz = slab_inv(dz);
        for (int c = j; c < n_clusters; c += gs) {
          const float4 a = s_bnd[c], b = s_bnd[n_clusters + c];
          // a = lo.x lo.y lo.z hi.x, b = hi.y hi.z valid pad
          const float t1x = (a.x - ox) * ix, t2x = (a.w - ox) * ix;
          const float t1y = (a.y - oy) * iy, t2y = (b.x - oy) * iy;
          const float t1z = (a.z - oz) * iz, t2z = (b.y - oz) * iz;
          const float tmin = jmax(jmax(jmin(t1x, t2x), jmin(t1y, t2y)), jmin(t1z, t2z));
          const float tmax = jmin(jmin(jmax(t1x, t2x), jmax(t1y, t2y)), jmax(t1z, t2z));
          const float entry = tmin < 0.0f ? 0.0f : tmin;
          const float cf = static_cast<float>(c);
          const bool after = (entry > t_lo) || (entry == t_lo && cf > id_lo);
          const bool ok = b.z > 0.5f && tmax >= 0.0f && tmin <= tmax && entry < best && after;
          if (ok) insert<M>(e, cid, entry, cf);  // (inf, inf) displaces nothing
        }
      }
      // Merge the group's lists: partners 1, 2, 4, ... apart, inside the group.
      for (int s = 1; s < gs; s <<= 1) {
        float pe[M + 1], pc[M + 1];
#pragma unroll
        for (int k = 0; k <= M; ++k) {
          pe[k] = __shfl_xor_sync(0xffffffffu, e[k], s);
          pc[k] = __shfl_xor_sync(0xffffffffu, cid[k], s);
        }
        merge<M>(e, cid, pe, pc);
      }
      if (has_ray) {
#pragma unroll
        for (int k = 0; k <= M; ++k) {
          if ((k & (gs - 1)) == j) {  // the group's lanes share the stores
            ent_out[k * n64 + r] = e[k];
            ids_out[k * n64 + r] = e[k] < INFINITY ? static_cast<int>(cid[k]) : -1;
          }
        }
      }
    }
    buf = next;
  }
}

size_t smem_bytes(int n_clusters) {
  return static_cast<size_t>(n_clusters) * kBndCols * sizeof(float);
}

// The instance's shared-memory limit is set to each launch's size past the
// 48 KB default (an occupancy query at another size may have set it since).
template <int M>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(binned_cand_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int M>
cudaError_t occupancy(size_t smem, int* blocks) {
  const cudaError_t err = allow_smem<M>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, binned_cand_kernel<M>, kThreads,
                                                       smem);
}

template <int M>
cudaError_t launch(const float* bounds, int n_clusters, const float* rays, int n, int* ids,
                   float* ent, int grid, int lanes_log2, cudaStream_t stream) {
  const size_t smem = smem_bytes(n_clusters);
  const cudaError_t err = allow_smem<M>(smem);
  if (err != cudaSuccess) return err;
  binned_cand_kernel<M><<<grid, kThreads, smem, stream>>>(bounds, n_clusters, rays, n, ids, ent,
                                                          lanes_log2);
  return cudaGetLastError();
}

template <int M>
cudaError_t query(int n_clusters, int* blocks) {
  return occupancy<M>(smem_bytes(n_clusters), blocks);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. bounds [n_clusters, 8], 16-byte aligned;
// rays [9, n] planes; ids / ent [m + 1, n]. Launches `grid` blocks (the
// resident blocks, at most one a window) with 2^lanes_log2 lanes a ray
// (both from traverse.cand_grid and ptx_binned_cand_occupancy) on
// `stream`, does not synchronise, allocates nothing, returns the launch's
// cudaError_t (cudaErrorInvalidValue for m outside 1..7, no block or
// lanes_log2 outside 0..5).
extern "C" int ptx_binned_cand_launch(const float* bounds, int n_clusters, const float* rays,
                                      int n, int m, int* ids, float* ent, int grid,
                                      int lanes_log2, void* stream) {
  using namespace ptx;
  if (grid < 1 || lanes_log2 < 0 || lanes_log2 > 5)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lg = lanes_log2;
  switch (m) {
    case 1: return static_cast<int>(launch<1>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    case 2: return static_cast<int>(launch<2>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    case 3: return static_cast<int>(launch<3>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    case 4: return static_cast<int>(launch<4>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    case 5: return static_cast<int>(launch<5>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    case 6: return static_cast<int>(launch<6>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    case 7: return static_cast<int>(launch<7>(bounds, n_clusters, rays, n, ids, ent, grid, lg, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The instance of m at n_clusters: its resident blocks per SM (0 where none
// fits), threads per block and the dynamic shared memory of a launch.
extern "C" int ptx_binned_cand_occupancy(int m, int n_clusters, int* blocks, int* threads,
                                         long long* smem) {
  using namespace ptx;
  *threads = kThreads;
  *smem = static_cast<long long>(smem_bytes(n_clusters));
  switch (m) {
    case 1: return static_cast<int>(query<1>(n_clusters, blocks));
    case 2: return static_cast<int>(query<2>(n_clusters, blocks));
    case 3: return static_cast<int>(query<3>(n_clusters, blocks));
    case 4: return static_cast<int>(query<4>(n_clusters, blocks));
    case 5: return static_cast<int>(query<5>(n_clusters, blocks));
    case 6: return static_cast<int>(query<6>(n_clusters, blocks));
    case 7: return static_cast<int>(query<7>(n_clusters, blocks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
