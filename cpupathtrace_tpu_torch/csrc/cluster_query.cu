// K4: the standalone cluster-set query on Hopper (sm_90a): the K3 device
// functions (cluster_traverse.cuh), nearest or any-hit, one ray per thread at
// a time on refilling persistent warps; writes t [n] f32 and prim [n] i32.
//
// Replaces: cpupathtrace_tpu/accel/kernel_traverse.py `_single_kernel`
//   (:1158), launched by `_single_call` (:1201) / `cluster_intersect_kernel`
//   (:1250). Wrapper and plain version: `cluster_intersect` and
//   `traverse_clusters[_anyhit]` in cpupathtrace_tpu_torch/accel/kernel_traverse.py.
//   On a render path it is the small partition of `krn_intersect`
//   (accel/traverse.py): every wavefront query of a lean binned scene, two a
//   bounce (nearest and shadow).
//
// Output convention of cluster_intersect_kernel: nearest -> (t, prim) of the
// winner or (-1, -1); any-hit -> (1, 0) where something occludes in
// [0, t_lim), else (-1, -1). t_lim <= 0 makes a ray inactive. Ray i's result
// is written to i, whichever lane ran it.
//
// Counters (debug_visits): with a `visits` output [ceil(n / 1024), 4] int32,
// each ray adds its supercluster descends, record visits, slab tests below
// the root gate and filled record rows tested to its 1024-ray block's row
// (the Visits policy of cluster_traverse.cuh). The counting instance also
// adds the warps' steps to `steps` [4] int64 (QuerySteps below).
//
// What bounds it on this card: the walk's (see cluster_traverse.cuh), the
// latency of its dependent loads and the divergence of its lanes; the query
// adds 28 bytes of ray in and 8 bytes out per ray. Its work is small (on the
// 200k dragon ~24 slab tests and ~18 filled rows a random ray). Run as
// nested loops, a warp's lanes left the loops at different iterations and
// did not meet again before the walk ended: the counting instance read one
// active lane per filled-row step (PERF.md §6), so the lanes' tests ran one
// after another.
//
// What the design does about it:
//   - The walk is the state machine of cluster_traverse.cuh (`Walk`, one
//     instance each for nearest and any-hit) that does one test a step, a
//     record row or a hyper, supercluster or cluster box, whichever loop the
//     lane is in; every step the warp meets at the claim, so the lanes that
//     test rows do so together, as do those that test boxes.
//   - Refilling persistent warps: the grid is the resident blocks (the
//     wrapper sizes it from the occupancy); a lane whose ray ends writes its
//     result and, at the next step, the warp's free lanes take the next ray
//     indices by one atomicAdd, as trace_refilling (megakernel.cu) does. The
//     ring's invariant (a query begins with no copy in flight) makes the
//     reuse of a thread's slots across rays safe.
//   - The block stages the hyper and supercluster boxes in shared memory when
//     they fit; rows and cluster boxes stream through each thread's cp.async
//     ring (Ring<kQueryDepth, kQueryThreads>) after them, so kQueryDepth - 1
//     loads are in flight while one is tested. Ring depth and block size were
//     chosen by a sweep on the card (experiments/query_sweep.py, PERF.md §6);
//     they are K4's own and leave WalkRing (K1 binned, K2) as it is.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"

namespace ptx {
namespace {

constexpr int kQueryDepth = 2;
constexpr int kQueryThreads = 128;
constexpr int kTierFloats = 16384;  // 64 KB of staged tier boxes at most
using QueryRing = Ring<kQueryDepth, kQueryThreads>;

// The counting instance's warp steps ([kQueryStepCols] int64, summed over
// the launch): WarpVisits' slab-test steps and filled-row steps, and at each
// filled-row step the distinct clusters among the warp's active lanes (each
// group of __match_any_sync counted once, by its lowest lane) and the active
// lanes. clusters / row steps is the mean number of clusters whose rows one
// row step tests; a packet walk would make it 1.
constexpr int kQueryStepCols = 4;

struct QuerySteps : WarpVisits {
  int cluster = -1;
  int row_clusters = 0;
  int row_active = 0;
  __device__ __forceinline__ void record(int c) {
    WarpVisits::record(c);
    cluster = c;
  }
  __device__ __forceinline__ void row(float prim) {
    const unsigned active = __activemask();
    WarpVisits::row(prim);
    if (__ballot_sync(active, prim >= 0.0f)) {
      const unsigned same = __match_any_sync(active, cluster);
      if (lowest(same)) ++row_clusters;
      if (lowest(active)) row_active += __popc(active);
    }
  }
  // Called by every lane of the warp together, after the query loop.
  __device__ __forceinline__ void add(unsigned long long* out) const {
    const int v[kQueryStepCols] = {slab_steps, row_steps, row_clusters, row_active};
#pragma unroll
    for (int c = 0; c < kQueryStepCols; ++c) {
      const unsigned s = __reduce_add_sync(0xffffffffu, static_cast<unsigned>(v[c]));
      if ((threadIdx.x & 31) == 0 && s) atomicAdd(out + c, static_cast<unsigned long long>(s));
    }
  }
};

struct Params {
  const float* origin;
  const float* direction;
  const float* t_lim;
  float* t_out;
  int* p_out;
  int n_rays;
  ClusterTables cl;
  int tier_floats;
  int* visits;               // [ceil(n / 1024), 4] or null
  unsigned long long* steps; // [kQueryStepCols] with visits
  int* next_ray;             // the refill counter, zeroed
};

// Writes ray i's result and counters; the lane is free again.
template <bool kAnyHit, class Count>
__device__ __forceinline__ void finish(const Params& p, const Walk<kAnyHit>& w, Count& count,
                                       int64_t& i) {
  if constexpr (kAnyHit) {
    const bool occluded = w.win >= 0;
    p.t_out[i] = occluded ? 1.0f : -1.0f;
    p.p_out[i] = occluded ? 0 : -1;
  } else {
    const int winner = static_cast<int>(w.prim);
    p.t_out[i] = winner >= 0 ? w.bound : -1.0f;
    p.p_out[i] = winner;
  }
  if constexpr (!std::is_same_v<Count, NoVisits>) {
    add_visits(p.visits, 4, i, 0, count.descends);
    add_visits(p.visits, 4, i, 1, count.records);
    add_visits(p.visits, 4, i, 2, count.slabs);
    add_visits(p.visits, 4, i, 3, count.rows);
    static_cast<Visits&>(count) = Visits{};
  }
  i = -1;
}

template <bool kCount, bool kAnyHit>
__global__ void __launch_bounds__(kQueryThreads) cluster_query_kernel(const Params p) {
  extern __shared__ float smem[];
  ClusterTables cl = p.cl;
  stage_tiers(cl, smem, p.tier_floats);
  __syncthreads();
  QueryRing rows{reinterpret_cast<float4*>(smem + (p.tier_floats + 3) / 4 * 4) + threadIdx.x};
  Walk<kAnyHit> w;
  std::conditional_t<kCount, QuerySteps, NoVisits> count;
  int64_t i = -1;  // this lane's ray; -1 while the lane is free
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  bool more = true;  // warp-uniform: the counter may still hand out rays
  // Every turn, the free lanes take consecutive ray indices by one
  // atomicAdd (trace_refilling's claim, megakernel.cu), then every lane
  // with a ray runs one test of its walk; the warp meets again at the claim.
  for (;;) {
    const bool free_lane = i < 0;
    const unsigned want = __ballot_sync(0xffffffffu, free_lane && more);
    if (want) {
      const int leader = __ffs(want) - 1;
      int first = 0;
      if (static_cast<int>(lane) == leader) first = atomicAdd(p.next_ray, __popc(want));
      first = __shfl_sync(0xffffffffu, first, leader);
      more = first + __popc(want) < p.n_rays;
      if (free_lane) {
        const int64_t j = first + __popc(want & below);
        if (j < p.n_rays) {
          // Ray j; the root gate may end it at once.
          i = j;
          w.start(cl,
                  Ray{p.origin[3 * j], p.origin[3 * j + 1], p.origin[3 * j + 2],
                      p.direction[3 * j], p.direction[3 * j + 1], p.direction[3 * j + 2]},
                  p.t_lim[j]);
          if (w.done()) finish(p, w, count, i);
        }
      }
    }
    // A claim's rays may all end at the root gate: the warp stops only when
    // no lane holds a ray and the counter is spent.
    if (!__any_sync(0xffffffffu, i >= 0)) {
      if (!more) break;
      continue;
    }
    if (i >= 0) {
      w.step(cl, rows, count);
      if (w.done()) finish(p, w, count, i);
    }
  }
  if constexpr (kCount) count.add(p.steps);
}

// Past the 48 KB default, the instance's shared-memory limit is set to the
// size of each launch (an occupancy query at another size may have set it
// since).
template <bool kCount, bool kAnyHit>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(cluster_query_kernel<kCount, kAnyHit>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kCount, bool kAnyHit>
cudaError_t launch(const Params& p, int grid, size_t smem, cudaStream_t stream) {
  const cudaError_t err = allow_smem<kCount, kAnyHit>(smem);
  if (err != cudaSuccess) return err;
  cluster_query_kernel<kCount, kAnyHit><<<grid, kQueryThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kCount, bool kAnyHit>
cudaError_t occupancy(size_t smem, int* blocks) {
  const cudaError_t err = allow_smem<kCount, kAnyHit>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, cluster_query_kernel<kCount, kAnyHit>, kQueryThreads, smem);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches `grid` blocks (the resident
// blocks, kernel_traverse.resident_grid) on `stream`, does not synchronise,
// allocates nothing, returns the launch's cudaError_t. visits: the zeroed
// counters [ceil(n_rays / 1024), 4] int32, or null; steps: the zeroed warp
// steps [4] int64 with visits, else null. next_ray: the zeroed refill
// counter [1] int32. smem_bytes: the block's dynamic shared memory, sized by
// the wrapper (kernel_traverse.kernel_smem_bytes from ptx_walk_layout).
extern "C" int ptx_cluster_query_launch(const float* origin, const float* direction,
                                        const float* t_lim, float* t_out, int* p_out,
                                        int n_rays, const float* rec, int n_rec, int rec_rows,
                                        const float* clb, const float* sup, int n_pages,
                                        const float* hyp, int hyp_rows, const float* root,
                                        int cull, int any_hit, int* visits,
                                        unsigned long long* steps, int* next_ray, int grid,
                                        long long smem_bytes, void* stream) {
  using namespace ptx;
  (void)hyp_rows;
  if (!next_ray || grid < 1 || (visits != nullptr) != (steps != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const ClusterTables cl{rec, n_rec, rec_rows, clb, sup, n_pages, hyp, root, cull};
  const int tiers = n_pages * (kBndCols + kGroup2 * kBndCols);
  const Params p{origin, direction, t_lim, t_out, p_out, n_rays, cl,
                 tiers <= kTierFloats ? tiers : 0, visits, steps, next_ray};
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (any_hit)
    err = visits ? launch<true, true>(p, grid, smem, s) : launch<false, true>(p, grid, smem, s);
  else
    err = visits ? launch<true, false>(p, grid, smem, s) : launch<false, false>(p, grid, smem, s);
  return static_cast<int>(err);
}

// Resident blocks per SM of the plain (count = 0) or counting, nearest
// (any_hit = 0) or any-hit instance at `smem_bytes`, and its threads per
// block.
extern "C" int ptx_cluster_query_occupancy(int count, int any_hit, long long smem_bytes,
                                           int* blocks, int* threads) {
  using namespace ptx;
  *threads = kQueryThreads;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err;
  if (any_hit)
    err = count ? occupancy<true, true>(smem, blocks) : occupancy<false, true>(smem, blocks);
  else
    err = count ? occupancy<true, false>(smem, blocks) : occupancy<false, false>(smem, blocks);
  return static_cast<int>(err);
}

// K4's shared-memory layout (accel/kernel_traverse.py walk_layout("cluster_query")):
// threads a block, ring slots a thread, bytes a slot, the most tier floats
// staged. The block holds the staged tiers (when they fit), then at the next
// 16-byte boundary the rings.
extern "C" int ptx_walk_layout(int* threads, int* depth, int* slot_bytes, int* tier_floats) {
  *threads = ptx::kQueryThreads;
  *depth = ptx::kQueryDepth;
  *slot_bytes = ptx::kRingSlotBytes;
  *tier_floats = ptx::kTierFloats;
  return 0;
}
