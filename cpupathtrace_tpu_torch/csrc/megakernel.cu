// K1: the path-trace megakernel for Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/integrator/pallas_megakernel.py,
//   `_make_megakernel` in its while-loop form, launched by `_mega_call` /
//   `trace_megakernel` (:1189). Both dense forms (n_super = 0): the
//   pair-record form (1..128 triangles in one Plucker record + the sphere
//   table) and the table form (triangle table + sphere table); and the
//   binned form (n_super > 0, template flag kBinned): spheres, the
//   big-partition pair record, then the cluster set through the traversal
//   K3 (binned_geo.cuh, the geometry K2 uses), with the hyper and
//   supercluster boxes staged in shared memory beside the other tables.
//
// What bounds it on this card: not memory. A path reads its ray (24 bytes)
// and writes its spectrum (16 bytes), ~40 bytes of HBM traffic for up to
// max_depth bounces. Each bounce is a few hundred flops per record row
// tested (nearest hit, one shadow ray per point light and per emitter draw)
// in loops whose every iteration reads a table row, so the kernel is bound
// by the issue of those loops' loads and float32 operations (built with
// --fmad=false, no FMA is issued: the float32 units reach half the FMA
// peak) and by divergence: lanes of a warp end their paths at different
// depths (roulette, misses) and take different BSDF branches.
//
// What the design does about it: one thread per path with the whole path
// state in registers (the per-bounce body is bounce_body.cuh, shared with
// the single-bounce kernel K2); every table (pair record, triangles,
// spheres, materials, lights, emitters) staged once per resident block in
// shared memory, where all lanes read the same row at the same time (a
// broadcast, no bank conflicts), each pair-record row in 16-byte loads
// (dense_intersect.cuh load_row); only the chosen BSDF branch is computed;
// shadow rays stop at the first occluder. Both forms run on refilling
// persistent warps (trace_refilling): the grid is only the resident blocks
// (SMs x occupancy, sized by the wrapper), and a lane whose path ends takes
// the next ray index from a global counter (one warp-aggregated atomicAdd
// per refill, over the lanes that are free), so a warp keeps its lanes
// busy instead of running as long as its longest path while its other
// lanes idle (the box's paths end after 3 to 7 bounces). Each ray is seeded
// from its own index and writes its own spectrum row (and counter row), so
// the results do not depend on which lane traced it.
//
// Parity with the TPU kernel and with the torch twin
// (cpupathtrace_tpu_torch/integrator/megakernel.py): the same arithmetic in
// the same order, built with --fmad=false so no product is fused into an
// add, and the same random stream (rng.cuh) with the same draw order:
// u_rt, then (rsel, u1, u2) per emitter draw, then (u1, u2, ub). The seed
// keys on the TPU's ray block: 64 x 128 rays dense, 8 x 128 binned.
//
// Binned form, what bounds it: the cluster traversal of every nearest and
// shadow query (cluster_traverse.cuh), the latency of its row and box loads
// and the divergence of per-thread descents. Unlike the sorted driver (K2),
// no sort regroups the rays between bounces, so a warp's lanes drift apart
// in the tree as their paths scatter, and they end at different depths
// (a mean of 3.8 bounces a path on the 200k dragon, up to max_depth); in
// exchange a chunk is one launch, with no per-bounce state traffic, glue
// kernels or host reads. The walk is the state machine of
// cluster_traverse.cuh (`Walk`), one box or row test a step; each lane
// steps its own boxes, and the warp tests the rows of the records its
// nearest walks visit together (`walk_together`), one row a lane in rounds.
// Unsorted, the lanes seldom visit the same record at once, so each stream
// mostly serves one lane, but its rows run 32 at a time instead of one. The
// shadow walks test their rows each lane alone (BinnedGeo's kTogether 1):
// with both walks' rounds the plain instance spilled at 96 registers. Each thread
// streams its rows and cluster boxes through its cp.async ring in shared
// memory (kRingDepth - 1 in flight while one is tested), in blocks of
// kWalkThreads (cluster_traverse.cuh).
//
// Counters (template flag kCount). Binned form (the JAX package's
// debug_visits): each thread adds each path's nearest and shadow traversal
// counts to its ray's 1024-ray block's row of `visits` [n_blocks, 9]
// (binned_geo.cuh kGeoVisitCols), and its warp steps to `steps` [3] int64
// (kWarpStepCols). Dense form: `steps` [2] int64 gets the bounce steps the
// warps execute (once per step, by the lowest active lane) and the
// ray-bounces, so lane use = ray-bounces / (32 x steps).
//
// Ablation instances (megakernel_ablate, megakernel_binned_ablate; template
// flag kAblate of the shared bodies): the same kernels with the parts of
// the bounce that the mask `ablate` names taken out (bounce_body.cuh), for
// the JAX package's PTX_ABLATE / PTX_SKIP_TRAVERSE (profiling only). The
// wrapper launches them only while a switch is set; the default instances
// compile none of it.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "binned_geo.cuh"
#include "bounce_body.cuh"
#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"
#include "rng.cuh"
#include "scene_args.cuh"

namespace ptx {
namespace {

// The dense form's block: threads, and the blocks each SM must hold
// (__launch_bounds__'s minimum, which caps the registers). Chosen by the
// sweep of experiments/dense_sweep.py (PERF.md §6).
constexpr int kDenseThreads = 256;
constexpr int kDenseMinBlocks = 3;

struct Params {
  const float* origin;     // [n_rays, 3]
  const float* direction;  // [n_rays, 3]
  float* spectrum;         // [n_rays, 4]: r, g, b, collected
  int n_rays;
  SceneArgs scene;
  const int* seed;  // [1], on the device
  int max_depth;
  int* visits;       // binned: [ceil(n_rays / 1024), 9] traversal counters, or null
  unsigned long long* steps;  // binned [3] warp steps, dense [2] bounce steps (counting), or null
  int* next_ray;     // the refill counter, zeroed by the wrapper
  float eps;
  int ablate;        // the ablation mask (bounce_body.cuh kAblate*); 0 in the default instances
};

// Stages the tables of a block in shared memory (the tiers when binned);
// every thread calls it, then __syncthreads().
template <bool kBinned>
__device__ __forceinline__ ClusterTables stage_tables(const SceneArgs& sc, float* smem) {
  float* s_rec = smem;
  float* s_tri = s_rec + sc.rec_rows * kRecCols;
  float* s_sph = s_tri + sc.n_tri * kTriCols;
  float* s_mat = s_sph + sc.n_sph * kSphCols;
  float* s_lgt = s_mat + sc.n_mat * kMatCols;
  float* s_em = s_lgt + sc.n_lights * kLgtCols;
  stage_rows(s_rec, sc.rec, sc.rec_rows, kRecCols, sc.rec_stride);
  stage_rows(s_tri, sc.tri, sc.n_tri, kTriCols, kTriCols);
  stage_rows(s_sph, sc.sph, sc.n_sph, kSphCols, kSphCols);
  stage_rows(s_mat, sc.mat, sc.n_mat, kMatCols, kMatCols);
  stage_rows(s_lgt, sc.lgt, sc.n_lights, kLgtCols, kLgtCols);
  stage_rows(s_em, sc.em, sc.n_em, kEmCols, kEmCols);
  ClusterTables cl = sc.cl;
  if (kBinned) stage_tiers(cl, s_em + sc.n_em * kEmCols, sc.tier_floats);
  return cl;
}

__device__ __forceinline__ Shading shading(const Params& p, const float* smem) {
  const SceneArgs& sc = p.scene;
  const float* s_mat = smem + sc.rec_rows * kRecCols + sc.n_tri * kTriCols + sc.n_sph * kSphCols;
  const float* s_lgt = s_mat + sc.n_mat * kMatCols;
  const float* s_em = s_lgt + sc.n_lights * kLgtCols;
  return Shading{s_mat, sc.n_mat, s_lgt, sc.n_lights, s_em, sc.n_em, sc.em_k, p.eps};
}

// A fresh path of ray i.
__device__ __forceinline__ void start_path(const Params& p, int64_t i, uint32_t rng,
                                           PathState& s) {
  s.rng = rng;
  s.ray = Ray{p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2],
              p.direction[3 * i], p.direction[3 * i + 1], p.direction[3 * i + 2]};
  s.sr = s.sg = s.sb = 1.0f;
  s.out_r = s.out_g = s.out_b = 0.0f;
  s.divisor = s.bounce_pd = s.contrib = 1.0f;
  s.collected = false;
}

__device__ __forceinline__ void write_spectrum(const Params& p, int64_t i, const PathState& s) {
  reinterpret_cast<float4*>(p.spectrum)[i] =
      make_float4(s.out_r, s.out_g, s.out_b, s.collected ? 1.0f : 0.0f);
}

// The steps of the dense counting instance: a step is one bounce that the
// lanes of a warp execute together, counted by the lowest of them; each
// lane also counts its ray-bounces. NoSteps builds the plain instances.
struct NoSteps {
  __device__ __forceinline__ void step() {}
  __device__ __forceinline__ void add(unsigned long long*) const {}
};

struct BounceSteps {
  unsigned steps = 0;
  unsigned bounces = 0;
  __device__ __forceinline__ void step() {
    ++bounces;
    if (WarpVisits::lowest(__activemask())) ++steps;
  }
  // Called by every lane of the warp together, after the path loop.
  __device__ __forceinline__ void add(unsigned long long* out) const {
    const unsigned s = __reduce_add_sync(0xffffffffu, steps);
    const unsigned b = __reduce_add_sync(0xffffffffu, bounces);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(out, static_cast<unsigned long long>(s));
      atomicAdd(out + 1, static_cast<unsigned long long>(b));
    }
  }
};

// Traces the rays [0, n_rays) on refilling persistent warps, the loop of
// both forms: a free lane takes the next ray index from p.next_ray (the
// warp's free lanes take consecutive indices by one atomicAdd), seeds it
// from its index in blocks of kRows x 128 rays, and runs the bounce body
// until the path ends or max_depth; then it writes the ray's spectrum row,
// calls end(i) and is free again. step() runs before each bounce. Every
// lane of the warp must call it; it returns when the counter is spent and
// no lane of the warp holds a path.
template <int kRows, bool kAblate, class Geo, class Step, class End>
__device__ __forceinline__ void trace_refilling(const Params& p, const Geo& geo,
                                                const Shading& sh, Step step, End end) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int64_t i = -1;  // this lane's ray; -1 while the lane is free
  int depth = 0;
  bool more = true;  // warp-uniform: the counter may still hand out rays
  PathState s;
  for (;;) {
    // Refill: the free lanes take consecutive indices by one atomicAdd.
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
          i = j;
          depth = 0;
          start_path(p, i, seed_rng<kRows>(*p.seed, i), s);
        }
      }
    }
    if (!__any_sync(0xffffffffu, i >= 0)) break;
    if (i < 0) continue;
    // One bounce of this lane's path; at its end the lane writes its ray's
    // results and becomes free.
    if (depth < p.max_depth) {
      step();
      if (bounce_body<false, kAblate>(geo, sh, depth, s) && ++depth < p.max_depth) continue;
    }
    write_spectrum(p, i, s);
    end(i);
    i = -1;
  }
}

// The shading tables of a block: an ablation instance's under its mask
// (bounce_body.cuh), else the scene's.
template <bool kAblate>
__device__ __forceinline__ Shading block_shading(const Params& p, const float* smem) {
  if constexpr (kAblate)
    return ablated_shading(shading(p, smem), p.ablate);
  else
    return shading(p, smem);
}


// The dense form. CULL: the cull class of the pair record; kCount: the
// bounce steps; kAblate: the ablation instance.
template <int CULL, bool kCount, bool kAblate>
__device__ __forceinline__ void dense_form(const Params& p) {
  extern __shared__ float smem[];
  const SceneArgs& sc = p.scene;
  stage_tables<false>(sc, smem);
  __syncthreads();

  const Shading sh = block_shading<kAblate>(p, smem);
  const float* s_rec = smem;
  const float* s_tri = s_rec + sc.rec_rows * kRecCols;
  const float* s_sph = s_tri + sc.n_tri * kTriCols;
  const DenseGeo<CULL> geo{s_rec, pair_rows<kAblate>(sc.rec_rows, p.ablate), s_tri, sc.n_tri,
                           s_sph, sc.n_sph};
  std::conditional_t<kCount, BounceSteps, NoSteps> steps;
  trace_refilling<kBlockRows, kAblate>(p, geo, sh, [&] { steps.step(); }, [](int64_t) {});
  steps.add(p.steps);
}

template <int CULL, bool kCount>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks) megakernel(const Params p) {
  dense_form<CULL, kCount, false>(p);
}

template <int CULL, bool kCount>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
    megakernel_ablate(const Params p) {
  dense_form<CULL, kCount, true>(p);
}

// The binned form. CULL: the cull class of the big partition's pair record;
// kCount: the traversal counters; kAblate: the ablation instance.
template <int CULL, bool kCount, bool kAblate>
__device__ __forceinline__ void binned_form(const Params& p) {
  extern __shared__ float smem[];
  const SceneArgs& sc = p.scene;
  const ClusterTables cl = stage_tables<true>(sc, smem);
  __syncthreads();

  const Shading sh = block_shading<kAblate>(p, smem);
  const float* s_rec = smem;
  const float* s_sph = s_rec + sc.rec_rows * kRecCols + sc.n_tri * kTriCols;
  using Count = std::conditional_t<kCount, WarpVisits, NoVisits>;
  const BinnedGeo<CULL, Count, kAblate, 1> geo{s_rec, pair_rows<kAblate>(sc.rec_rows, p.ablate),
                                            s_sph, sc.n_sph, cl,
                                            ring_base(smem, smem_floats(sc)), {}, {},
                                            !(kAblate && (p.ablate & kSkipTraverse))};
  trace_refilling<kBinnedBlockRows, kAblate>(p, geo, sh, [] {}, [&](int64_t i) {
    if constexpr (kCount) {
      add_geo_visits(p.visits, i, geo);
      static_cast<Visits&>(geo.near) = Visits{};
      static_cast<Visits&>(geo.shadow) = Visits{};
    }
  });
  if constexpr (kCount) add_warp_steps(p.steps, geo);
}

template <int CULL, bool kCount>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
    megakernel_binned(const Params p) {
  binned_form<CULL, kCount, false>(p);
}

template <int CULL, bool kCount>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
    megakernel_binned_ablate(const Params p) {
  binned_form<CULL, kCount, true>(p);
}

template <bool kBinned, int CULL, bool kCount, bool kAblate>
constexpr auto kernel_of() {
  if constexpr (kBinned && kAblate)
    return megakernel_binned_ablate<CULL, kCount>;
  else if constexpr (kBinned)
    return megakernel_binned<CULL, kCount>;
  else if constexpr (kAblate)
    return megakernel_ablate<CULL, kCount>;
  else
    return megakernel<CULL, kCount>;
}

template <bool kBinned>
constexpr int kThreadsOf = kBinned ? kWalkThreads : kDenseThreads;

// Resident blocks per SM of an instance at `smem` bytes.
template <bool kBinned, int CULL, bool kCount, bool kAblate>
cudaError_t occupancy(size_t smem, int* blocks) {
  const auto kernel = kernel_of<kBinned, CULL, kCount, kAblate>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreadsOf<kBinned>,
                                                       smem);
}

// A launch on `grid` blocks, which the wrapper sizes to the resident blocks
// (megakernel.py resident_grid). Any grid is correct, since the warps claim
// the rays; only the speed depends on it.
template <bool kBinned, int CULL, bool kCount, bool kAblate>
cudaError_t launch(const Params& p, int grid, size_t smem, cudaStream_t stream) {
  const auto kernel = kernel_of<kBinned, CULL, kCount, kAblate>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreadsOf<kBinned>, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBinned, bool kCount, bool kAblate>
cudaError_t launch_cull(const Params& p, int cull, int grid, size_t smem, cudaStream_t stream) {
  if (cull == 0) return launch<kBinned, 0, kCount, kAblate>(p, grid, smem, stream);
  if (cull == 1) return launch<kBinned, 1, kCount, kAblate>(p, grid, smem, stream);
  return launch<kBinned, -1, kCount, kAblate>(p, grid, smem, stream);
}

template <bool kBinned, bool kAblate>
cudaError_t launch_form(const Params& p, int cull, int grid, size_t smem, cudaStream_t stream) {
  return p.steps ? launch_cull<kBinned, true, kAblate>(p, cull, grid, smem, stream)
                 : launch_cull<kBinned, false, kAblate>(p, cull, grid, smem, stream);
}

template <bool kBinned, bool kCount, bool kAblate>
cudaError_t occupancy_cull(int cull, size_t smem, int* blocks) {
  if (cull == 0) return occupancy<kBinned, 0, kCount, kAblate>(smem, blocks);
  if (cull == 1) return occupancy<kBinned, 1, kCount, kAblate>(smem, blocks);
  return occupancy<kBinned, -1, kCount, kAblate>(smem, blocks);
}

template <bool kBinned, bool kAblate>
cudaError_t occupancy_form(int cull, bool count, size_t smem, int* blocks) {
  return count ? occupancy_cull<kBinned, true, kAblate>(cull, smem, blocks)
               : occupancy_cull<kBinned, false, kAblate>(cull, smem, blocks);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
// scene: the kernels' scene (scene_args.cuh; binned = 0 a dense scene, whose
// pair record or triangle table it holds, binned = 1 with the cluster tiers;
// rec_cull picks the instance). visits: binned, the zeroed counters
// [ceil(n_rays / 1024), 9] int32 or null; steps: the zeroed warp steps [3]
// int64 with visits (binned), or the bounce steps [2] int64 of the dense
// counting instance, or null. next_ray: the zeroed refill counter [1] int32.
// grid: the blocks of the launch (the resident blocks, at most one thread
// per ray). smem_bytes: the block's dynamic shared memory, sized by the
// wrapper (megakernel.py KernelScene.smem_bytes, from ptx_walk_layout).
// ablate: the ablation mask (bounce_body.cuh kAblate*); nonzero launches
// the form's ablation instance.
extern "C" int ptx_megakernel_launch(const ptx::SceneArgs* scene, const float* origin,
                                     const float* direction, float* spectrum, int n_rays,
                                     int* visits, unsigned long long* steps, int* next_ray,
                                     const int* seed, int max_depth, float epsilon, int grid,
                                     long long smem_bytes, int ablate, void* stream) {
  using namespace ptx;
  if (!scene || !next_ray || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  const bool binned = scene->binned;
  if (binned ? (visits != nullptr) != (steps != nullptr) : visits != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{origin, direction, spectrum, n_rays, launch_scene(*scene), seed, max_depth,
                 visits, steps, next_ray, epsilon, ablate};
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cull = scene->rec_cull;
  cudaError_t err;
  if (binned)
    err = ablate ? launch_form<true, true>(p, cull, grid, smem, s)
                 : launch_form<true, false>(p, cull, grid, smem, s);
  else
    err = ablate ? launch_form<false, true>(p, cull, grid, smem, s)
                 : launch_form<false, false>(p, cull, grid, smem, s);
  return static_cast<int>(err);
}

// Resident blocks per SM of the instance (binned, cull, count, ablation
// instance) at `smem_bytes`, and its threads per block.
extern "C" int ptx_megakernel_occupancy(int binned, int cull, int count, int ablate,
                                        long long smem_bytes, int* blocks, int* threads) {
  using namespace ptx;
  const size_t smem = static_cast<size_t>(smem_bytes);
  cudaError_t err;
  if (binned) {
    *threads = kThreadsOf<true>;
    err = ablate ? occupancy_form<true, true>(cull, count, smem, blocks)
                 : occupancy_form<true, false>(cull, count, smem, blocks);
  } else {
    *threads = kThreadsOf<false>;
    err = ablate ? occupancy_form<false, true>(cull, count, smem, blocks)
                 : occupancy_form<false, false>(cull, count, smem, blocks);
  }
  return static_cast<int>(err);
}
