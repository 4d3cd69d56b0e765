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
// by instruction latency and by divergence: lanes of a warp end their paths
// at different depths (misses, roulette) and take different BSDF branches.
//
// What the design does about it: one thread per ray with the whole path
// state in registers (the per-bounce body is bounce_body.cuh, shared with
// the single-bounce kernel K2); every table (pair record, triangles, spheres,
// materials, lights, emitters) staged once per block in shared memory,
// where all lanes read the same row at the same time (a broadcast, no bank
// conflicts); each thread leaves its loop when its path ends instead of
// waiting for the block; only the chosen BSDF branch is computed; shadow
// rays stop at the first occluder.
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
// kernels or host reads.
//
// Binned form, what the design does about it (megakernel_binned): each
// thread streams its rows and cluster boxes through its cp.async ring in
// shared memory (kRingDepth - 1 in flight while one is tested), in blocks
// of kWalkThreads (cluster_traverse.cuh); and the grid is only the
// resident blocks (SMs x occupancy), whose warps refill: a lane whose path
// ends takes the next ray index from a global counter (one warp-aggregated
// atomicAdd per refill, over the lanes that are free), so a block keeps its
// lanes busy instead of holding its SM slot while its warps empty. Each ray
// is seeded from its own index and writes its own spectrum row and counter
// row, so the results do not depend on which lane traced it.
//
// Counters (template flag kCount, binned form; the JAX package's
// debug_visits): each thread adds each path's nearest and shadow traversal
// counts to its ray's 1024-ray block's row of `visits` [n_blocks, 9]
// (binned_geo.cuh kGeoVisitCols), and its warp steps to `steps` [2] int64
// (kWarpStepCols).
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "binned_geo.cuh"
#include "bounce_body.cuh"
#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"
#include "rng.cuh"

namespace ptx {
namespace {

constexpr int kThreads = 256;

struct Params {
  const float* origin;     // [n_rays, 3]
  const float* direction;  // [n_rays, 3]
  float* spectrum;         // [n_rays, 4]: r, g, b, collected
  int n_rays;
  const float* tri;  // [n_tri, 24]; n_tri = 0 in the pair form
  int n_tri;
  const float* sph;  // [n_sph, 8]
  int n_sph;
  const float* mat;  // [n_mat, 12]
  int n_mat;
  const float* lgt;  // [n_lights, 8]
  int n_lights;
  const float* em;  // [n_em, 24]
  int n_em;
  int em_k;
  const float* rec;  // [rec_rows, rec_stride]; rec_rows = 0 in the table form
  int rec_rows;
  int rec_stride;
  const int* seed;  // [1], on the device
  int max_depth;
  ClusterTables cl;  // binned form: the traversal tiers
  int tier_floats;   // shared floats for the staged tiers (0: read from global)
  int* visits;       // [ceil(n_rays / 1024), 9] traversal counters, or null
  unsigned long long* steps;  // [kWarpStepCols] warp steps (with visits), or null
  int* next_ray;     // binned form: the refill counter, zeroed by the wrapper
  float eps;
};

__device__ __forceinline__ size_t smem_floats(const Params& p) {
  return static_cast<size_t>(p.rec_rows) * kRecCols + static_cast<size_t>(p.n_tri) * kTriCols +
         static_cast<size_t>(p.n_sph) * kSphCols + static_cast<size_t>(p.n_mat) * kMatCols +
         static_cast<size_t>(p.n_lights) * kLgtCols + static_cast<size_t>(p.n_em) * kEmCols +
         static_cast<size_t>(p.tier_floats);
}

// The path loop: the bounce body until the path ends or max_depth.
template <class Geo>
__device__ __forceinline__ void trace_path(const Geo& geo, const Shading& sh, int max_depth,
                                           PathState& s) {
  for (int depth = 0; depth < max_depth; ++depth) {
    if (!bounce_body<false>(geo, sh, depth, s)) break;
  }
}

// Stages the tables of a block in shared memory (the tiers when binned);
// every thread calls it, then __syncthreads().
template <bool kBinned>
__device__ __forceinline__ ClusterTables stage_tables(const Params& p, float* smem) {
  float* s_rec = smem;
  float* s_tri = s_rec + p.rec_rows * kRecCols;
  float* s_sph = s_tri + p.n_tri * kTriCols;
  float* s_mat = s_sph + p.n_sph * kSphCols;
  float* s_lgt = s_mat + p.n_mat * kMatCols;
  float* s_em = s_lgt + p.n_lights * kLgtCols;
  stage_rows(s_rec, p.rec, p.rec_rows, kRecCols, p.rec_stride);
  stage_rows(s_tri, p.tri, p.n_tri, kTriCols, kTriCols);
  stage_rows(s_sph, p.sph, p.n_sph, kSphCols, kSphCols);
  stage_rows(s_mat, p.mat, p.n_mat, kMatCols, kMatCols);
  stage_rows(s_lgt, p.lgt, p.n_lights, kLgtCols, kLgtCols);
  stage_rows(s_em, p.em, p.n_em, kEmCols, kEmCols);
  ClusterTables cl = p.cl;
  if (kBinned) stage_tiers(cl, s_em + p.n_em * kEmCols, p.tier_floats);
  return cl;
}

__device__ __forceinline__ Shading shading(const Params& p, const float* smem) {
  const float* s_mat = smem + p.rec_rows * kRecCols + p.n_tri * kTriCols + p.n_sph * kSphCols;
  const float* s_lgt = s_mat + p.n_mat * kMatCols;
  const float* s_em = s_lgt + p.n_lights * kLgtCols;
  return Shading{s_mat, p.n_mat, s_lgt, p.n_lights, s_em, p.n_em, p.em_k, p.eps};
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

// The dense form; CULL: the cull class of the pair record.
template <int CULL>
__global__ void __launch_bounds__(kThreads) megakernel(const Params p) {
  extern __shared__ float smem[];
  stage_tables<false>(p, smem);
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;

  const Shading sh = shading(p, smem);
  const float* s_rec = smem;
  const float* s_tri = s_rec + p.rec_rows * kRecCols;
  const float* s_sph = s_tri + p.n_tri * kTriCols;
  PathState s;
  start_path(p, i, seed_rng(*p.seed, i), s);
  const DenseGeo<CULL> geo{s_rec, p.rec_rows, s_tri, p.n_tri, s_sph, p.n_sph};
  trace_path(geo, sh, p.max_depth, s);
  write_spectrum(p, i, s);
}

// The binned form on refilling persistent warps. CULL: the cull class of
// the big partition's pair record; kCount: the traversal counters.
template <int CULL, bool kCount>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
    megakernel_binned(const Params p) {
  extern __shared__ float smem[];
  const ClusterTables cl = stage_tables<true>(p, smem);
  __syncthreads();

  const Shading sh = shading(p, smem);
  const float* s_rec = smem;
  const float* s_sph = s_rec + p.rec_rows * kRecCols + p.n_tri * kTriCols;
  using Count = std::conditional_t<kCount, WarpVisits, NoVisits>;
  const BinnedGeo<CULL, Count> geo{s_rec, p.rec_rows, s_sph, p.n_sph, cl,
                                   ring_base(smem, smem_floats(p))};
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
          start_path(p, i, seed_rng<kBinnedBlockRows>(*p.seed, i), s);
        }
      }
    }
    if (!__any_sync(0xffffffffu, i >= 0)) break;
    if (i < 0) continue;
    // One bounce of this lane's path; at its end the lane writes its ray's
    // results and becomes free.
    if (depth < p.max_depth && bounce_body<false>(geo, sh, depth, s) && ++depth < p.max_depth)
      continue;
    write_spectrum(p, i, s);
    if constexpr (kCount) {
      add_geo_visits(p.visits, i, geo);
      static_cast<Visits&>(geo.near) = Visits{};
      static_cast<Visits&>(geo.shadow) = Visits{};
    }
    i = -1;
  }
  if constexpr (kCount) add_warp_steps(p.steps, geo);
}

template <int CULL>
cudaError_t launch_dense(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megakernel<CULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.n_rays + kThreads - 1) / kThreads;
  megakernel<CULL><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Resident blocks per SM of the binned instance at `smem` bytes; past the
// 48 KB default it sets the instance's shared-memory limit to `smem`, which
// a launch at that size needs.
template <int CULL, bool kCount>
cudaError_t binned_occupancy(size_t smem, int* blocks) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(megakernel_binned<CULL, kCount>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, megakernel_binned<CULL, kCount>,
                                                       kWalkThreads, smem);
}

// The binned form's grid: the resident blocks (SMs x occupancy at `smem`),
// at most one thread per ray. The resident count is queried at an
// instance's first launch on a card at a given shared-memory size and then
// kept, so a steady-state launch makes the calls the dense form makes (the
// shared-memory limit, the launch). Any grid would be correct, since the
// warps claim the rays; only the speed depends on the count.
constexpr int kMaxDevices = 64;

template <int CULL, bool kCount>
cudaError_t launch_binned(const Params& p, size_t smem, cudaStream_t stream) {
  static size_t known_smem[kMaxDevices] = {};
  static int resident[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem != known_smem[device]) {
    int per_sm = 0, sms = 0;
    err = binned_occupancy<CULL, kCount>(smem, &per_sm);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident[device] = sms * per_sm;
    known_smem[device] = smem;
  } else if (smem > 48 * 1024) {
    // An occupancy query at another size may have set the limit since.
    err = cudaFuncSetAttribute(megakernel_binned<CULL, kCount>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int64_t one_each = (static_cast<int64_t>(p.n_rays) + kWalkThreads - 1) / kWalkThreads;
  const int blocks = static_cast<int>(std::min<int64_t>(one_each, resident[device]));
  megakernel_binned<CULL, kCount><<<blocks, kWalkThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kCount>
cudaError_t launch_binned_cull(const Params& p, int cull, size_t smem, cudaStream_t stream) {
  if (cull == 0) return launch_binned<0, kCount>(p, smem, stream);
  if (cull == 1) return launch_binned<1, kCount>(p, smem, stream);
  return launch_binned<-1, kCount>(p, smem, stream);
}

template <bool kCount>
cudaError_t binned_occupancy_cull(int cull, size_t smem, int* blocks) {
  if (cull == 0) return binned_occupancy<0, kCount>(smem, blocks);
  if (cull == 1) return binned_occupancy<1, kCount>(smem, blocks);
  return binned_occupancy<-1, kCount>(smem, blocks);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
// binned = 0: a dense scene (rec_rows > 0: the pair form, n_tri = 0; else the
// table form), the traversal tables unused. binned = 1: rec is the big
// partition's pair record (cull_mode its class), krec ... root the cluster
// tiers (cl_cull their class), visits the zeroed counters
// [ceil(n_rays / 1024), 9] int32 or null, steps the zeroed warp steps [2]
// int64 with visits, next_ray the zeroed refill counter [1] int32.
// smem_bytes: the block's dynamic shared memory, sized by the wrapper
// (kernel_traverse.py kernel_smem_bytes, from ptx_walk_layout).
extern "C" int ptx_megakernel_launch(const float* origin, const float* direction,
                                     float* spectrum, int n_rays, const float* tri, int n_tri,
                                     const float* sph, int n_sph, const float* mat, int n_mat,
                                     const float* lgt, int n_lights, const float* em, int n_em,
                                     int em_k, const float* rec, int rec_rows, int rec_stride,
                                     int cull_mode, int binned, const float* krec, int n_rec,
                                     int krec_rows, const float* clb, const float* sup,
                                     int n_pages, const float* hyp, int hyp_rows,
                                     const float* root, int cl_cull, int* visits,
                                     unsigned long long* steps, int* next_ray, const int* seed,
                                     int max_depth, float epsilon, long long smem_bytes,
                                     void* stream) {
  using namespace ptx;
  (void)hyp_rows;
  if (visits && (!binned || !steps)) return static_cast<int>(cudaErrorInvalidValue);
  if (binned && !next_ray) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterTables cl{krec, n_rec, krec_rows, clb, sup, n_pages, hyp, root, cl_cull};
  const int tiers = binned ? n_pages * (kBndCols + kGroup2 * kBndCols) : 0;
  const Params p{origin, direction, spectrum, n_rays, tri, n_tri, sph, n_sph,
                 mat, n_mat, lgt, n_lights, em, n_em, em_k, rec, rec_rows, rec_stride,
                 seed, max_depth, cl, tiers <= kTierFloats ? tiers : 0, visits, steps,
                 next_ray, epsilon};
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (binned)
    err = visits ? launch_binned_cull<true>(p, cull_mode, smem, s)
                 : launch_binned_cull<false>(p, cull_mode, smem, s);
  else if (!rec_rows || cull_mode == -1)
    err = launch_dense<-1>(p, smem, s);
  else
    err = cull_mode == 0 ? launch_dense<0>(p, smem, s) : launch_dense<1>(p, smem, s);
  return static_cast<int>(err);
}

// Resident blocks per SM of the binned instance (cull, count) at
// `smem_bytes`, and its threads per block.
extern "C" int ptx_megakernel_binned_occupancy(int cull, int count, long long smem_bytes,
                                               int* blocks, int* threads) {
  using namespace ptx;
  *threads = kWalkThreads;
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaError_t err = count ? binned_occupancy_cull<true>(cull, smem, blocks)
                                : binned_occupancy_cull<false>(cull, smem, blocks);
  return static_cast<int>(err);
}
