// K2: one bounce of the path-trace estimator over carried path state (the
// sorted-wavefront step kernel of binned scenes, and the record-and-replay
// forward of the gradient path) on Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/integrator/sorted_wavefront.py `_bounce_call`
//   (:252), i.e. `_make_megakernel(single_bounce=True)` of
//   pallas_megakernel.py with the in-kernel cluster traversal
//   (`traverse_clusters` / `traverse_clusters_anyhit`, K3, inlined here from
//   cluster_traverse.cuh). The driver is trace_megakernel_sorted in
//   cpupathtrace_tpu_torch/integrator/sorted_wavefront.py, and
//   trace_megakernel_diff in integrator/diff_megakernel.py for the record
//   form; the plain version is sorted_wavefront.py `bounce_reference`.
//
// State: the 18 STATE_FIELDS planes as one [18, n] f32 tensor (rng bit-cast
// from uint32), updated in place: thread i reads and writes column i, so
// loads and stores are coalesced across the warp. The depth comes in on the
// device (seed_depth[1]), so the host hands it over without a sync.
//
// Body: the per-bounce body of the megakernel (bounce_body.cuh, the same
// source as K1), with the geometry of a binned scene (binned_geo.cuh, shared
// with K1's binned form: spheres and the big-partition pair record in shared
// memory, then the cluster set through K3; shadow rays likewise) or of a
// dense scene (K1's DenseGeo: the pair record or the triangle table, and the
// spheres). A dead ray returns at once (the TPU's dead-block skip).
//
// Counters (template flag kCount, binned scenes without records; the JAX
// package's debug_visits): each thread adds its nearest and shadow traversal
// counts to its 1024-ray block's row of `visits` [n_blocks, 9]
// (binned_geo.cuh kGeoVisitCols), and its warp steps to `steps` [2] int64
// (kWarpStepCols).
//
// Record form (template flag kRec; `_make_megakernel(diff_records=True)`):
// n_drec = 3 + n_lights + 2 * em_k more [n] planes. Thread i writes every
// plane of its column i once: a ray dead on entry the replay's
// no-contribution encoding (-1, 0, ...), a live one through the body's
// Records policy (a live ray that misses still gets its drawn CDF rows, as
// on the TPU). So no fill precedes the launch, and the planes' bytes are
// written once.
//
// What bounds it on this card: the cluster traversal (see
// cluster_traverse.cuh): the latency of its row and box loads and divergent
// per-thread descents, plus ~144 bytes of state traffic per live ray per
// bounce. The design keeps every small table in shared memory, walks the
// clusters per thread with per-ray pruning, as the state machine of
// cluster_traverse.cuh (`Walk`, one box or row test a step) that each lane
// steps alone in one flat loop: the card runs the lanes that are in the
// same kind of test together, where the nested loops' lanes ran one after
// another. It streams each thread's rows and cluster boxes through its
// cp.async ring in shared memory (kRingDepth - 1 in flight while one is
// tested), in blocks of kWalkThreads, 20 warps an SM (cluster_traverse.cuh
// kWalkMinBlocks; capped to 24 warps the walk spills and ran slower). It
// relies on the driver's per-bounce sort for coherent warps and for
// packing live rays at the head.
//
// Dense instances (the box through the sorted driver, and the gradient
// pass's record form): no walk; each live thread runs K1's dense geometry,
// whose pair-record rows it reads as 16-byte broadcast loads from shared
// memory (dense_intersect.cuh load_row), in blocks of kDenseThreads with
// kDenseMinBlocks an SM at least: 24 warps at 80 registers, where the
// record form spills 64 bytes; uncapped (96 registers, no spills) it held
// 16 or 20 warps and ran 4-10% slower in the sweep (PERF.md §6).
//
// Ablation instances (bounce_kernel_ablate, bounce_binned_kernel_ablate;
// template flag kAblate): the plain and counting forms with the parts of
// the bounce that the mask `ablate` names taken out (bounce_body.cuh), for
// the JAX package's PTX_ABLATE / PTX_SKIP_TRAVERSE (profiling only). The
// record form has none: the entry point refuses a mask with records, as
// the JAX kernel asserts (pallas_megakernel.py:885).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "binned_geo.cuh"
#include "bounce_body.cuh"
#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"
#include "rng.cuh"

namespace ptx {
namespace {

// The dense instances' block: threads, and the blocks each SM must hold
// (__launch_bounds__'s minimum, which caps the registers). Chosen by the
// sweep of experiments/dense_sweep.py (PERF.md §6).
constexpr int kDenseThreads = 256;
constexpr int kDenseMinBlocks = 3;

struct Params {
  float* state;  // [18, n_rays]
  int n_rays;
  const int* seed_depth;  // [2] on the device: seed, depth
  float* drec;  // [n_drec, n_rays] record planes (record form), else null
  const float* tri;  // dense table form: [n_tri, 24]; n_tri = 0 otherwise
  int n_tri;
  const float* sph;
  int n_sph;
  const float* mat;
  int n_mat;
  const float* lgt;
  int n_lights;
  const float* em;
  int n_em;
  int em_k;
  const float* rec;  // big-partition pair record [rec_rows, rec_stride]
  int rec_rows;
  int rec_stride;
  ClusterTables cl;
  int tier_floats;  // shared floats for the staged tiers (0: read from global)
  int* visits;      // [ceil(n_rays / 1024), 9] traversal counters, or null
  unsigned long long* steps;  // [kWarpStepCols] warp steps (with visits), or null
  float eps;
  int ablate;  // the ablation mask (bounce_body.cuh kAblate*); 0 in the default instances
};

__device__ __forceinline__ size_t smem_floats(const Params& p) {
  return static_cast<size_t>(p.rec_rows) * kRecCols + static_cast<size_t>(p.n_tri) * kTriCols +
         static_cast<size_t>(p.n_sph) * kSphCols +
         static_cast<size_t>(p.n_mat) * kMatCols + static_cast<size_t>(p.n_lights) * kLgtCols +
         static_cast<size_t>(p.n_em) * kEmCols + static_cast<size_t>(p.tier_floats);
}

template <bool kBinned, int CULL, bool kCount, bool kAblate, class Rec>
__device__ __forceinline__ bool run_body(const Params& p, float* smem, const float* s_rec,
                                         const float* s_tri,
                                         const float* s_sph, const ClusterTables& cl,
                                         const Shading& sh, PathState& s, const Rec& rec,
                                         int64_t i) {
  if constexpr (kBinned) {
    using Count = std::conditional_t<kCount, WarpVisits, NoVisits>;
    const BinnedGeo<CULL, Count, kAblate> geo{s_rec, pair_rows<kAblate>(p.rec_rows, p.ablate),
                                              s_sph, p.n_sph, cl,
                                              ring_base(smem, smem_floats(p)), {}, {},
                                              !(kAblate && (p.ablate & kSkipTraverse))};
    const bool alive = bounce_body<true, kAblate>(geo, sh, p.seed_depth[1], s, rec);
    if constexpr (kCount) {
      add_geo_visits(p.visits, i, geo);
      add_warp_steps(p.steps, geo);
    }
    return alive;
  } else {
    const DenseGeo<CULL> geo{s_rec, pair_rows<kAblate>(p.rec_rows, p.ablate), s_tri, p.n_tri,
                             s_sph, p.n_sph};
    return bounce_body<true, kAblate>(geo, sh, p.seed_depth[1], s, rec);
  }
}

// One thread's bounce. kBinned: the geometry; CULL: the cull class of the
// pair record; kRec: the record form; kCount: the traversal counters
// (binned, plain form only); kAblate: the ablation instance (not with kRec).
template <bool kBinned, int CULL, bool kRec, bool kCount, bool kAblate = false>
__device__ __forceinline__ void bounce_thread(const Params& p) {
  extern __shared__ float smem[];
  float* s_rec = smem;
  float* s_tri = s_rec + p.rec_rows * kRecCols;
  float* s_sph = s_tri + p.n_tri * kTriCols;
  float* s_mat = s_sph + p.n_sph * kSphCols;
  float* s_lgt = s_mat + p.n_mat * kMatCols;
  float* s_em = s_lgt + p.n_lights * kLgtCols;
  float* s_tiers = s_em + p.n_em * kEmCols;
  stage_rows(s_rec, p.rec, p.rec_rows, kRecCols, p.rec_stride);
  stage_rows(s_tri, p.tri, p.n_tri, kTriCols, kTriCols);
  stage_rows(s_sph, p.sph, p.n_sph, kSphCols, kSphCols);
  stage_rows(s_mat, p.mat, p.n_mat, kMatCols, kMatCols);
  stage_rows(s_lgt, p.lgt, p.n_lights, kLgtCols, kLgtCols);
  stage_rows(s_em, p.em, p.n_em, kEmCols, kEmCols);
  ClusterTables cl = p.cl;
  if (kBinned) stage_tiers(cl, s_tiers, p.tier_floats);
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  const int64_t n = p.n_rays;
  float* st = p.state + i;
  if (!(st[17 * n] > 0.5f)) {  // dead: the state stays as it is
    if constexpr (kRec) Records{p.drec + i, n, p.n_lights}.none(p.em_k);
    return;
  }

  Shading sh{s_mat, p.n_mat, s_lgt, p.n_lights, s_em, p.n_em, p.em_k, p.eps};
  if constexpr (kAblate) sh = ablated_shading(sh, p.ablate);
  PathState s;
  s.rng = __float_as_uint(st[0]);
  s.ray = Ray{st[n], st[2 * n], st[3 * n], st[4 * n], st[5 * n], st[6 * n]};
  s.sr = st[7 * n];
  s.sg = st[8 * n];
  s.sb = st[9 * n];
  s.out_r = st[10 * n];
  s.out_g = st[11 * n];
  s.out_b = st[12 * n];
  s.divisor = st[13 * n];
  s.bounce_pd = st[14 * n];
  s.contrib = st[15 * n];
  s.collected = st[16 * n] > 0.5f;

  bool alive;
  if constexpr (kRec) {
    static_assert(!kAblate, "the record form has no ablation instance");
    alive = run_body<kBinned, CULL, kCount, false>(p, smem, s_rec, s_tri, s_sph, cl, sh, s,
                                                   Records{p.drec + i, n, p.n_lights}, i);
  } else {
    alive = run_body<kBinned, CULL, kCount, kAblate>(p, smem, s_rec, s_tri, s_sph, cl, sh, s,
                                                     NoRecords{}, i);
  }

  st[0] = __uint_as_float(s.rng);
  st[n] = s.ray.ox;
  st[2 * n] = s.ray.oy;
  st[3 * n] = s.ray.oz;
  st[4 * n] = s.ray.dx;
  st[5 * n] = s.ray.dy;
  st[6 * n] = s.ray.dz;
  st[7 * n] = s.sr;
  st[8 * n] = s.sg;
  st[9 * n] = s.sb;
  st[10 * n] = s.out_r;
  st[11 * n] = s.out_g;
  st[12 * n] = s.out_b;
  st[13 * n] = s.divisor;
  st[14 * n] = s.bounce_pd;
  st[15 * n] = s.contrib;
  st[16 * n] = s.collected ? 1.0f : 0.0f;
  st[17 * n] = alive ? 1.0f : 0.0f;
}

// The dense instances: blocks of kDenseThreads, kDenseMinBlocks an SM at least.
template <int CULL, bool kRec>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks) bounce_kernel(const Params p) {
  bounce_thread<false, CULL, kRec, false>(p);
}

// The binned instances: blocks of kWalkThreads, kWalkMinBlocks an SM at least.
template <int CULL, bool kRec, bool kCount>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks) bounce_binned_kernel(const Params p) {
  bounce_thread<true, CULL, kRec, kCount>(p);
}

// The ablation instances of the dense and binned plain and counting forms.
template <int CULL>
__global__ void __launch_bounds__(kDenseThreads, kDenseMinBlocks)
    bounce_kernel_ablate(const Params p) {
  bounce_thread<false, CULL, false, false, true>(p);
}

template <int CULL, bool kCount>
__global__ void __launch_bounds__(kWalkThreads, kWalkMinBlocks)
    bounce_binned_kernel_ablate(const Params p) {
  bounce_thread<true, CULL, false, kCount, true>(p);
}

template <bool kBinned, int CULL, bool kRec, bool kCount, bool kAblate>
constexpr auto kernel_of() {
  if constexpr (kBinned && kAblate)
    return bounce_binned_kernel_ablate<CULL, kCount>;
  else if constexpr (kBinned)
    return bounce_binned_kernel<CULL, kRec, kCount>;
  else if constexpr (kAblate)
    return bounce_kernel_ablate<CULL>;
  else
    return bounce_kernel<CULL, kRec>;
}

template <bool kBinned, int CULL, bool kRec, bool kCount, bool kAblate>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  const auto kernel = kernel_of<kBinned, CULL, kRec, kCount, kAblate>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int threads = kBinned ? kWalkThreads : kDenseThreads;
  const int blocks = (p.n_rays + threads - 1) / threads;
  kernel<<<blocks, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Resident blocks per SM of an instance at `smem` bytes of dynamic shared
// memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
template <bool kBinned, int CULL, bool kRec, bool kCount, bool kAblate>
cudaError_t occupancy(size_t smem, int* blocks) {
  const auto kernel = kernel_of<kBinned, CULL, kRec, kCount, kAblate>();
  // Only ever raised past the 48 KB default, as launch does: a query must
  // not lower the limit a later launch relies on.
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kBinned ? kWalkThreads : kDenseThreads, smem);
}

template <bool kBinned, bool kRec, bool kCount = false, bool kAblate = false>
cudaError_t launch_cull(const Params& p, int cull, size_t smem, cudaStream_t stream) {
  if (cull == 0) return launch<kBinned, 0, kRec, kCount, kAblate>(p, smem, stream);
  if (cull == 1) return launch<kBinned, 1, kRec, kCount, kAblate>(p, smem, stream);
  return launch<kBinned, -1, kRec, kCount, kAblate>(p, smem, stream);
}

template <bool kBinned, bool kRec, bool kCount = false, bool kAblate = false>
cudaError_t occupancy_cull(int cull, size_t smem, int* blocks) {
  if (cull == 0) return occupancy<kBinned, 0, kRec, kCount, kAblate>(smem, blocks);
  if (cull == 1) return occupancy<kBinned, 1, kRec, kCount, kAblate>(smem, blocks);
  return occupancy<kBinned, -1, kRec, kCount, kAblate>(smem, blocks);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
// binned = 0: a dense scene (rec_rows > 0: the pair form, n_tri = 0; else
// the triangle table), the traversal tables unused. drec: the record planes
// [n_drec, n_rays], every column of which the launch writes, or null.
// visits: the counters [ceil(n_rays / 1024), 9] int32, zeroed by the
// caller, or null (binned scenes without records only); steps: the warp
// steps [2] int64, zeroed by the caller, with visits. smem_bytes: the
// block's dynamic shared memory, sized by the wrapper (kernel_traverse.py
// kernel_smem_bytes, from ptx_walk_layout). ablate: the ablation mask
// (bounce_body.cuh kAblate*); nonzero launches the form's ablation instance,
// and is refused with drec.
extern "C" int ptx_bounce_launch(float* state, int n_rays, const int* seed_depth, float* drec,
                                 const float* tri, int n_tri, const float* sph, int n_sph,
                                 const float* mat, int n_mat, const float* lgt, int n_lights,
                                 const float* em, int n_em, int em_k, const float* rec,
                                 int rec_rows, int rec_stride, int big_cull, int binned,
                                 const float* krec, int n_rec, int krec_rows, const float* clb,
                                 const float* sup, int n_pages, const float* hyp, int hyp_rows,
                                 const float* root, int cl_cull, int* visits,
                                 unsigned long long* steps, float epsilon, long long smem_bytes,
                                 int ablate, void* stream) {
  using namespace ptx;
  (void)hyp_rows;
  const ClusterTables cl{krec, n_rec, krec_rows, clb, sup, n_pages, hyp, root, cl_cull};
  const int tiers = binned ? n_pages * (kBndCols + kGroup2 * kBndCols) : 0;
  const Params p{state, n_rays, seed_depth, drec, tri, n_tri, sph, n_sph, mat, n_mat, lgt,
                 n_lights, em, n_em, em_k, rec, rec_rows, rec_stride, cl,
                 tiers <= kTierFloats ? tiers : 0, visits, steps, epsilon, ablate};
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (visits && (!binned || drec || !steps)) return static_cast<int>(cudaErrorInvalidValue);
  if (ablate && drec) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (ablate)
    err = visits   ? launch_cull<true, false, true, true>(p, big_cull, smem, s)
          : binned ? launch_cull<true, false, false, true>(p, big_cull, smem, s)
                   : launch_cull<false, false, false, true>(p, big_cull, smem, s);
  else if (visits)
    err = launch_cull<true, false, true>(p, big_cull, smem, s);
  else if (binned)
    err = drec ? launch_cull<true, true>(p, big_cull, smem, s)
               : launch_cull<true, false>(p, big_cull, smem, s);
  else
    err = drec ? launch_cull<false, true>(p, big_cull, smem, s)
               : launch_cull<false, false>(p, big_cull, smem, s);
  return static_cast<int>(err);
}

// Resident blocks per SM of the instance (binned, cull, rec, count,
// ablation instance) at `smem_bytes`, and its threads per block.
extern "C" int ptx_bounce_occupancy(int binned, int cull, int rec, int count, int ablate,
                                    long long smem_bytes, int* blocks, int* threads) {
  using namespace ptx;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (count && (!binned || rec)) return static_cast<int>(cudaErrorInvalidValue);
  if (ablate && rec) return static_cast<int>(cudaErrorInvalidValue);
  *threads = binned ? kWalkThreads : kDenseThreads;
  cudaError_t err;
  if (ablate)
    err = count    ? occupancy_cull<true, false, true, true>(cull, smem, blocks)
          : binned ? occupancy_cull<true, false, false, true>(cull, smem, blocks)
                   : occupancy_cull<false, false, false, true>(cull, smem, blocks);
  else if (count)
    err = occupancy_cull<true, false, true>(cull, smem, blocks);
  else if (binned)
    err = rec ? occupancy_cull<true, true>(cull, smem, blocks)
              : occupancy_cull<true, false>(cull, smem, blocks);
  else
    err = rec ? occupancy_cull<false, true>(cull, smem, blocks)
              : occupancy_cull<false, false>(cull, smem, blocks);
  return static_cast<int>(err);
}
