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
// shadow query (cluster_traverse.cuh). Unlike the sorted driver (K2), no
// sort regroups the rays between bounces, so a warp's lanes drift apart in
// the tree as their paths scatter; in exchange a chunk is one launch, with
// no per-bounce state traffic, glue kernels or host reads.
//
// Counters (template flag kCount, binned form; the JAX package's
// debug_visits): each thread adds its path's nearest and shadow traversal
// counts to its 1024-ray block's row of `visits` [n_blocks, 9]
// (binned_geo.cuh kGeoVisitCols).
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

constexpr int kThreads = 256;
// Shared-memory floats the hyper + supercluster boxes may take (64 KB);
// larger tier tables are read from global memory.
constexpr int kTierFloats = 16384;

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
  float eps;
};

size_t smem_floats(const Params& p) {
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

// kBinned: the binned form; CULL: the cull class of the pair record (the big
// partition's when binned); kCount: the traversal counters (binned only).
template <bool kBinned, int CULL, bool kCount>
__global__ void __launch_bounds__(kThreads) megakernel(const Params p) {
  extern __shared__ float smem[];
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
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;

  const Shading sh{s_mat, p.n_mat, s_lgt, p.n_lights, s_em, p.n_em, p.em_k, p.eps};
  PathState s;
  s.ray = Ray{p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2],
              p.direction[3 * i], p.direction[3 * i + 1], p.direction[3 * i + 2]};
  s.sr = s.sg = s.sb = 1.0f;
  s.out_r = s.out_g = s.out_b = 0.0f;
  s.divisor = s.bounce_pd = s.contrib = 1.0f;
  s.collected = false;
  if constexpr (kBinned) {
    using Count = std::conditional_t<kCount, Visits, NoVisits>;
    const BinnedGeo<CULL, Count> geo{s_rec, p.rec_rows, s_sph, p.n_sph, cl};
    s.rng = seed_rng<kBinnedBlockRows>(*p.seed, i);
    trace_path(geo, sh, p.max_depth, s);
    if constexpr (kCount) add_geo_visits(p.visits, i, geo);
  } else {
    const DenseGeo<CULL> geo{s_rec, p.rec_rows, s_tri, p.n_tri, s_sph, p.n_sph};
    s.rng = seed_rng(*p.seed, i);
    trace_path(geo, sh, p.max_depth, s);
  }
  reinterpret_cast<float4*>(p.spectrum)[i] =
      make_float4(s.out_r, s.out_g, s.out_b, s.collected ? 1.0f : 0.0f);
}

template <bool kBinned, int CULL, bool kCount>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(megakernel<kBinned, CULL, kCount>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.n_rays + kThreads - 1) / kThreads;
  megakernel<kBinned, CULL, kCount><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool kBinned, bool kCount>
cudaError_t launch_cull(const Params& p, int cull, size_t smem, cudaStream_t stream) {
  if (cull == 0) return launch<kBinned, 0, kCount>(p, smem, stream);
  if (cull == 1) return launch<kBinned, 1, kCount>(p, smem, stream);
  return launch<kBinned, -1, kCount>(p, smem, stream);
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
// binned = 0: a dense scene (rec_rows > 0: the pair form, n_tri = 0; else the
// table form), the traversal tables unused. binned = 1: rec is the big
// partition's pair record (cull_mode its class), krec ... root the cluster
// tiers (cl_cull their class), visits the zeroed counters
// [ceil(n_rays / 1024), 9] int32 or null.
extern "C" int ptx_megakernel_launch(const float* origin, const float* direction,
                                     float* spectrum, int n_rays, const float* tri, int n_tri,
                                     const float* sph, int n_sph, const float* mat, int n_mat,
                                     const float* lgt, int n_lights, const float* em, int n_em,
                                     int em_k, const float* rec, int rec_rows, int rec_stride,
                                     int cull_mode, int binned, const float* krec, int n_rec,
                                     int krec_rows, const float* clb, const float* sup,
                                     int n_pages, const float* hyp, int hyp_rows,
                                     const float* root, int cl_cull, int* visits,
                                     const int* seed, int max_depth, float epsilon,
                                     void* stream) {
  using namespace ptx;
  (void)hyp_rows;
  if (visits && !binned) return static_cast<int>(cudaErrorInvalidValue);
  const ClusterTables cl{krec, n_rec, krec_rows, clb, sup, n_pages, hyp, root, cl_cull};
  const int tiers = binned ? n_pages * (kBndCols + kGroup2 * kBndCols) : 0;
  const Params p{origin, direction, spectrum, n_rays, tri, n_tri, sph, n_sph,
                 mat, n_mat, lgt, n_lights, em, n_em, em_k, rec, rec_rows, rec_stride,
                 seed, max_depth, cl, tiers <= kTierFloats ? tiers : 0, visits, epsilon};
  const size_t smem = smem_floats(p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (binned)
    err = visits ? launch_cull<true, true>(p, cull_mode, smem, s)
                 : launch_cull<true, false>(p, cull_mode, smem, s);
  else
    err = launch_cull<false, false>(p, rec_rows ? cull_mode : -1, smem, s);
  return static_cast<int>(err);
}
