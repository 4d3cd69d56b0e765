// K2: one bounce of the path-trace estimator over carried path state, for
// binned scenes (the sorted-wavefront step kernel) on Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/integrator/sorted_wavefront.py `_bounce_call`
//   (:252), i.e. `_make_megakernel(single_bounce=True)` of
//   pallas_megakernel.py with the in-kernel cluster traversal
//   (`traverse_clusters` / `traverse_clusters_anyhit`, K3, inlined here from
//   cluster_traverse.cuh). The driver is trace_megakernel_sorted in
//   cpupathtrace_tpu_torch/integrator/sorted_wavefront.py; the plain version
//   is its `bounce_reference`.
//
// State: the 18 STATE_FIELDS planes as one [18, n] f32 tensor (rng bit-cast
// from uint32), updated in place: thread i reads and writes column i, so
// loads and stores are coalesced across the warp. The depth comes in on the
// device (seed_depth[1]), so the host hands it over without a sync.
//
// Body: the per-bounce body of the megakernel (bounce_body.cuh, the same
// source as K1), with the geometry of a binned scene: spheres and the
// big-partition pair record in shared memory, then the cluster set through
// K3; shadow rays likewise (dense parts, then any-hit over the clusters).
// A dead ray returns at once (the TPU's dead-block skip).
//
// What bounds it on this card: the cluster traversal (see
// cluster_traverse.cuh): dependent global loads and divergent per-thread
// descents, plus ~152 bytes of state traffic per live ray per bounce. The
// design keeps every small table in shared memory, walks the clusters per
// thread with per-ray pruning, and relies on the driver's per-bounce sort
// for coherent warps and for packing live rays at the head.
#include <cuda_runtime.h>
#include <stdint.h>

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
  float* state;  // [18, n_rays]
  int n_rays;
  const int* seed_depth;  // [2] on the device: seed, depth
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
  float eps;
};

template <int BIG_CULL>
struct BinnedGeo {
  const float* rec;
  int rec_rows;
  const float* sph;
  int n_sph;
  ClusterTables cl;

  __device__ __forceinline__ void nearest(const Ray& r, Hit& h) const {
    sph_nearest(sph, n_sph, 0, r, h);
    pair_nearest<BIG_CULL>(rec, rec_rows, r, h);
    cluster_nearest<true>(cl, r, h);
  }

  __device__ __forceinline__ bool occluded(const Ray& r, float t_max) const {
    if (table_occluded(nullptr, 0, sph, n_sph, r, t_max)) return true;
    if (pair_anyhit<BIG_CULL>(rec, rec_rows, r, jmax(t_max, 0.0f))) return true;
    return cluster_anyhit(cl, r, t_max);
  }
};

size_t smem_floats(const Params& p) {
  return static_cast<size_t>(p.rec_rows) * kRecCols + static_cast<size_t>(p.n_sph) * kSphCols +
         static_cast<size_t>(p.n_mat) * kMatCols + static_cast<size_t>(p.n_lights) * kLgtCols +
         static_cast<size_t>(p.n_em) * kEmCols + static_cast<size_t>(p.tier_floats);
}

template <int BIG_CULL>
__global__ void __launch_bounds__(kThreads) bounce_kernel(const Params p) {
  extern __shared__ float smem[];
  float* s_rec = smem;
  float* s_sph = s_rec + p.rec_rows * kRecCols;
  float* s_mat = s_sph + p.n_sph * kSphCols;
  float* s_lgt = s_mat + p.n_mat * kMatCols;
  float* s_em = s_lgt + p.n_lights * kLgtCols;
  float* s_tiers = s_em + p.n_em * kEmCols;
  stage_rows(s_rec, p.rec, p.rec_rows, kRecCols, p.rec_stride);
  stage_rows(s_sph, p.sph, p.n_sph, kSphCols, kSphCols);
  stage_rows(s_mat, p.mat, p.n_mat, kMatCols, kMatCols);
  stage_rows(s_lgt, p.lgt, p.n_lights, kLgtCols, kLgtCols);
  stage_rows(s_em, p.em, p.n_em, kEmCols, kEmCols);
  ClusterTables cl = p.cl;
  stage_tiers(cl, s_tiers, p.tier_floats);
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;
  const int64_t n = p.n_rays;
  float* st = p.state + i;
  if (!(st[17 * n] > 0.5f)) return;  // dead: nothing changes

  const BinnedGeo<BIG_CULL> geo{s_rec, p.rec_rows, s_sph, p.n_sph, cl};
  const Shading sh{s_mat, p.n_mat, s_lgt, p.n_lights, s_em, p.n_em, p.em_k, p.eps};
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

  const bool alive = bounce_body<true>(geo, sh, p.seed_depth[1], s);

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

template <int BIG_CULL>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bounce_kernel<BIG_CULL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.n_rays + kThreads - 1) / kThreads;
  bounce_kernel<BIG_CULL><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
extern "C" int ptx_bounce_launch(float* state, int n_rays, const int* seed_depth,
                                 const float* sph, int n_sph, const float* mat, int n_mat,
                                 const float* lgt, int n_lights, const float* em, int n_em,
                                 int em_k, const float* rec, int rec_rows, int rec_stride,
                                 int big_cull, const float* krec, int n_rec, int krec_rows,
                                 const float* clb, const float* sup, int n_pages,
                                 const float* hyp, int hyp_rows, const float* root,
                                 int cl_cull, float epsilon, void* stream) {
  using namespace ptx;
  (void)hyp_rows;
  const ClusterTables cl{krec, n_rec, krec_rows, clb, sup, n_pages, hyp, root, cl_cull};
  const int tiers = n_pages * (kBndCols + kGroup2 * kBndCols);
  const Params p{state, n_rays, seed_depth, sph, n_sph, mat, n_mat, lgt, n_lights, em, n_em,
                 em_k, rec, rec_rows, rec_stride, cl, tiers <= kTierFloats ? tiers : 0,
                 epsilon};
  const size_t smem = smem_floats(p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (big_cull == 0) return static_cast<int>(launch<0>(p, smem, s));
  if (big_cull == 1) return static_cast<int>(launch<1>(p, smem, s));
  return static_cast<int>(launch<-1>(p, smem, s));
}
