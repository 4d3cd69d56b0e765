// The kernels' view of a scene: what K1 (megakernel.cu) and K2 (bounce.cu)
// read of it, one struct each kernel's Params embeds by value (kernel
// parameters, in the constant bank). The wrapper fills it once a trace
// (integrator/megakernel.py `kernel_scene`; its ctypes mirror `SceneArgs`
// has these fields in this order) and passes its address to every launch,
// which copies it with `launch_scene`. Also the one shared-memory sizing
// (`smem_floats`) and limit (`allow_smem`) of both kernels' launches.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "binned_geo.cuh"
#include "bounce_body.cuh"
#include "cluster_traverse.cuh"
#include "dense_intersect.cuh"

namespace ptx {

struct SceneArgs {
  const float* tri;  // [n_tri, kTriCols]; n_tri = 0 in the pair form and binned
  int n_tri;
  const float* sph;  // [n_sph, kSphCols]
  int n_sph;
  const float* mat;  // [n_mat, kMatCols]
  int n_mat;
  const float* lgt;  // [>= n_lights, kLgtCols]
  int n_lights;
  const float* em;  // [>= n_em, kEmCols]
  int n_em;
  int em_k;          // emitter draws a vertex
  const float* rec;  // the pair record [rec_rows, rec_stride]; rec_rows = 0 in the table form
  int rec_rows;
  int rec_stride;
  int rec_cull;      // the record's cull class (the instance's CULL); -1 in the table form
  int binned;        // 1: the cluster tiers `cl` follow the record (K3), else unused
  ClusterTables cl;  // binned: the traversal tiers (cl.cull their class)
  int tier_floats;   // shared floats of the staged tiers (0: read from global); set by launch_scene
};

// The launch's copy of the wrapper's scene: the hyper and supercluster boxes
// are staged when they fit kTierFloats (binned_geo.cuh), else read from
// global memory.
inline SceneArgs launch_scene(const SceneArgs& scene) {
  SceneArgs s = scene;
  s.tier_floats = s.binned ? staged_tier_floats(s.cl, kTierFloats) : 0;
  return s;
}

// The floats of a block's staged tables (K1 and K2 alike): the pair record,
// triangle, sphere, material, light and emitter tables, then the tiers; a
// binned block's rings follow at the next 16-byte boundary (ring_base).
__device__ __forceinline__ size_t smem_floats(const SceneArgs& s) {
  return static_cast<size_t>(s.rec_rows) * kRecCols + static_cast<size_t>(s.n_tri) * kTriCols +
         static_cast<size_t>(s.n_sph) * kSphCols + static_cast<size_t>(s.n_mat) * kMatCols +
         static_cast<size_t>(s.n_lights) * kLgtCols + static_cast<size_t>(s.n_em) * kEmCols +
         static_cast<size_t>(s.tier_floats);
}

// Past the 48 KB default, an instance's shared-memory limit is set to the
// size of each launch and occupancy query (never lowered to the default: an
// occupancy query at another size may have set it since).
template <class K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace ptx
