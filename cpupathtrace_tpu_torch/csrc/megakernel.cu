// K1: the dense path-trace megakernel for Hopper (sm_90a).
//
// Replaces: cpupathtrace_tpu/integrator/pallas_megakernel.py,
//   `_make_megakernel` in its while-loop form with n_super = 0, launched by
//   `_mega_call` / `trace_megakernel`. Both dense forms: the pair-record form
//   (1..128 triangles in one Plucker record + the sphere table) and the
//   table form (triangle table + sphere table).
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
// state in registers; every table (pair record, triangles, spheres,
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
// u_rt, then (rsel, u1, u2) per emitter draw, then (u1, u2, ub).
#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_intersect.cuh"
#include "rng.cuh"

namespace ptx {
namespace {

constexpr float kPdCutoff = 1e-20f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kMatCols = 12;  // diffuse specular ior emission bsdf one_way
constexpr int kLgtCols = 8;   // pos spectrum
constexpr int kEmCols = 24;   // cdf sel_p is_sph v0 e1 e2 normal pd_area cull emission
constexpr int kThreads = 256;
constexpr float kBsdfGlass = 1.0f, kBsdfMirror = 2.0f;

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
  float eps;
};

size_t smem_floats(const Params& p) {
  return static_cast<size_t>(p.rec_rows) * kRecCols + static_cast<size_t>(p.n_tri) * kTriCols +
         static_cast<size_t>(p.n_sph) * kSphCols + static_cast<size_t>(p.n_mat) * kMatCols +
         static_cast<size_t>(p.n_lights) * kLgtCols + static_cast<size_t>(p.n_em) * kEmCols;
}

__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int cols,
                                           int src_stride) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[i] = src[(i / cols) * src_stride + i % cols];
}

template <int CULL>
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
  __syncthreads();

  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= p.n_rays) return;

  const float eps = p.eps;
  uint32_t rng = seed_rng(*p.seed, i);
  Ray ray{p.origin[3 * i], p.origin[3 * i + 1], p.origin[3 * i + 2],
          p.direction[3 * i], p.direction[3 * i + 1], p.direction[3 * i + 2]};
  float sr = 1.0f, sg = 1.0f, sb = 1.0f;
  float out_r = 0.0f, out_g = 0.0f, out_b = 0.0f;
  float divisor = 1.0f, bounce_pd = 1.0f, contrib = 1.0f;
  bool collected = false;

  for (int depth = 0; depth < p.max_depth; ++depth) {
    // ---- Nearest hit ----
    Hit h = no_hit();
    if (p.rec_rows) {
      sph_nearest(s_sph, p.n_sph, 0, ray, h);
      pair_nearest<CULL>(s_rec, p.rec_rows, ray, h);
    } else {
      tri_nearest(s_tri, p.n_tri, ray, h);
      sph_nearest(s_sph, p.n_sph, p.n_tri, ray, h);
    }
    // A miss ends the path: from here on the TPU kernel changes nothing.
    if (h.prim < 0) break;
    collected = true;
    const float nx = h.nx, ny = h.ny, nz = h.nz;
    const float pxp = ray.ox + ray.dx * h.t;
    const float pyp = ray.oy + ray.dy * h.t;
    const float pzp = ray.oz + ray.dz * h.t;

    float m[kMatCols];
    const bool mat_ok = h.mat >= 0 && h.mat < p.n_mat;
#pragma unroll
    for (int c = 0; c < kMatCols; ++c) m[c] = mat_ok ? s_mat[h.mat * kMatCols + c] : 0.0f;
    const float md_r = m[0], md_g = m[1], md_b = m[2];
    const float ms_r = m[3], ms_g = m[4], ms_b = m[5];
    const float ior = m[6];
    const bool one_way = m[11] > 0.5f;
    const bool is_glass = m[10] == kBsdfGlass;
    const bool is_mirror = m[10] == kBsdfMirror;
    const bool is_spec = is_glass || is_mirror;

    // ---- Emission ----
    const float weight = 1.0f / (divisor * bounce_pd);
    out_r = out_r + sr * m[7] * weight;
    out_g = out_g + sg * m[8] * weight;
    out_b = out_b + sb * m[9] * weight;

    // ---- Russian roulette (ref: worker.cpp:67-70) ----
    float bpv = 1.0f;
    if (depth + 1 > 4) {
      const float mean_s = (sr + sg + sb) / 3.0f;
      bpv = 0.1f + 0.1f * jmin(contrib * mean_s, 1.0f);
    }
    const float u_rt = next_u01(rng);
    const bool do_bounce = u_rt < bpv;

    // ---- Next-event estimation (specular BSDFs opt out) ----
    auto nee = [&](float lx, float ly, float lz, float ls_r, float ls_g, float ls_b, float lpd,
                   bool lvalid) {
      if (is_spec || !lvalid || !(lpd > 0.0f)) return;
      const float tlx = lx - pxp, tly = ly - pyp, tlz = lz - pzp;
      const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
      const float dist = sqrtf(dist2);
      const float inv = 1.0f / jmax(dist, 1e-30f);
      const float ldx = tlx * inv, ldy = tly * inv, ldz = tlz * inv;
      const Ray sray{pxp + ldx * eps, pyp + ldy * eps, pzp + ldz * eps, ldx, ldy, ldz};
      if (table_occluded(s_tri, p.n_tri, s_sph, p.n_sph, sray, dist - eps)) return;
      if (p.rec_rows && pair_anyhit<CULL>(s_rec, p.rec_rows, sray, jmax(dist - eps, 0.0f)))
        return;
      const float cos_s = jmax(nx * ldx + ny * ldy + nz * ldz, 0.0f);
      const float shade = cos_s / kPi;
      const float w = shade / (divisor * bounce_pd * lpd);
      out_r = out_r + w * md_r * ls_r * sr;
      out_g = out_g + w * md_g * ls_g * sg;
      out_b = out_b + w * md_b * ls_b * sb;
    };

    for (int li = 0; li < p.n_lights; ++li) {
      const float* q = s_lgt + li * kLgtCols;
      nee(q[0], q[1], q[2], q[3], q[4], q[5], 1.0f, true);
    }

    for (int k = 0; k < p.em_k; ++k) {
      // Drawn for every lane, specular or not, to keep the stream in step.
      const float rsel = next_u01(rng);
      const float u1 = next_u01(rng);
      const float u2 = next_u01(rng);
      if (is_spec) continue;
      // CDF lower bound (ref: scene.cpp:238-257); the last row when above.
      int sel = p.n_em - 1;
      for (int e = 0; e < p.n_em; ++e) {
        if (rsel <= s_em[e * kEmCols]) {
          sel = e;
          break;
        }
      }
      const float* q = s_em + sel * kEmCols;
      const float sq = sqrtf(u1);
      const float w2 = sq * (1.0f - u2);
      const float w3 = sq * u2;
      const float theta = kTwoPi * u1;
      const float cphi = 1.0f - 2.0f * u2;
      const float sphi = sqrtf(jmax(1.0f - cphi * cphi, 0.0f));
      const float ux_s = sphi * cosf(theta);
      const float uy_s = sphi * sinf(theta);
      const float uz_s = cphi;
      const bool is_sph = q[2] > 0.5f;
      // Triangle: sqrt-warp sample + face normal; sphere: centre + radius
      // (in e1x) times the unit sample direction.
      float spx, spy, spz, snx, sny, snz;
      if (is_sph) {
        spx = q[3] + q[6] * ux_s;
        spy = q[4] + q[6] * uy_s;
        spz = q[5] + q[6] * uz_s;
        snx = ux_s;
        sny = uy_s;
        snz = uz_s;
      } else {
        spx = q[3] + w2 * q[6] + w3 * q[9];
        spy = q[4] + w2 * q[7] + w3 * q[10];
        spz = q[5] + w2 * q[8] + w3 * q[11];
        snx = q[12];
        sny = q[13];
        snz = q[14];
      }
      const float s_pd = q[1] * q[15];
      const bool cullm = q[16] > 0.5f;
      // Area -> solid angle (ref: scene.cpp:280).
      const float tlx = spx - pxp, tly = spy - pyp, tlz = spz - pzp;
      const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
      const float invd = rsqrtf(jmax(dist2, 1e-30f));
      const float ldx = tlx * invd, ldy = tly * invd, ldz = tlz * invd;
      const float ldn = ldx * snx + ldy * sny + ldz * snz;
      const float adot = fabsf(-ldn);
      const bool lvalid = adot > 0.0f && dist2 > 0.0f && (!cullm || ldn < 0.0f);
      const float lpd = s_pd * dist2 / jmax(adot, 1e-30f);
      nee(spx, spy, spz, q[17], q[18], q[19], lpd, lvalid);
    }

    // ---- Roulette bookkeeping (ref: worker.cpp:106-110) ----
    bounce_pd = do_bounce ? bounce_pd * bpv : bounce_pd * (1.0f - bpv);
    if (!(do_bounce && bounce_pd > kPdCutoff)) break;

    // ---- Propagate (ref: propagation.cpp) ----
    const float u1 = next_u01(rng);
    const float u2 = next_u01(rng);
    const float ub = next_u01(rng);
    const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
    float ndx, ndy, ndz, ray_factor = 1.0f, ray_pd = 1.0f;
    if (is_glass) {
      // Fresnel, unpolarised (ref: propagation.cpp:64-160).
      const float ray_dot = -(dx * nx + dy * ny + dz * nz);
      const bool entering = ray_dot >= 0.0f;
      const float ri_l = entering ? 1.0f : ior;
      const float ri_e = entering ? ior : 1.0f;
      const float adot = fabsf(ray_dot);
      const float sin_i = sqrtf(jmax(1.0f - adot * adot, 0.0f));
      const float sin_t = ri_l / ri_e * sin_i;
      const bool tir = sin_t >= 1.0f;
      float cos_tt = sqrtf(jmax(1.0f - sin_t * sin_t, 0.0f));
      const float r_par = (ri_e * adot - ri_l * cos_tt) / (ri_e * adot + ri_l * cos_tt);
      const float r_perp = (ri_l * adot - ri_e * cos_tt) / (ri_l * adot + ri_e * cos_tt);
      const float rat = tir ? 1.0f : (r_par * r_par + r_perp * r_perp) * 0.5f;
      if (tir) cos_tt = 0.0f;
      const bool refl = ub < rat;
      const float sgn = ray_dot < 0.0f ? -1.0f : 1.0f;
      if (refl) {
        const float ddn = dx * nx * sgn + dy * ny * sgn + dz * nz * sgn;
        ndx = dx - 2.0f * ddn * nx * sgn;
        ndy = dy - 2.0f * ddn * ny * sgn;
        ndz = dz - 2.0f * ddn * nz * sgn;
        ray_factor = rat;
        ray_pd = rat;
      } else {
        const float ratio = ri_l / ri_e;
        const float fx = dx * ratio + nx * (ratio * adot - cos_tt) * sgn;
        const float fy = dy * ratio + ny * (ratio * adot - cos_tt) * sgn;
        const float fz = dz * ratio + nz * (ratio * adot - cos_tt) * sgn;
        const float invf = rsqrtf(fx * fx + fy * fy + fz * fz + 1e-30f);
        ndx = fx * invf;
        ndy = fy * invf;
        ndz = fz * invf;
        const float ri_fac = (ri_e * ri_e) / (ri_l * ri_l);
        ray_factor = ri_fac * (1.0f - rat);
        ray_pd = 1.0f - rat;
      }
    } else if (is_mirror) {
      // (ref: propagation.cpp:180-204)
      const bool unaligned = (dx * nx + dy * ny + dz * nz) > 0.0f;
      if (one_way && unaligned) {
        ndx = dx;
        ndy = dy;
        ndz = dz;
      } else {
        const float msgn = unaligned ? -1.0f : 1.0f;
        const float mdn = dx * nx * msgn + dy * ny * msgn + dz * nz * msgn;
        ndx = dx - 2.0f * mdn * nx * msgn;
        ndy = dy - 2.0f * mdn * ny * msgn;
        ndz = dz - 2.0f * mdn * nz * msgn;
      }
    } else {
      // Lambertian cosine sample in the branch-free tangent frame.
      const float fac = sqrtf(jmax(1.0f - u2, 0.0f));
      const float cos_t = sqrtf(u2);
      const float ang = kTwoPi * u1;
      const float lx_t = fac * cosf(ang);
      const float ly_t = fac * sinf(ang);
      ray_pd = 2.0f * cos_t / kTwoPi;
      const bool has_x = fabsf(nx) > 0.0f;
      const bool has_y = fabsf(ny) > 0.0f;
      float tx = has_x ? 0.0f : (has_y ? -ny : 1.0f);
      float ty = has_x ? -nx : (has_y ? nz : 0.0f);
      float tz = has_x ? (has_y ? ny : nz) : 0.0f;
      const float inv = rsqrtf(tx * tx + ty * ty + tz * tz + 1e-30f);
      tx = tx * inv;
      ty = ty * inv;
      tz = tz * inv;
      float b1x = ty * nz - tz * ny;
      float b1y = tz * nx - tx * nz;
      float b1z = tx * ny - ty * nx;
      const float inv1 = rsqrtf(b1x * b1x + b1y * b1y + b1z * b1z + 1e-30f);
      b1x = b1x * inv1;
      b1y = b1y * inv1;
      b1z = b1z * inv1;
      const float b2x = b1y * nz - b1z * ny;
      const float b2y = b1z * nx - b1x * nz;
      const float b2z = b1x * ny - b1y * nx;
      const float inv2 = rsqrtf(b2x * b2x + b2y * b2y + b2z * b2z + 1e-30f);
      ndx = b1x * lx_t + b2x * inv2 * ly_t + nx * cos_t;
      ndy = b1y * lx_t + b2y * inv2 * ly_t + ny * cos_t;
      ndz = b1z * lx_t + b2z * inv2 * ly_t + nz * cos_t;
    }

    // ---- Bounce eval (non-synthetic getSpectrum) ----
    const bool same_side = (dx * ndx + dy * ndy + dz * ndz) <= 0.0f;
    float mult_r = md_r, mult_g = md_g, mult_b = md_b, shading = 1.0f;
    if (is_glass) {
      if (same_side) {
        mult_r = ms_r;
        mult_g = ms_g;
        mult_b = ms_b;
      }
    } else if (is_mirror) {
      const bool mm = !one_way || same_side;
      mult_r = mm ? ms_r : 1.0f;
      mult_g = mm ? ms_g : 1.0f;
      mult_b = mm ? ms_b : 1.0f;
    } else {
      const float cos_n = jmax(nx * ndx + ny * ndy + nz * ndz, 0.0f);
      shading = cos_n / kPi;
    }
    divisor = divisor * (ray_pd / jmax(ray_factor, 1e-30f)) * (1.0f / jmax(shading, 1e-30f));
    contrib = contrib * ray_factor * shading;
    sr = mult_r * sr;
    sg = mult_g * sg;
    sb = mult_b * sb;
    if (!(divisor > kPdCutoff)) break;
    ray = Ray{pxp + ndx * eps, pyp + ndy * eps, pzp + ndz * eps, ndx, ndy, ndz};
  }

  reinterpret_cast<float4*>(p.spectrum)[i] =
      make_float4(out_r, out_g, out_b, collected ? 1.0f : 0.0f);
}

template <int CULL>
cudaError_t launch(const Params& p, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        megakernel<CULL>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.n_rays + kThreads - 1) / kThreads;
  megakernel<CULL><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ptx

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, allocates nothing, returns the launch's cudaError_t.
extern "C" int ptx_megakernel_launch(const float* origin, const float* direction,
                                     float* spectrum, int n_rays, const float* tri, int n_tri,
                                     const float* sph, int n_sph, const float* mat, int n_mat,
                                     const float* lgt, int n_lights, const float* em, int n_em,
                                     int em_k, const float* rec, int rec_rows, int rec_stride,
                                     int cull_mode, const int* seed, int max_depth,
                                     float epsilon, void* stream) {
  using namespace ptx;
  const Params p{origin, direction, spectrum, n_rays, tri, n_tri, sph, n_sph,
                 mat, n_mat, lgt, n_lights, em, n_em, em_k, rec, rec_rows, rec_stride,
                 seed, max_depth, epsilon};
  const size_t smem = smem_floats(p) * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rec_rows && cull_mode == 0) return static_cast<int>(launch<0>(p, smem, s));
  if (rec_rows && cull_mode == 1) return static_cast<int>(launch<1>(p, smem, s));
  return static_cast<int>(launch<-1>(p, smem, s));
}
