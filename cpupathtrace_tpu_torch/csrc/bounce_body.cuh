// One bounce of the path-trace estimator for one ray: the body shared by the
// megakernel's loop (K1, megakernel.cu) and the single-bounce kernel (K2,
// bounce.cu), so the two cannot drift.
//
// Port of the `body` of `_make_megakernel`
// (cpupathtrace_tpu/integrator/pallas_megakernel.py:412-876): nearest hit,
// material, emission, roulette, NEE over the point lights and `em_k`
// CDF-drawn emitters with shadow rays, then the BSDF sample (Lambertian,
// Fresnel glass, mirror). The geometry is a policy `Geo` with
//   void nearest(const Ray&, Hit&) const;
//   bool occluded(const Ray& shadow_ray, float t_max) const;  // t_max = dist - eps
// so the dense tables (K1) and the dense part + cluster traversal (K2) share
// every other line. Same float32 operations in the same order as the torch
// twin (integrator/megakernel.py `_bounce`), built with --fmad=false; the
// same random stream and draw order: u_rt, (rsel, u1, u2) per emitter draw,
// (u1, u2, ub).
//
// A record policy `Rec` (K2's record form) takes the per-bounce quantities
// the differentiable replay needs (pallas_megakernel.py:485-489, 581-586,
// 711-712, 737-738, 851-862): the hit material and emission weight, each
// NEE weight, each emitter draw's CDF row, and the chain selector. With
// NoRecords every call is empty and the body is the plain one. Records
// writes each plane of a live ray exactly once, the no-contribution
// encoding (mid -1, all else 0) where the bounce leaves it, so no fill
// precedes the kernel.
#pragma once

#include <stdint.h>

#include "dense_intersect.cuh"
#include "rng.cuh"

namespace ptx {

constexpr float kPdCutoff = 1e-20f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr int kMatCols = 12;  // diffuse specular ior emission bsdf one_way
constexpr int kLgtCols = 8;   // pos spectrum
constexpr int kEmCols = 24;   // cdf sel_p is_sph v0 e1 e2 normal pd_area cull emission
constexpr float kBsdfGlass = 1.0f, kBsdfMirror = 2.0f;

// Material, light and emitter tables (shared memory) and the ray offset.
struct Shading {
  const float* mat;
  int n_mat;
  const float* lgt;
  int n_lights;
  const float* em;
  int n_em;
  int em_k;
  float eps;
};

// A path's state between bounces (pallas_megakernel.py STATE_FIELDS).
struct PathState {
  uint32_t rng;
  Ray ray;
  float sr, sg, sb;
  float out_r, out_g, out_b;
  float divisor, bounce_pd, contrib;
  bool collected;
};

__device__ __forceinline__ void skip_draws(uint32_t& rng, int n) {
  for (int k = 0; k < n; ++k) next_u01(rng);
}

// CDF lower bound (ref: scene.cpp:238-257); the last row when above.
__device__ __forceinline__ int cdf_row(const Shading& sh, float rsel) {
  for (int e = 0; e < sh.n_em; ++e)
    if (rsel <= sh.em[e * kEmCols]) return e;
  return sh.n_em - 1;
}

// The record policy of the plain body.
struct NoRecords {
  static constexpr bool kOn = false;
  __device__ __forceinline__ void hit(int, float) const {}
  __device__ __forceinline__ void light(int, float) const {}
  __device__ __forceinline__ void emitter_row(int, int) const {}
  __device__ __forceinline__ void emitter_weight(int, float) const {}
  __device__ __forceinline__ void chain(float) const {}
  __device__ __forceinline__ void none(int) const {}
};

// K2's record planes of one ray (pallas_megakernel.py n_diff_records, in
// diff_megakernel.py:891-895's order): mid, W, sel, one weight per point
// light, then (CDF row, weight) per emitter draw, each a plane of `stride`
// floats. The body writes every plane of a live ray once; `none` writes the
// no-contribution encoding of a ray dead on entry.
struct Records {
  static constexpr bool kOn = true;
  float* p;  // plane 0 of this ray
  int64_t stride;
  int n_lights;
  __device__ __forceinline__ void hit(int mid, float w) const {
    p[0] = static_cast<float>(mid);
    p[stride] = w;
  }
  __device__ __forceinline__ void light(int li, float w) const { p[(3 + li) * stride] = w; }
  __device__ __forceinline__ void emitter_row(int k, int row) const {
    p[(3 + n_lights + 2 * k) * stride] = static_cast<float>(row);
  }
  __device__ __forceinline__ void emitter_weight(int k, float w) const {
    p[(4 + n_lights + 2 * k) * stride] = w;
  }
  // 0 = no advance, 1 = diffuse, 2 = specular, 3 = ones.
  __device__ __forceinline__ void chain(float code) const { p[2 * stride] = code; }
  // mid -1, all else 0 (sorted_wavefront.py clear_records).
  __device__ __forceinline__ void none(int em_k) const {
    p[0] = -1.0f;
    const int planes = 3 + n_lights + 2 * em_k;
    for (int j = 1; j < planes; ++j) p[j * stride] = 0.0f;
  }
};

// One bounce of path `s` at loop index `depth`; returns true while the path
// goes on. kSingle (K2): where the path ends, the random stream still
// advances by the draws the TPU's single-bounce body makes for every live
// ray, so a kernel's rng plane equals the TPU's and the twin's.
template <bool kSingle, class Geo, class Rec = NoRecords>
__device__ __forceinline__ bool bounce_body(const Geo& geo, const Shading& sh, int depth,
                                            PathState& s, const Rec& rec = Rec{}) {
  const float eps = sh.eps;
  // ---- Nearest hit ----
  Hit h = no_hit();
  geo.nearest(s.ray, h);
  // A miss ends the path: from here on the TPU kernel changes nothing.
  if (h.prim < 0) {
    if (Rec::kOn) {
      // The TPU body draws every emitter's CDF row on a live lane; the
      // other planes take the no-contribution encoding.
      rec.hit(-1, 0.0f);
      rec.chain(0.0f);
      for (int li = 0; li < sh.n_lights; ++li) rec.light(li, 0.0f);
      next_u01(s.rng);
      for (int k = 0; k < sh.em_k; ++k) {
        rec.emitter_row(k, cdf_row(sh, next_u01(s.rng)));
        rec.emitter_weight(k, 0.0f);
        skip_draws(s.rng, 2);
      }
      skip_draws(s.rng, 3);
    } else if (kSingle) {
      skip_draws(s.rng, 1 + 3 * sh.em_k + 3);
    }
    return false;
  }
  s.collected = true;
  const float nx = h.nx, ny = h.ny, nz = h.nz;
  const float pxp = s.ray.ox + s.ray.dx * h.t;
  const float pyp = s.ray.oy + s.ray.dy * h.t;
  const float pzp = s.ray.oz + s.ray.dz * h.t;

  float m[kMatCols];
  const bool mat_ok = h.mat >= 0 && h.mat < sh.n_mat;
#pragma unroll
  for (int c = 0; c < kMatCols; ++c) m[c] = mat_ok ? sh.mat[h.mat * kMatCols + c] : 0.0f;
  const float md_r = m[0], md_g = m[1], md_b = m[2];
  const float ms_r = m[3], ms_g = m[4], ms_b = m[5];
  const float ior = m[6];
  const bool one_way = m[11] > 0.5f;
  const bool is_glass = m[10] == kBsdfGlass;
  const bool is_mirror = m[10] == kBsdfMirror;
  const bool is_spec = is_glass || is_mirror;

  const float sr = s.sr, sg = s.sg, sb = s.sb;
  const float divisor0 = s.divisor, bounce_pd0 = s.bounce_pd;

  // ---- Emission ----
  const float weight = 1.0f / (divisor0 * bounce_pd0);
  rec.hit(h.mat, weight);
  s.out_r = s.out_r + sr * m[7] * weight;
  s.out_g = s.out_g + sg * m[8] * weight;
  s.out_b = s.out_b + sb * m[9] * weight;

  // ---- Russian roulette (ref: worker.cpp:67-70) ----
  float bpv = 1.0f;
  if (depth + 1 > 4) {
    const float mean_s = (sr + sg + sb) / 3.0f;
    bpv = 0.1f + 0.1f * jmin(s.contrib * mean_s, 1.0f);
  }
  const float u_rt = next_u01(s.rng);
  const bool do_bounce = u_rt < bpv;

  // ---- Next-event estimation (specular BSDFs opt out) ----
  // Returns the light's detached weight (0 when it adds nothing).
  auto nee = [&](float lx, float ly, float lz, float ls_r, float ls_g, float ls_b, float lpd,
                 bool lvalid) -> float {
    if (is_spec || !lvalid || !(lpd > 0.0f)) return 0.0f;
    const float tlx = lx - pxp, tly = ly - pyp, tlz = lz - pzp;
    const float dist2 = tlx * tlx + tly * tly + tlz * tlz;
    const float dist = sqrtf(dist2);
    const float inv = 1.0f / jmax(dist, 1e-30f);
    const float ldx = tlx * inv, ldy = tly * inv, ldz = tlz * inv;
    const Ray sray{pxp + ldx * eps, pyp + ldy * eps, pzp + ldz * eps, ldx, ldy, ldz};
    if (geo.occluded(sray, dist - eps)) return 0.0f;
    const float cos_s = jmax(nx * ldx + ny * ldy + nz * ldz, 0.0f);
    const float shade = cos_s / kPi;
    const float w = shade / (divisor0 * bounce_pd0 * lpd);
    s.out_r = s.out_r + w * md_r * ls_r * sr;
    s.out_g = s.out_g + w * md_g * ls_g * sg;
    s.out_b = s.out_b + w * md_b * ls_b * sb;
    return w;
  };

  for (int li = 0; li < sh.n_lights; ++li) {
    const float* q = sh.lgt + li * kLgtCols;
    rec.light(li, nee(q[0], q[1], q[2], q[3], q[4], q[5], 1.0f, true));
  }

  for (int k = 0; k < sh.em_k; ++k) {
    // Drawn for every lane, specular or not, to keep the stream in step.
    const float rsel = next_u01(s.rng);
    const float u1 = next_u01(s.rng);
    const float u2 = next_u01(s.rng);
    const int row = cdf_row(sh, rsel);
    rec.emitter_row(k, row);
    if (is_spec) {
      rec.emitter_weight(k, 0.0f);
      continue;
    }
    const float* q = sh.em + row * kEmCols;
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
    rec.emitter_weight(k, nee(spx, spy, spz, q[17], q[18], q[19], lpd, lvalid));
  }

  // ---- Roulette bookkeeping (ref: worker.cpp:106-110) ----
  s.bounce_pd = do_bounce ? bounce_pd0 * bpv : bounce_pd0 * (1.0f - bpv);
  if (!(do_bounce && s.bounce_pd > kPdCutoff)) {
    rec.chain(0.0f);
    if (kSingle) skip_draws(s.rng, 3);
    return false;
  }

  // ---- Propagate (ref: propagation.cpp) ----
  const float u1 = next_u01(s.rng);
  const float u2 = next_u01(s.rng);
  const float ub = next_u01(s.rng);
  const float dx = s.ray.dx, dy = s.ray.dy, dz = s.ray.dz;
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
    rec.chain(same_side ? 2.0f : 1.0f);
    if (same_side) {
      mult_r = ms_r;
      mult_g = ms_g;
      mult_b = ms_b;
    }
  } else if (is_mirror) {
    const bool mm = !one_way || same_side;
    rec.chain(mm ? 2.0f : 3.0f);
    mult_r = mm ? ms_r : 1.0f;
    mult_g = mm ? ms_g : 1.0f;
    mult_b = mm ? ms_b : 1.0f;
  } else {
    rec.chain(1.0f);
    const float cos_n = jmax(nx * ndx + ny * ndy + nz * ndz, 0.0f);
    shading = cos_n / kPi;
  }
  s.divisor = divisor0 * (ray_pd / jmax(ray_factor, 1e-30f)) * (1.0f / jmax(shading, 1e-30f));
  s.contrib = s.contrib * ray_factor * shading;
  s.sr = mult_r * sr;
  s.sg = mult_g * sg;
  s.sb = mult_b * sb;
  if (!(s.divisor > kPdCutoff)) return false;
  s.ray = Ray{pxp + ndx * eps, pyp + ndy * eps, pzp + ndz * eps, ndx, ndy, ndz};
  return true;
}

// Stage `rows` rows of `cols` floats (source row stride `src_stride`) into
// shared memory, all threads of the block cooperating.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int rows, int cols,
                                           int src_stride) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[i] = src[(i / cols) * src_stride + i % cols];
}

}  // namespace ptx
