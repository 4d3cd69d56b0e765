// Dense intersection device functions, one ray per thread, tables in shared
// memory. Ports of _intersect_tables (pallas_megakernel.py:141-234) and of
// pair_test_nearest / pair_test_anyhit / _pair_quantities
// (accel/kernel_traverse.py:405-650) in cpupathtrace_tpu, and the dense
// geometry policy built from them. The megakernel (K1), the single-bounce
// kernel (K2), the cluster records of the traversal (K3) and the dense query
// (K5, tri_scan / sph_scan) use them.
//
// Semantics kept from the TPU kernels:
//  * a primitive wins only by improving strictly on the running nearest t,
//    so among equal t the first row tested wins (lowest record slot);
//  * padding rows miss: table rows carry valid = 0, record rows N = 0
//    (det = 0);
//  * min/max propagate NaN as jnp.minimum / jnp.maximum do.
#pragma once

#include <math.h>

namespace ptx {

constexpr float kTriEps = 1e-6f;
constexpr int kTriCols = 24;  // v0 e1 e2 cull valid n0 n1 n2 mat
constexpr int kSphCols = 8;   // center radius valid mat
constexpr int kRecCols = 28;  // used feature columns of a pair record
constexpr int kRecCull = 16, kRecPrim = 17, kRecMat = 18, kRecN0 = 19;

__device__ __forceinline__ float jmin(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float jmax(float a, float b) { return (a > b || a != a) ? a : b; }

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Hit {
  float t;  // +inf on a miss
  int prim;  // -1 on a miss; table space for spheres
  float nx, ny, nz;  // unit shading normal of the winner
  int mat;
};

__device__ __forceinline__ Hit no_hit() {
  Hit h;
  h.t = INFINITY;
  h.prim = -1;
  h.nx = 0.0f;
  h.ny = 1.0f;
  h.nz = 0.0f;
  h.mat = 0;
  return h;
}

// Moller-Trumbore over triangle-table rows [0, n). Returns the winning row
// (or -1) and its (t, u, v); a row must beat `best_t`.
__device__ __forceinline__ int tri_scan(const float* tri, int n, const Ray& r,
                                        float& best_t, float& bu, float& bv) {
  int best = -1;
  for (int k = 0; k < n; ++k) {
    const float* q = tri + k * kTriCols;
    const float e1x = q[3], e1y = q[4], e1z = q[5];
    const float e2x = q[6], e2y = q[7], e2z = q[8];
    const float px = r.dy * e2z - r.dz * e2y;
    const float py = r.dz * e2x - r.dx * e2z;
    const float pz = r.dx * e2y - r.dy * e2x;
    const float det = e1x * px + e1y * py + e1z * pz;
    const bool is_cull = q[9] > 0.5f;
    const bool miss_det = is_cull ? (det <= kTriEps) : (fabsf(det) <= kTriEps);
    const float inv_det = 1.0f / (miss_det ? 1.0f : det);
    const float tx = r.ox - q[0], ty = r.oy - q[1], tz = r.oz - q[2];
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const bool ok = (q[10] > 0.5f) && !miss_det && u >= 0.0f && u <= 1.0f &&
                    v >= 0.0f && u + v <= 1.0f && t >= 0.0f && t < best_t;
    if (ok) {
      best_t = t;
      best = k;
      bu = u;
      bv = v;
    }
  }
  return best;
}

// Nearest hit over the triangle table; prim = row index.
__device__ __forceinline__ void tri_nearest(const float* tri, int n, const Ray& r, Hit& h) {
  float u = 0.0f, v = 0.0f;
  const int k = tri_scan(tri, n, r, h.t, u, v);
  if (k < 0) return;
  const float* q = tri + k * kTriCols;
  const float w0 = 1.0f - u - v;
  const float snx = w0 * q[11] + u * q[14] + v * q[17];
  const float sny = w0 * q[12] + u * q[15] + v * q[18];
  const float snz = w0 * q[13] + u * q[16] + v * q[19];
  const float inv = rsqrtf(snx * snx + sny * sny + snz * snz + 1e-30f);
  h.prim = k;
  h.nx = snx * inv;
  h.ny = sny * inv;
  h.nz = snz * inv;
  h.mat = static_cast<int>(q[20]);
}

// Near-root sphere test; returns the winning row or -1 (must beat best_t).
__device__ __forceinline__ int sph_scan(const float* sph, int n, const Ray& r, float& best_t) {
  int best = -1;
  for (int k = 0; k < n; ++k) {
    const float* q = sph + k * kSphCols;
    const float cox = r.ox - q[0], coy = r.oy - q[1], coz = r.oz - q[2];
    const float dd = r.dx * cox + r.dy * coy + r.dz * coz;
    const float disc = dd * dd - (cox * cox + coy * coy + coz * coz) + q[3] * q[3];
    const float t = -(dd + sqrtf(jmax(disc, 0.0f)));
    if ((q[4] > 0.5f) && disc >= 0.0f && t >= 0.0f && t < best_t) {
      best_t = t;
      best = k;
    }
  }
  return best;
}

// Nearest hit over the sphere table; prim = row + prim_offset.
__device__ __forceinline__ void sph_nearest(const float* sph, int n, int prim_offset,
                                            const Ray& r, Hit& h) {
  const int k = sph_scan(sph, n, r, h.t);
  if (k < 0) return;
  const float* q = sph + k * kSphCols;
  const float hx = r.ox + r.dx * h.t - q[0];
  const float hy = r.oy + r.dy * h.t - q[1];
  const float hz = r.oz + r.dz * h.t - q[2];
  const float inv = rsqrtf(hx * hx + hy * hy + hz * hz + 1e-30f);
  h.prim = k + prim_offset;
  h.nx = hx * inv;
  h.ny = hy * inv;
  h.nz = hz * inv;
  h.mat = static_cast<int>(q[5]);
}

// Shadow test over both tables: true when the nearest table hit lies below
// t_max (the TPU's `visible = no hit | nearest t >= dist - eps`).
__device__ __forceinline__ bool table_occluded(const float* tri, int n_tri, const float* sph,
                                               int n_sph, const Ray& r, float t_max) {
  float t = INFINITY, u, v;
  const int k_tri = tri_scan(tri, n_tri, r, t, u, v);
  const int k_sph = sph_scan(sph, n_sph, r, t);  // must beat the triangles
  return (k_tri >= 0 || k_sph >= 0) && !(t >= t_max);
}

// The first P 16-byte pieces of a row in registers; out[i] its i-th column.
template <int P>
struct Loaded {
  float v[4 * P];
  __device__ __forceinline__ float operator[](int i) const { return v[i]; }
};

// Pieces of a record row the pair test loads: columns 0-19, the 17 it reads
// (0-15 and the cull column 16), then prim, mat and the first normal column.
constexpr int kRowPieces = 5;

// A record row of the dense tables in shared memory as kRowPieces 16-byte
// broadcast loads (every lane of a warp reads the same row); the float4
// pointer states the alignment the tables keep: rows of kRecCols floats
// (112 bytes) from a 16-byte aligned base. The compiler narrows a piece
// whose columns the test leaves unread (the any-hit test's last piece: the
// cull column alone), so a row test issues 4 LDS.128 and 1 LDS.
__device__ __forceinline__ Loaded<kRowPieces> load_row(const float* row) {
  const float4* q = reinterpret_cast<const float4*>(row);
  Loaded<kRowPieces> out;
#pragma unroll
  for (int j = 0; j < kRowPieces; ++j) {
    const float4 v = q[j];
    out.v[4 * j] = v.x;
    out.v[4 * j + 1] = v.y;
    out.v[4 * j + 2] = v.z;
    out.v[4 * j + 3] = v.w;
  }
  return out;
}

// Sign-normalised Plucker quantities of one record row (kRecCols floats)
// against a ray with moment m = o x d. CULL: -1 per-row cull column, 0 no
// row culls, 1 every row culls. `c` is any row with c[i] the i-th column:
// a row loaded by load_row, or a view of a row in the walk's shared-memory
// ring (cluster_traverse.cuh).
template <int CULL, class C>
__device__ __forceinline__ bool pair_quantities(const C& c, const Ray& r, float mx, float my,
                                                float mz, float& sd, float& su, float& sv,
                                                float& st) {
  const float det = c[0] * r.dx + c[1] * r.dy + c[2] * r.dz;
  const float un = c[3] * mx + c[4] * my + c[5] * mz + c[6] * r.dx + c[7] * r.dy + c[8] * r.dz;
  const float vn =
      c[9] * mx + c[10] * my + c[11] * mz + c[12] * r.dx + c[13] * r.dy + c[14] * r.dz;
  const float tn = -(c[0] * r.ox + c[1] * r.oy + c[2] * r.oz) - c[15];
  const float sgn = det >= 0.0f ? 1.0f : -1.0f;
  sd = det * sgn;
  su = un * sgn;
  sv = vn * sgn;
  st = tn * sgn;
  const float inside = jmin(jmin(jmin(su, sv), sd - su - sv), st);
  if (CULL == 0) return inside >= 0.0f && sd > kTriEps;
  if (CULL == 1) return inside >= 0.0f && det > kTriEps;
  return inside >= 0.0f && sd > kTriEps && (c[kRecCull] < 0.5f || det > 0.0f);
}

// Nearest hit over a pair record of `rows` rows (row stride kRecCols,
// 16-byte aligned in shared memory), improving strictly on h.t.
template <int CULL>
__device__ __forceinline__ void pair_nearest(const float* rec, int rows, const Ray& r, Hit& h) {
  const float mx = r.oy * r.dz - r.oz * r.dy;
  const float my = r.oz * r.dx - r.ox * r.dz;
  const float mz = r.ox * r.dy - r.oy * r.dx;
  int best = -1;
  float bt = h.t, bsd = 0.0f, bsu = 0.0f, bsv = 0.0f;
  for (int k = 0; k < rows; ++k) {
    float sd, su, sv, st;
    if (pair_quantities<CULL>(load_row(rec + k * kRecCols), r, mx, my, mz, sd, su, sv, st)) {
      const float tv = st / sd;
      if (tv < bt) {
        bt = tv;
        best = k;
        bsd = sd;
        bsu = su;
        bsv = sv;
      }
    }
  }
  if (best < 0) return;
  const float* c = rec + best * kRecCols;
  const float sdw = jmax(bsd, 1e-30f);
  const float uw = bsu / sdw;
  const float vw = bsv / sdw;
  const float w0 = 1.0f - uw - vw;
  const float* n = c + kRecN0;
  const float snx = w0 * n[0] + uw * n[3] + vw * n[6];
  const float sny = w0 * n[1] + uw * n[4] + vw * n[7];
  const float snz = w0 * n[2] + uw * n[5] + vw * n[8];
  const float inv = rsqrtf(snx * snx + sny * sny + snz * snz + 1e-30f);
  h.t = bt;
  h.prim = static_cast<int>(c[kRecPrim]);
  h.nx = snx * inv;
  h.ny = sny * inv;
  h.nz = snz * inv;
  h.mat = static_cast<int>(c[kRecMat]);
}

// Any-hit below t_lim over a pair record (as pair_nearest's), division-free:
// t < t_lim  <=>  st < t_lim * sd  (sd > 0 after sign normalisation).
template <int CULL>
__device__ __forceinline__ bool pair_anyhit(const float* rec, int rows, const Ray& r,
                                            float t_lim) {
  const float mx = r.oy * r.dz - r.oz * r.dy;
  const float my = r.oz * r.dx - r.ox * r.dz;
  const float mz = r.ox * r.dy - r.oy * r.dx;
  for (int k = 0; k < rows; ++k) {
    float sd, su, sv, st;
    if (pair_quantities<CULL>(load_row(rec + k * kRecCols), r, mx, my, mz, sd, su, sv, st) &&
        st < t_lim * sd)
      return true;
  }
  return false;
}

// The dense geometry policy of the per-bounce body (bounce_body.cuh): the
// pair record + spheres (rec_rows > 0, n_tri = 0), or the triangle table +
// spheres, all in shared memory. K1 and K2 (dense scenes) use it.
template <int CULL>
struct DenseGeo {
  const float* rec;
  int rec_rows;
  const float* tri;
  int n_tri;
  const float* sph;
  int n_sph;

  __device__ __forceinline__ void nearest(const Ray& r, Hit& h) const {
    if (rec_rows) {
      sph_nearest(sph, n_sph, 0, r, h);
      pair_nearest<CULL>(rec, rec_rows, r, h);
    } else {
      tri_nearest(tri, n_tri, r, h);
      sph_nearest(sph, n_sph, n_tri, r, h);
    }
  }

  __device__ __forceinline__ bool occluded(const Ray& r, float t_max) const {
    if (table_occluded(tri, n_tri, sph, n_sph, r, t_max)) return true;
    return rec_rows && pair_anyhit<CULL>(rec, rec_rows, r, jmax(t_max, 0.0f));
  }
};

}  // namespace ptx
