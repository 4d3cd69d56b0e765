// Host-side mesh pipeline (C++, not CUDA) for the torch port's scene build:
// a copy of the OBJ parser (`ptx_count_obj`, `ptx_parse_obj`) and of the mesh
// pipeline (`ptx_mesh_pipeline`) of cpupathtrace_tpu/native/src/ptx_native.cpp,
// and its pair-record packer (`ptx_pack_pair_records`) rewritten for the
// port's record layout. The BVH builder is csrc/bvh_build.cpp.
//
//   * ptx_parse_obj      OBJ v/f parser with the reference's tolerant
//                        semantics (spec: reference src/scene/mesh.cpp:11-271)
//   * ptx_mesh_pipeline  face validation + smooth vertex normals, bit-equal
//                        to scene/mesh.py's numpy pipeline
//   * ptx_pack_pair_records  the traversal records [C, L, 32] f32, bit-equal
//                        to accel/kernel_traverse.py:_pack_pair_records_batch
//
// Built by cpupathtrace_tpu_torch/_build.py:load_host with
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// (no FMA contraction, so the float results equal numpy's bit for bit) and
// bound with ctypes (plain C interface) in cpupathtrace_tpu_torch/native.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Runs fn(begin, end) over [0, n) in n_threads contiguous chunks, the
// first on the calling thread.
template <typename Fn>
void parallel_ranges(int64_t n, int n_threads, Fn fn) {
  if (n_threads <= 1) {
    fn(int64_t{0}, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int i = 1; i < n_threads; i++) {
    const int64_t b = i * chunk, e = std::min(n, b + chunk);
    if (b < e) threads.emplace_back(fn, b, e);
  }
  fn(int64_t{0}, std::min(n, chunk));
  for (auto& t : threads) t.join();
}

// One thread per `per` items, at most the hardware's threads.
int thread_count(int64_t n, int64_t per) {
  const unsigned hw = std::thread::hardware_concurrency();
  return static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n / per)));
}

// Space-only skip: MUST match ptx_count_obj's whitespace predicate (and the
// reference's space-only eatSpace, ref: src/scene/mesh.cpp:31-36) so the
// count pass and the parse pass agree on which lines are records. A tab- or
// CR-indented line is neither counted nor parsed.
inline const char* skip_spaces(const char* p, const char* end) {
  while (p < end && *p == ' ') p++;
  return p;
}

}  // namespace

extern "C" {

// Record row width and used columns (accel/kernel_traverse.py REC_COLS,
// accel/pair_record.py REC_USED_COLS); the wrapper checks them.
int ptx_record_cols() { return 32; }
int ptx_record_used_cols() { return 28; }

// ---------------------------------------------------------------------------
// Pair-record packer
// ---------------------------------------------------------------------------
// The traversal records (layout: accel/pair_record.py; columns 0:3 -N,
// 3:6 e2, 6:9 v0 x e2, 9:12 -e1, 12:15 -(v0 x e1), 15 v0 . N, 16 cull,
// 17 prim, 18 mat, 19:28 per-vertex normals) in rows of 32 floats.
// Inputs: v0/v1/v2/n0/n1/n2 [c, l, 3] f32; cull/prim/mat [c, l] f32.
// Output rec [c, l, 32] f32, ZEROED by the caller: columns 28-31 are not
// written. Each product and sum is the numpy packer's, in its order (v0 . N
// summed in axis order from the first product), so a padding slot (N = 0)
// keeps the sign of zero numpy gives it. Threaded over clusters.
void ptx_pack_pair_records(const float* v0, const float* v1, const float* v2,
                           const float* cull, const float* prim, const float* mat,
                           const float* n0, const float* n1, const float* n2, int64_t c,
                           int l, float* rec) {
  constexpr int kCols = 32;
  auto pack_range = [&](int64_t begin, int64_t end) {
    for (int64_t ci = begin; ci < end; ci++) {
      const int64_t base1 = ci * static_cast<int64_t>(l);
      const int64_t base3 = base1 * 3;
      for (int t = 0; t < l; t++) {
        const float* a = v0 + base3 + 3 * t;
        const float* b = v1 + base3 + 3 * t;
        const float* d = v2 + base3 + 3 * t;
        const float p = prim[base1 + t];
        float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
        float e2[3] = {d[0] - a[0], d[1] - a[1], d[2] - a[2]};
        float nx = e1[1] * e2[2] - e1[2] * e2[1];
        float ny = e1[2] * e2[0] - e1[0] * e2[2];
        float nz = e1[0] * e2[1] - e1[1] * e2[0];
        if (!(p >= 0.0f)) nx = ny = nz = 0.0f;
        float* row = rec + (base1 + t) * kCols;
        row[0] = -nx;
        row[1] = -ny;
        row[2] = -nz;
        row[3] = e2[0];
        row[4] = e2[1];
        row[5] = e2[2];
        row[6] = a[1] * e2[2] - a[2] * e2[1];
        row[7] = a[2] * e2[0] - a[0] * e2[2];
        row[8] = a[0] * e2[1] - a[1] * e2[0];
        row[9] = -e1[0];
        row[10] = -e1[1];
        row[11] = -e1[2];
        row[12] = -(a[1] * e1[2] - a[2] * e1[1]);
        row[13] = -(a[2] * e1[0] - a[0] * e1[2]);
        row[14] = -(a[0] * e1[1] - a[1] * e1[0]);
        row[15] = a[0] * nx + a[1] * ny + a[2] * nz;
        row[16] = cull[base1 + t];
        row[17] = p;
        row[18] = mat[base1 + t];
        const float* m0 = n0 + base3 + 3 * t;
        const float* m1 = n1 + base3 + 3 * t;
        const float* m2 = n2 + base3 + 3 * t;
        row[19] = m0[0];
        row[20] = m0[1];
        row[21] = m0[2];
        row[22] = m1[0];
        row[23] = m1[1];
        row[24] = m1[2];
        row[25] = m2[0];
        row[26] = m2[1];
        row[27] = m2[2];
      }
    }
  };
  parallel_ranges(c, thread_count(c, 256), pack_range);
}

// ---------------------------------------------------------------------------
// Mesh pipeline: face validation + smooth vertex normals
// ---------------------------------------------------------------------------
// The post-parse pipeline of scene/mesh.py mesh_from_arrays (behavioural
// spec: reference src/scene/mesh.cpp:127-267): reject faces with
// out-of-range indices, duplicate vertices, or collinear vertices (NaN
// coordinates fail the > 0 checks, like the numpy comparisons); optionally
// average the unit incident face normals per vertex. The float operations
// follow numpy's order exactly (compiled -ffp-contract=off), so the outputs
// are bit-equal to the numpy pipeline.
// verts: [n_v, 3] f64 (already transformed). faces: [n_f, 3] i64.
// Outputs (capacity n_f rows each): a/b/c vertex positions, na/nb/nc
// per-vertex normals. Returns the kept-face count; kept faces are packed
// in input order.
int64_t ptx_mesh_pipeline(const double* verts, int64_t n_v, const int64_t* faces,
                          int64_t n_f, int smooth, double* out_a, double* out_b,
                          double* out_c, double* out_na, double* out_nb, double* out_nc) {
  if (n_f <= 0 || n_v <= 0) return 0;
  std::vector<double> fn_unit(static_cast<size_t>(n_f) * 3);
  std::vector<uint8_t> keep(n_f, 0);
  const int n_threads = thread_count(n_f, 16384);

  parallel_ranges(n_f, n_threads, [&](int64_t begin, int64_t end) {
    for (int64_t f = begin; f < end; f++) {
      const int64_t i0 = faces[3 * f + 0];
      const int64_t i1 = faces[3 * f + 1];
      const int64_t i2 = faces[3 * f + 2];
      if (i0 < 0 || i0 >= n_v || i1 < 0 || i1 >= n_v || i2 < 0 || i2 >= n_v) continue;
      const double* a = verts + 3 * i0;
      const double* b = verts + 3 * i1;
      const double* c = verts + 3 * i2;
      const double ab0 = b[0] - a[0], ab1 = b[1] - a[1], ab2 = b[2] - a[2];
      const double ac0 = c[0] - a[0], ac1 = c[1] - a[1], ac2 = c[2] - a[2];
      const double bc0 = c[0] - b[0], bc1 = c[1] - b[1], bc2 = c[2] - b[2];
      const double d_ab = ab0 * ab0 + ab1 * ab1 + ab2 * ab2;
      const double d_ac = ac0 * ac0 + ac1 * ac1 + ac2 * ac2;
      const double d_bc = bc0 * bc0 + bc1 * bc1 + bc2 * bc2;
      if (!(d_ab > 0.0) || !(d_ac > 0.0) || !(d_bc > 0.0)) continue;
      const double fx = ab1 * ac2 - ab2 * ac1;
      const double fy = ab2 * ac0 - ab0 * ac2;
      const double fz = ab0 * ac1 - ab1 * ac0;
      const double len2 = fx * fx + fy * fy + fz * fz;
      if (!(len2 > 0.0)) continue;
      keep[f] = 1;
      const double len = std::max(std::sqrt(len2), 1e-300);
      fn_unit[3 * f + 0] = fx / len;
      fn_unit[3 * f + 1] = fy / len;
      fn_unit[3 * f + 2] = fz / len;
    }
  });

  // Kept-face list in input order (stable compaction).
  std::vector<int64_t> kept;
  kept.reserve(n_f);
  for (int64_t f = 0; f < n_f; f++)
    if (keep[f]) kept.push_back(f);
  const int64_t n_k = static_cast<int64_t>(kept.size());

  std::vector<double> v_unit;
  std::vector<uint8_t> v_ok;
  if (smooth && n_k) {
    // Accumulation ORDER matters for float equality with numpy's
    // np.add.at loop (k outer, faces inner): run it serially the same way.
    std::vector<double> v_norm(static_cast<size_t>(n_v) * 3, 0.0);
    for (int k = 0; k < 3; k++) {
      for (int64_t j = 0; j < n_k; j++) {
        const int64_t f = kept[j];
        const int64_t v = faces[3 * f + k];
        v_norm[3 * v + 0] += fn_unit[3 * f + 0];
        v_norm[3 * v + 1] += fn_unit[3 * f + 1];
        v_norm[3 * v + 2] += fn_unit[3 * f + 2];
      }
    }
    v_unit.resize(static_cast<size_t>(n_v) * 3);
    v_ok.assign(n_v, 0);
    parallel_ranges(n_v, n_threads, [&](int64_t begin, int64_t end) {
      for (int64_t v = begin; v < end; v++) {
        const double x = v_norm[3 * v], y = v_norm[3 * v + 1], z = v_norm[3 * v + 2];
        const double l2 = x * x + y * y + z * z;
        if (l2 > 0.0) {
          v_ok[v] = 1;
          // Divide (not reciprocal-multiply): numpy's v_norm / sqrt(...).
          const double len = std::sqrt(std::max(l2, 1e-300));
          v_unit[3 * v] = x / len;
          v_unit[3 * v + 1] = y / len;
          v_unit[3 * v + 2] = z / len;
        } else {
          v_unit[3 * v] = v_unit[3 * v + 1] = v_unit[3 * v + 2] = 0.0;
        }
      }
    });
  }

  parallel_ranges(n_k, n_threads, [&](int64_t begin, int64_t end) {
    for (int64_t j = begin; j < end; j++) {
      const int64_t f = kept[j];
      const int64_t vi[3] = {faces[3 * f], faces[3 * f + 1], faces[3 * f + 2]};
      std::memcpy(out_a + 3 * j, verts + 3 * vi[0], 3 * sizeof(double));
      std::memcpy(out_b + 3 * j, verts + 3 * vi[1], 3 * sizeof(double));
      std::memcpy(out_c + 3 * j, verts + 3 * vi[2], 3 * sizeof(double));
      const double* fu = fn_unit.data() + 3 * f;
      double* outs[3] = {out_na + 3 * j, out_nb + 3 * j, out_nc + 3 * j};
      for (int k = 0; k < 3; k++) {
        const bool vertex = smooth && n_k && v_ok[vi[k]];
        std::memcpy(outs[k], vertex ? v_unit.data() + 3 * vi[k] : fu, 3 * sizeof(double));
      }
    }
  });
  return n_k;
}

// ---------------------------------------------------------------------------
// OBJ parser
// ---------------------------------------------------------------------------
// Parses `v`/`f` records from text[0..len). Face tokens keep only the
// position index before any '/'. Outputs are caller-allocated with
// capacities n_verts_cap*3 and n_faces_cap*3 obtained from ptx_count_obj.
// Unparseable floats become NaN; unparseable/short faces get index -1
// (the Python layer then applies the reference's face-validation rules).
void ptx_count_obj(const char* text, int64_t len, int64_t* n_verts, int64_t* n_faces) {
  int64_t v = 0, f = 0;
  int64_t i = 0;
  while (i < len) {
    while (i < len && text[i] == ' ') i++;
    if (i + 1 < len && text[i + 1] == ' ') {
      if (text[i] == 'v')
        v++;
      else if (text[i] == 'f')
        f++;
    }
    while (i < len && text[i] != '\n') i++;
    i++;
  }
  *n_verts = v;
  *n_faces = f;
}

void ptx_parse_obj(const char* text, int64_t len, float* verts, int64_t n_verts_cap,
                   int64_t* faces, int64_t n_faces_cap) {
  const char* p = text;
  const char* end = text + len;
  int64_t vi = 0, fi = 0;
  while (p < end) {
    const char* line_end =
        static_cast<const char*>(memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    const char* q = skip_spaces(p, line_end);
    if (q + 1 < line_end && q[1] == ' ') {
      // Never write past the counted capacities, even if the two passes
      // ever disagree.
      if (*q == 'v' && vi >= n_verts_cap) {
      } else if (*q == 'f' && fi >= n_faces_cap) {
      } else if (*q == 'v') {
        q += 2;
        for (int c = 0; c < 3; c++) {
          q = skip_spaces(q, line_end);
          char* after = nullptr;
          float val = strtof(q, &after);
          if (after == q || after > line_end) {
            val = NAN;
            while (q < line_end && *q != ' ') q++;
          } else {
            q = after;
          }
          verts[3 * vi + c] = val;
        }
        vi++;
      } else if (*q == 'f') {
        q += 2;
        for (int c = 0; c < 3; c++) {
          q = skip_spaces(q, line_end);
          char* after = nullptr;
          long val = strtol(q, &after, 10);
          if (after == q || after > line_end) {
            val = 0;  // becomes -1 after the 1-based shift
            while (q < line_end && *q != ' ' && *q != '/') q++;
          } else {
            q = after;
          }
          // Skip texture/normal refs: a/b/c -> a.
          while (q < line_end && *q != ' ') q++;
          faces[3 * fi + c] = val - 1;
        }
        fi++;
      }
    }
    p = line_end + 1;
  }
}

}  // extern "C"
