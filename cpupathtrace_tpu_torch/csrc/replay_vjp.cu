// The replay vjp: the material gradients of a record-and-replay gradient
// pass, from K2's record planes, on Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX package's backward is the autograd of
// `replay_fast` (cpupathtrace_tpu/integrator/diff_megakernel.py), XLA
// einsums over one-hot tables; the port ran the same graph in PyTorch
// (one-hots and masks at [D, R, M], fp32 GEMMs of width 3, autograd's saved
// intermediates), some 100 times the memory traffic the work needs. This
// kernel computes the same vector-Jacobian product in closed form. The
// wrapper is cpupathtrace_tpu_torch/integrator/diff_megakernel.py
// `replay_vjp`; the plain version is its `replay_vjp_reference`, which the
// CPU takes and the tests hold this kernel to.
//
// The math (diff_megakernel.py's module note): per ray, with g the first
// three columns of the spectrum's gradient, S_0 = 1 and S_{v+1} = c_v * S_v,
// out = sum_v S_v * a_v where a_v = emission[m_v] W_v + diffuse[m_v] * E_v
// and E_v = sum_l L_l w_vl + sum_k emission[em_mid[row_vk]] w_vk (the NEE
// spectrum); c_v is diffuse[m_v] (sel 1), specular[m_v] (sel 2) or 1 (sel 3,
// or a row that does not advance). With G_v = g * S_v and, backwards,
// B_D = 0, B_v = a_v + c_v * B_{v+1}:
//   d emission[m_v]           += G_v W_v
//   d diffuse[m_v]            += G_v * E_v
//   d emission[em_mid[row_k]] += (G_v * diffuse[m_v]) w_vk
//   d diffuse / specular[m_v] += G_v * B_{v+1}      (sel 1 / sel 2)
// A row with mid -1 contributes nothing and does not advance.
//
// What bounds it on this card: the bytes of the record planes, read once:
// D x n_drec x R float32, D the depths K2's loop reached (the box pass: 9 of
// its 12, x 7 x 4,194,304, 1.06 GB), plus the spectrum gradient's three
// colour columns (12 bytes a ray), over 3.35 TB/s: ~0.33 ms. The arithmetic
// is a few dozen operations a row.
//
// What the design does about it: one thread a ray, one forward sweep over
// the depths that reads each plane once (contiguous over R, so a warp's
// loads are coalesced), the next depth's planes loaded while this one is
// worked. The forward sweep keeps a_v, G_v and (c_v's kind, m_v) of every
// depth in shared memory ([D][7][threads] words, a lane's own column, free
// of bank conflicts) and the reverse sweep reads them back: a register
// array would need the depth at compile time, and local memory would
// stream through L1 and L2 at the planes' own rate. With 128 threads a
// block, the box's 9 depths take 33 KB a block, 5 blocks an SM. Blocks
// stride over the rays (the grid is the resident blocks), so the partial
// sums are one row a block.
//
// The sums: no float atomics. Each thread sums its rays' terms in ray and
// depth order. With at most kSmallMat materials the [3, M, 3] sums live in
// registers and a warp folds them by an xor butterfly (on an H100 at the
// box pass's shape 0.80 ms, the warp slices 5.15: a slice's add is a
// match, a vote and a shuffle loop where a register add is one); otherwise
// each warp owns a [3, M, 3] slice in shared memory, and each term goes to
// it through the lanes that carry the same (field, material): the lowest of
// them adds their values in lane order (__match_any_sync). The block folds
// its warps' slices in warp order into its partial row; a second launch
// folds the rows in block order, a warp an output element. So a call's
// gradients are the same bits on every call with the same grid, which
// depends on the card and the shapes only. Float32 throughout, built with --fmad=false as every
// kernel of the package.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace ptx {
namespace {

constexpr int kMaxThreads = 128;
constexpr int kSmallMat = 4;  // register sums up to this many materials
constexpr int kFields = 3;    // diffuse, specular, emission
constexpr int kFieldDiffuse = 0, kFieldSpecular = 1, kFieldEmission = 2;
constexpr int kStashFloats = 6;  // a_v, G_v; then one int: kind | m << 2
constexpr int kPrefetch = 8;     // planes of the next depth held in registers
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* planes;  // [depth, n_drec, n_rays]
  const float* grad;    // [n_rays, grad_cols]
  const float* mat[kFields];  // [n_mat, mat_cols[f]]
  int mat_cols[kFields];
  const int* em_mid;    // [n_em]
  const float* light;   // [n_lights, 3]
  float* partial;       // [gridDim.x, kFields, n_mat, 3]
  long long n_rays;
  int grad_cols, n_mat, n_em, n_lights, em_k, n_drec, depth;
};

// The shared-memory layout of a block of `threads`: tables, the sums' area,
// the stash. All words are 4 bytes.
struct Layout {
  int mat, light, em, red, stash, key, words;
  __host__ __device__ Layout(const Params& p, int threads, bool small) {
    mat = 0;
    light = mat + kFields * p.n_mat * 3;
    em = light + 3 * p.n_lights;
    red = em + p.n_em;
    const int warps = threads / 32;
    stash = red + warps * kFields * (small ? kSmallMat : p.n_mat) * 3;
    key = stash + p.depth * kStashFloats * threads;
    words = key + p.depth * threads;
  }
};

// Register sums for at most kSmallMat materials.
struct SmallSums {
  float s[kFields][kSmallMat][3];
  __device__ __forceinline__ SmallSums() {
#pragma unroll
    for (int f = 0; f < kFields; ++f)
#pragma unroll
      for (int m = 0; m < kSmallMat; ++m) s[f][m][0] = s[f][m][1] = s[f][m][2] = 0.0f;
  }
  template <int kField>
  __device__ __forceinline__ void add(bool on, int m, float x, float y, float z) {
#pragma unroll
    for (int k = 0; k < kSmallMat; ++k) {
      if (on && m == k) {
        s[kField][k][0] += x;
        s[kField][k][1] += y;
        s[kField][k][2] += z;
      }
    }
  }
  // Fold the warp's lanes (xor butterfly) and store lane 0's sums at `red`.
  __device__ __forceinline__ void store_warp(float* red, int lane) {
#pragma unroll
    for (int f = 0; f < kFields; ++f)
#pragma unroll
      for (int m = 0; m < kSmallMat; ++m)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          float v = s[f][m][c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
          if (lane == 0) red[(f * kSmallMat + m) * 3 + c] = v;
        }
  }
};

// Per-warp slices in shared memory for up to MAX_MAT materials. Every lane
// of the warp calls add() together; `on` false adds nothing.
struct WarpSums {
  float* slice;  // [kFields, n_mat, 3] of this warp
  int n_mat, lane;
  template <int kField>
  __device__ __forceinline__ void add(bool on, int m, float x, float y, float z) {
    const int key = on ? kField * n_mat + m : -1;
    const unsigned peers = __match_any_sync(kFull, key);
    const int most = __reduce_max_sync(kFull, static_cast<unsigned>(__popc(peers)));
    // The lowest lane of each group adds its peers' values in lane order.
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    unsigned rest = peers;
    for (int i = 0; i < most; ++i) {
      const int src = rest ? __ffs(rest) - 1 : lane;
      const float tx = __shfl_sync(kFull, x, src);
      const float ty = __shfl_sync(kFull, y, src);
      const float tz = __shfl_sync(kFull, z, src);
      if (rest) {
        sx += tx;
        sy += ty;
        sz += tz;
        rest &= rest - 1;
      }
    }
    if (key >= 0 && __ffs(peers) - 1 == lane) {
      float* d = slice + key * 3;
      d[0] += sx;
      d[1] += sy;
      d[2] += sz;
    }
    __syncwarp();
  }
};

__device__ __forceinline__ void load_depth(const Params& p, int v, long long r, bool live,
                                           float (&buf)[kPrefetch]) {
  const float* pv = p.planes + static_cast<long long>(v) * p.n_drec * p.n_rays + r;
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j)
    buf[j] = (live && j < p.n_drec) ? __ldg(pv + static_cast<long long>(j) * p.n_rays) : 0.0f;
}

// Plane j of depth v for ray r: from the prefetched registers below
// kPrefetch (selected without a dynamic index), else from memory.
__device__ __forceinline__ float plane(const Params& p, const float (&buf)[kPrefetch], int v,
                                       int j, long long r) {
  if (j >= kPrefetch)
    return __ldg(p.planes + (static_cast<long long>(v) * p.n_drec + j) * p.n_rays + r);
  float x = 0.0f;
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q)
    if (q == j) x = buf[q];
  return x;
}

template <bool kSmall>
__global__ void __launch_bounds__(kMaxThreads) replay_vjp_kernel(const Params p) {
  extern __shared__ float smem[];
  const int threads = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = threads >> 5;
  const Layout lay(p, threads, kSmall);
  const int nm = p.n_mat;
  float* s_mat = smem + lay.mat;  // [kFields, n_mat, 3]
  float* s_light = smem + lay.light;
  int* s_em = reinterpret_cast<int*>(smem + lay.em);
  float* s_red = smem + lay.red;
  float* s_stash = smem + lay.stash;  // [depth, kStashFloats, threads]
  int* s_key = reinterpret_cast<int*>(smem + lay.key);  // [depth, threads]
  const int slice_words = kFields * (kSmall ? kSmallMat : nm) * 3;
  for (int i = tid; i < kFields * nm * 3; i += threads) {
    const int f = i / (nm * 3), m = (i / 3) % nm, c = i % 3;
    // No dynamic index into the parameters: it would copy them to the stack.
    const float* t = f == 0 ? p.mat[0] : f == 1 ? p.mat[1] : p.mat[2];
    const int cols = f == 0 ? p.mat_cols[0] : f == 1 ? p.mat_cols[1] : p.mat_cols[2];
    s_mat[i] = t[m * cols + c];
  }
  for (int i = tid; i < 3 * p.n_lights; i += threads) s_light[i] = p.light[i];
  for (int i = tid; i < p.n_em; i += threads) s_em[i] = min(max(p.em_mid[i], 0), nm - 1);
  if (!kSmall)
    for (int i = tid; i < warps * slice_words; i += threads) s_red[i] = 0.0f;
  __syncthreads();
  const float* dif = s_mat;
  const float* spc = s_mat + nm * 3;
  const float* emi = s_mat + 2 * nm * 3;

  using Sums = typename std::conditional<kSmall, SmallSums, WarpSums>::type;
  Sums sums;
  if constexpr (!kSmall) {
    sums.slice = s_red + warp * slice_words;
    sums.n_mat = nm;
    sums.lane = lane;
  }
  const bool g4 = p.grad_cols == 4 && (reinterpret_cast<uintptr_t>(p.grad) & 15) == 0;
  const int row0 = 3 + p.n_lights;  // the first emitter draw's CDF-row plane

  for (long long base = static_cast<long long>(blockIdx.x) * threads; base < p.n_rays;
       base += static_cast<long long>(gridDim.x) * threads) {
    const long long r = base + tid;
    const bool live = r < p.n_rays;
    float g0 = 0.0f, g1 = 0.0f, g2 = 0.0f;
    if (live) {
      if (g4) {
        const float4 gv = __ldg(reinterpret_cast<const float4*>(p.grad) + r);
        g0 = gv.x, g1 = gv.y, g2 = gv.z;
      } else {
        const float* gr = p.grad + r * p.grad_cols;
        g0 = gr[0], g1 = gr[1], g2 = gr[2];
      }
    }
    float s0 = 1.0f, s1 = 1.0f, s2 = 1.0f;
    float cur[kPrefetch], nxt[kPrefetch];
    load_depth(p, 0, r, live, cur);
    // Forward sweep: S_v, a_v and every term of d a_v.
    for (int v = 0; v < p.depth; ++v) {
      if (v + 1 < p.depth) load_depth(p, v + 1, r, live, nxt);
      const int mid = static_cast<int>(cur[0]);
      const bool hit = live && mid >= 0;
      const int m = hit ? min(mid, nm - 1) : 0;
      const float w = cur[1];
      const int sel = static_cast<int>(cur[2]);
      const float G0 = g0 * s0, G1 = g1 * s1, G2 = g2 * s2;
      const float d0 = dif[m * 3], d1 = dif[m * 3 + 1], d2 = dif[m * 3 + 2];
      float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
      for (int l = 0; l < p.n_lights; ++l) {
        const float wl = hit ? plane(p, cur, v, 3 + l, r) : 0.0f;
        e0 += s_light[l * 3] * wl;
        e1 += s_light[l * 3 + 1] * wl;
        e2 += s_light[l * 3 + 2] * wl;
      }
      for (int k = 0; k < p.em_k; ++k) {
        const int row = hit ? static_cast<int>(plane(p, cur, v, row0 + 2 * k, r)) : 0;
        const float wk = hit ? plane(p, cur, v, row0 + 2 * k + 1, r) : 0.0f;
        const int em = s_em[min(max(row, 0), p.n_em - 1)];
        e0 += emi[em * 3] * wk;
        e1 += emi[em * 3 + 1] * wk;
        e2 += emi[em * 3 + 2] * wk;
        sums.template add<kFieldEmission>(hit, em, (G0 * d0) * wk, (G1 * d1) * wk,
                                          (G2 * d2) * wk);
      }
      sums.template add<kFieldEmission>(hit, m, G0 * w, G1 * w, G2 * w);
      sums.template add<kFieldDiffuse>(hit, m, G0 * e0, G1 * e1, G2 * e2);
      const int kind = hit && (sel == 1 || sel == 2) ? sel : 0;
      float* st = s_stash + v * kStashFloats * threads + tid;
      st[0] = hit ? emi[m * 3] * w + d0 * e0 : 0.0f;
      st[threads] = hit ? emi[m * 3 + 1] * w + d1 * e1 : 0.0f;
      st[2 * threads] = hit ? emi[m * 3 + 2] * w + d2 * e2 : 0.0f;
      st[3 * threads] = G0;
      st[4 * threads] = G1;
      st[5 * threads] = G2;
      s_key[v * threads + tid] = kind | (m << 2);
      if (kind == 1) {
        s0 = d0 * s0, s1 = d1 * s1, s2 = d2 * s2;
      } else if (kind == 2) {
        s0 = spc[m * 3] * s0, s1 = spc[m * 3 + 1] * s1, s2 = spc[m * 3 + 2] * s2;
      }
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) cur[j] = nxt[j];
    }
    // Reverse sweep: B_{v+1} and the chain's terms.
    float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    for (int v = p.depth - 1; v >= 0; --v) {
      const float* st = s_stash + v * kStashFloats * threads + tid;
      const int key = s_key[v * threads + tid];
      const int kind = key & 3, m = key >> 2;
      const float G0 = st[3 * threads], G1 = st[4 * threads], G2 = st[5 * threads];
      sums.template add<kFieldDiffuse>(kind == 1, m, G0 * b0, G1 * b1, G2 * b2);
      sums.template add<kFieldSpecular>(kind == 2, m, G0 * b0, G1 * b1, G2 * b2);
      const float* c = kind == 1 ? dif + m * 3 : spc + m * 3;
      if (kind == 0) {
        b0 = st[0] + b0, b1 = st[threads] + b1, b2 = st[2 * threads] + b2;
      } else {
        b0 = st[0] + c[0] * b0, b1 = st[threads] + c[1] * b1, b2 = st[2 * threads] + c[2] * b2;
      }
    }
  }

  // The block's partial row: its warps' sums in warp order.
  if constexpr (kSmall) sums.store_warp(s_red + warp * slice_words, lane);
  __syncthreads();
  float* out = p.partial + static_cast<long long>(blockIdx.x) * kFields * nm * 3;
  for (int i = tid; i < kFields * nm * 3; i += threads) {
    const int f = i / (nm * 3), m = (i / 3) % nm, c = i % 3;
    const int at = kSmall ? (f * kSmallMat + m) * 3 + c : i;
    float sum = 0.0f;
    for (int w = 0; w < warps; ++w) sum += s_red[w * slice_words + at];
    out[i] = sum;
  }
}

// The rows of `partial` summed in block order: a warp an element (lanes
// stride the rows, then an xor butterfly), written to the field's gradient
// [n_mat, cols]; the columns past 3 get 0.
__global__ void replay_fold_kernel(const float* partial, int rows, int n_mat, float* out_dif,
                                   float* out_spc, float* out_emi, int cols_dif, int cols_spc,
                                   int cols_emi) {
  const int e = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int n = kFields * n_mat * 3;
  if (e >= n) return;  // whole warps
  float sum = 0.0f;
  for (int b = lane; b < rows; b += 32) sum += partial[static_cast<long long>(b) * n + e];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane != 0) return;
  const int f = e / (n_mat * 3), m = (e / 3) % n_mat, c = e % 3;
  float* out = f == kFieldDiffuse ? out_dif : f == kFieldSpecular ? out_spc : out_emi;
  const int cols = f == kFieldDiffuse ? cols_dif : f == kFieldSpecular ? cols_spc : cols_emi;
  out[m * cols + c] = sum;
  if (c == 0)
    for (int k = 3; k < cols; ++k) out[m * cols + k] = 0.0f;
}

template <bool kSmall>
cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(replay_vjp_kernel<kSmall>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
}

bool valid_threads(int threads) {
  return threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace
}  // namespace ptx

// Plain C entry points for ctypes. The launch runs the vjp over `grid`
// blocks of `threads` into `partial` [grid, 3, n_mat, 3], then the fold
// into the three gradients; both on `stream`, no synchronisation, nothing
// allocated; returns the first cudaError_t.
extern "C" int ptx_replay_vjp_launch(const float* planes, int depth, int n_drec,
                                     long long n_rays, const float* grad, int grad_cols,
                                     const float* dif, const float* spc, const float* emi,
                                     int cols_dif, int cols_spc, int cols_emi, int n_mat,
                                     const int* em_mid, int n_em, const float* light,
                                     int n_lights, int em_k, float* partial, int grid,
                                     int threads, float* out_dif, float* out_spc,
                                     float* out_emi, void* stream) {
  using namespace ptx;
  if (!valid_threads(threads) || grid < 1 || n_mat < 1 || depth < 1 || n_rays < 1 ||
      n_drec != 3 + n_lights + 2 * em_k || (em_k > 0 && n_em < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.planes = planes;
  p.grad = grad;
  p.mat[0] = dif, p.mat[1] = spc, p.mat[2] = emi;
  p.mat_cols[0] = cols_dif, p.mat_cols[1] = cols_spc, p.mat_cols[2] = cols_emi;
  p.em_mid = em_mid;
  p.light = light;
  p.partial = partial;
  p.n_rays = n_rays;
  p.grad_cols = grad_cols, p.n_mat = n_mat, p.n_em = n_em, p.n_lights = n_lights;
  p.em_k = em_k, p.n_drec = n_drec, p.depth = depth;
  const bool small = n_mat <= kSmallMat;
  const size_t smem = static_cast<size_t>(Layout(p, threads, small).words) * 4;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = small ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (small)
    replay_vjp_kernel<true><<<grid, threads, smem, s>>>(p);
  else
    replay_vjp_kernel<false><<<grid, threads, smem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = kFields * n_mat * 3;
  replay_fold_kernel<<<(warps * 32 + 255) / 256, 256, 0, s>>>(partial, grid, n_mat, out_dif,
                                                              out_spc, out_emi, cols_dif,
                                                              cols_spc, cols_emi);
  return static_cast<int>(cudaGetLastError());
}

// The instance a launch takes: the dynamic shared memory of a block of
// `threads` and its resident blocks per SM.
extern "C" int ptx_replay_vjp_occupancy(int depth, int n_mat, int n_em, int n_lights,
                                        int threads, long long* smem_out, int* blocks) {
  using namespace ptx;
  if (!valid_threads(threads) || n_mat < 1 || depth < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.n_mat = n_mat, p.n_em = n_em, p.n_lights = n_lights, p.depth = depth;
  const bool small = n_mat <= kSmallMat;
  const size_t smem = static_cast<size_t>(Layout(p, threads, small).words) * 4;
  *smem_out = static_cast<long long>(smem);
  cudaError_t err = small ? allow_smem<true>(smem) : allow_smem<false>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      small ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, replay_vjp_kernel<true>,
                                                            threads, smem)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, replay_vjp_kernel<false>,
                                                            threads, smem));
}
