// Host-side flat BVH builder (C++, not CUDA): a copy of `ptx_build_bvh` and
// `bvh_process_stack` of cpupathtrace_tpu/native/src/ptx_native.cpp, for the
// torch port's scene build. The policy is the reference's (median split on
// box minima, split axis minimising summed child surface area, left <=
// 2*right rebalance; ref: src/scene/scene.cpp:12-102): the same tree as the
// numpy builder in cpupathtrace_tpu_torch/accel/build.py.
//
// Built by cpupathtrace_tpu_torch/_build.py:load_host with
//   g++ -O3 -std=c++17 -shared -fPIC -pthread -ffp-contract=off
// and bound with ctypes (plain C interface).
#include <algorithm>
#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <utility>
#include <vector>

namespace {

struct BvhTask {
  int node;
  int begin;
  int end;
  int depth;
};

// Processes tasks LIFO with the reference split policy. `next_node`
// allocates child ids in the serial scheme. With a non-null `frontier`, a
// popped task of 2..defer_below primitives is deferred together with its
// would-be id base, and `next_node` skips its exact subtree allocation (a
// k-primitive subtree allocates 2k-2 child ids, contiguous under LIFO), so
// worker threads can build deferred subtrees in parallel and reproduce the
// serial numbering bit for bit.
void bvh_process_stack(const float* prim_lo, const float* prim_hi, int32_t* idx, float* lo,
                       float* hi, int32_t* left, int32_t* right, int32_t* prim,
                       std::vector<BvhTask>& stack, int& next_node, int& max_depth,
                       int defer_below, std::vector<std::pair<BvhTask, int>>* frontier,
                       int32_t* node_begin, int32_t* node_size) {
  std::vector<float> axmin;
  while (!stack.empty()) {
    BvhTask t = stack.back();
    stack.pop_back();
    const int k = t.end - t.begin;
    if (frontier && k > 1 && k <= defer_below) {
      frontier->push_back({t, next_node});
      next_node += 2 * k - 2;
      continue;
    }
    max_depth = std::max(max_depth, t.depth);
    if (node_begin) {
      // One primitive per leaf: t.begin is the node's first-leaf DFS rank
      // and k its subtree primitive count (the cluster cut reads both).
      node_begin[t.node] = t.begin;
      node_size[t.node] = k;
    }

    float blo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float bhi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int i = t.begin; i < t.end; i++) {
      const float* l = prim_lo + 3 * idx[i];
      const float* h = prim_hi + 3 * idx[i];
      for (int a = 0; a < 3; a++) {
        blo[a] = std::min(blo[a], l[a]);
        bhi[a] = std::max(bhi[a], h[a]);
      }
    }
    std::memcpy(lo + 3 * t.node, blo, sizeof blo);
    std::memcpy(hi + 3 * t.node, bhi, sizeof bhi);

    if (k == 1) {
      prim[t.node] = idx[t.begin];
      left[t.node] = right[t.node] = -1;
      continue;
    }
    prim[t.node] = -1;

    // Median of box minima per axis ((k/2-1)-th order statistic), then the
    // axis whose low <= median partition minimises summed child areas.
    if (static_cast<int>(axmin.size()) < k) axmin.resize(k);
    double best_cost = 0.0;
    int best_axis = -1;
    float best_median = 0.0f;
    for (int axis = 0; axis < 3; axis++) {
      for (int i = 0; i < k; i++) axmin[i] = prim_lo[3 * idx[t.begin + i] + axis];
      const int m_pos = std::max(k / 2 - 1, 0);
      std::nth_element(axmin.begin(), axmin.begin() + m_pos, axmin.begin() + k);
      const float median = axmin[m_pos];

      float l_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
      float l_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      float r_lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
      float r_hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
      int n_l = 0;
      for (int i = t.begin; i < t.end; i++) {
        const float* l = prim_lo + 3 * idx[i];
        const float* h = prim_hi + 3 * idx[i];
        const bool go_left = l[axis] <= median;
        float* tlo = go_left ? l_lo : r_lo;
        float* thi = go_left ? l_hi : r_hi;
        for (int a = 0; a < 3; a++) {
          tlo[a] = std::min(tlo[a], l[a]);
          thi[a] = std::max(thi[a], h[a]);
        }
        n_l += go_left;
      }
      double cost;
      if (n_l == 0 || n_l == k) {
        cost = HUGE_VAL;  // degenerate split
      } else {
        const double dl0 = l_hi[0] - l_lo[0], dl1 = l_hi[1] - l_lo[1], dl2 = l_hi[2] - l_lo[2];
        const double dr0 = r_hi[0] - r_lo[0], dr1 = r_hi[1] - r_lo[1], dr2 = r_hi[2] - r_lo[2];
        cost = 2.0 * (dl0 * dl1 + dl1 * dl2 + dl0 * dl2) + 2.0 * (dr0 * dr1 + dr1 * dr2 + dr0 * dr2);
      }
      if (best_axis < 0 || cost < best_cost) {
        best_cost = cost;
        best_axis = axis;
        best_median = median;
      }
    }

    std::stable_partition(idx + t.begin, idx + t.end, [&](int32_t p) {
      return prim_lo[3 * p + best_axis] <= best_median;
    });
    int n_left = 0;
    for (int i = t.begin; i < t.end; i++) n_left += prim_lo[3 * idx[i] + best_axis] <= best_median;

    // Rebalance: the trailing left entries move to the END of the right
    // range, reversed, until left <= 2*right (as the numpy builder does).
    int move = 0;
    while (n_left - move > 1 && (n_left - move) > 2 * ((k - n_left) + move)) move++;
    if (move) {
      int32_t* s = idx + t.begin + n_left - move;
      int32_t* m = idx + t.begin + n_left;
      int32_t* e = idx + t.end;
      std::rotate(s, m, e);
      std::reverse(e - move, e);
      n_left -= move;
    }

    const int cl = next_node++;
    const int cr = next_node++;
    left[t.node] = cl;
    right[t.node] = cr;
    stack.push_back({cr, t.begin + n_left, t.end, t.depth + 1});
    stack.push_back({cl, t.begin, t.begin + n_left, t.depth + 1});
  }
}

}  // namespace

extern "C" {

// prim_lo/prim_hi: [n,3] f32 primitive bounds. Outputs (capacity 2n-1
// nodes): lo/hi [2n-1,3] f32, left/right/prim [2n-1] i32. Returns the node
// count; *out_depth gets the max depth (root = 1). node_begin/node_size
// ([2n-1]) and out_idx ([n], the primitives in DFS leaf order) may be null.
int ptx_build_bvh(const float* prim_lo, const float* prim_hi, int n, float* lo, float* hi,
                  int32_t* left, int32_t* right, int32_t* prim, int32_t* out_depth,
                  int32_t* node_begin, int32_t* node_size, int32_t* out_idx) {
  if (n <= 0) return 0;
  std::vector<int32_t> idx(n);
  for (int i = 0; i < n; i++) idx[i] = i;
  int next_node = 0;
  int max_depth = 0;
  std::vector<BvhTask> stack;
  stack.push_back({next_node++, 0, n, 1});

  const unsigned hw = std::thread::hardware_concurrency();
  const int n_threads = static_cast<int>(hw ? hw : 1);
  if (n_threads <= 1 || n < 65536) {
    bvh_process_stack(prim_lo, prim_hi, idx.data(), lo, hi, left, right, prim, stack, next_node,
                      max_depth, 0, nullptr, node_begin, node_size);
    if (out_idx) std::memcpy(out_idx, idx.data(), n * sizeof(int32_t));
    *out_depth = max_depth;
    return next_node;
  }

  // Phase 1 (serial): split the top levels, deferring every task of at most
  // defer_below primitives. Phase 2: worker threads build the deferred
  // subtrees (disjoint idx ranges and node-id blocks, no locks).
  const int defer_below = std::max(n / (8 * n_threads), 4096);
  std::vector<std::pair<BvhTask, int>> frontier;
  bvh_process_stack(prim_lo, prim_hi, idx.data(), lo, hi, left, right, prim, stack, next_node,
                    max_depth, defer_below, &frontier, node_begin, node_size);

  std::atomic<size_t> cursor{0};
  std::vector<int> depths(n_threads, 0);
  auto worker = [&](int wi) {
    std::vector<BvhTask> wstack;
    int wdepth = 0;
    for (;;) {
      const size_t j = cursor.fetch_add(1);
      if (j >= frontier.size()) break;
      wstack.clear();
      wstack.push_back(frontier[j].first);
      int wnext = frontier[j].second;
      bvh_process_stack(prim_lo, prim_hi, idx.data(), lo, hi, left, right, prim, wstack, wnext,
                        wdepth, 0, nullptr, node_begin, node_size);
    }
    depths[wi] = wdepth;
  };
  std::vector<std::thread> threads;
  threads.reserve(n_threads - 1);
  for (int i = 1; i < n_threads; i++) threads.emplace_back(worker, i);
  worker(0);
  for (auto& t : threads) t.join();
  for (int d : depths) max_depth = std::max(max_depth, d);

  if (out_idx) std::memcpy(out_idx, idx.data(), n * sizeof(int32_t));
  *out_depth = max_depth;
  return next_node;
}

}  // extern "C"
