"""Flat BVH construction on the host: numpy, and a C++ copy for large inputs.

Port of `cpupathtrace_tpu/accel/build.py:build_bvh` and of the native
builder it calls (`cpupathtrace_tpu/native/src/ptx_native.cpp`
`ptx_build_bvh`). The policy is the reference's (ref:
src/scene/scene.cpp:12-102): top-down, per-axis median of box minima, the
split axis minimising the summed surface area of the two child boxes,
stable partition by `low[axis] <= median`, and the left <= 2 * right
rebalance. One primitive per leaf. Both builders give the same tree.

The C++ builder (csrc/bvh_build.cpp) runs for n >= NATIVE_THRESHOLD, as in
the JAX package. It is compiled with g++ on first use (`_build.load_host`);
a failed build raises, it never falls back to numpy. `build_bvh.runs`
counts which builder ran.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from .. import _build

#: Primitive count from which the C++ builder runs.
NATIVE_THRESHOLD = 512


@dataclasses.dataclass
class FlatBVH:
    lo: np.ndarray  # [N,3] f32
    hi: np.ndarray  # [N,3] f32
    left: np.ndarray  # [N] i32 child node index (valid on internal nodes)
    right: np.ndarray  # [N] i32
    prim: np.ndarray  # [N] i32 primitive index on leaves, -1 on internal
    depth: int  # max tree depth (root = 1)


def _surface_area_cost(lo: np.ndarray, hi: np.ndarray, mask: np.ndarray) -> float:
    """Summed surface areas of the two boxes of a `mask` partition; an
    empty side costs +inf (ref: src/scene/scene.cpp:41-62)."""
    total = 0.0
    for side in (mask, ~mask):
        if not side.any():
            total += np.inf
            continue
        d = hi[side].max(axis=0) - lo[side].min(axis=0)
        total += 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])
    return total


def _native_fn():
    lib = _build.load_host("bvh_build")
    fn = lib.ptx_build_bvh
    if fn.argtypes is None:
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int32)
        fn.argtypes = [fp, fp, ctypes.c_int, fp, fp, ip, ip, ip, ip, ip, ip, ip]
        fn.restype = ctypes.c_int
    return fn


def build_bvh_native(prim_lo: np.ndarray, prim_hi: np.ndarray,
                     want_subtree_info: bool = False):
    """The C++ build: (lo, hi, left, right, prim, depth), and with
    `want_subtree_info` also (node_begin, node_size, dfs_prims): each
    node's first-leaf DFS rank and subtree size, and the primitives in DFS
    leaf order (what the cluster cut consumes)."""
    fn = _native_fn()
    build_bvh.runs["native"] += 1
    n = int(prim_lo.shape[0])
    prim_lo = np.ascontiguousarray(prim_lo, np.float32)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32)
    cap = max(2 * n - 1, 1)
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    left = np.empty(cap, np.int32)
    right = np.empty(cap, np.int32)
    prim = np.empty(cap, np.int32)
    begin = np.empty(cap, np.int32)
    size = np.empty(cap, np.int32)
    dfs = np.empty(max(n, 1), np.int32)
    depth = np.zeros(1, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    count = fn(fp(prim_lo), fp(prim_hi), n, fp(lo), fp(hi), ip(left), ip(right),
               ip(prim), ip(depth), ip(begin), ip(size), ip(dfs))
    base = (lo[:count], hi[:count], left[:count], right[:count], prim[:count],
            int(depth[0]))
    if want_subtree_info:
        return base + (begin[:count], size[:count], dfs[:n])
    return base


def build_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
              use_native: bool | None = None) -> FlatBVH:
    """Build the flat BVH over primitive bounds [P,3] / [P,3].
    `use_native=None` takes the C++ builder for P >= NATIVE_THRESHOLD."""
    n = prim_lo.shape[0]
    prim_lo = np.asarray(prim_lo, np.float32)
    prim_hi = np.asarray(prim_hi, np.float32)
    if use_native is None:
        use_native = n >= NATIVE_THRESHOLD
    if use_native and n > 0:
        lo, hi, left, right, prim, depth = build_bvh_native(prim_lo, prim_hi)
        return FlatBVH(lo=lo, hi=hi, left=left, right=right, prim=prim, depth=depth)

    build_bvh.runs["numpy"] += 1
    max_nodes = max(2 * n - 1, 1)
    lo = np.zeros((max_nodes, 3), np.float32)
    hi = np.zeros((max_nodes, 3), np.float32)
    left = np.full(max_nodes, -1, np.int32)
    right = np.full(max_nodes, -1, np.int32)
    leaf_prim = np.full(max_nodes, -1, np.int32)
    next_node = 1
    max_depth = 0
    # Work stack of (node, prim indices, depth); children are pushed right
    # first so the left subtree is built (and numbered) first.
    stack: list[tuple[int, np.ndarray, int]] = [(0, np.arange(n, dtype=np.int64), 1)]
    while stack:
        node, idx, depth = stack.pop()
        max_depth = max(max_depth, depth)
        k = idx.shape[0]
        l_sub = prim_lo[idx]
        h_sub = prim_hi[idx]
        lo[node] = l_sub.min(axis=0)
        hi[node] = h_sub.max(axis=0)
        if k == 1:
            leaf_prim[node] = idx[0]
            continue
        # Median of box minima per axis: the (k//2 - 1)-th order statistic
        # (ref: scene.cpp:25-36); ties keep the lowest axis.
        m_pos = max(k // 2 - 1, 0)
        best_cost, best_mask = None, None
        for axis in range(3):
            med = np.partition(l_sub[:, axis], m_pos)[m_pos]
            mask = l_sub[:, axis] <= med
            cost = _surface_area_cost(l_sub, h_sub, mask)
            if best_cost is None or cost < best_cost:
                best_cost, best_mask = cost, mask
        left_idx = idx[best_mask]
        right_idx = idx[~best_mask]
        # Rebalance: move the last left entries over, reversed, until
        # left <= 2 * right (ref: scene.cpp:90-94).
        n_left = left_idx.shape[0]
        n_right = right_idx.shape[0]
        move = 0
        while n_left - move > 1 and (n_left - move) > 2 * (n_right + move):
            move += 1
        if move:
            right_idx = np.concatenate([right_idx, left_idx[n_left - move:][::-1]])
            left_idx = left_idx[: n_left - move]
        cl, cr = next_node, next_node + 1
        next_node += 2
        left[node] = cl
        right[node] = cr
        stack.append((cr, right_idx, depth + 1))
        stack.append((cl, left_idx, depth + 1))
    return FlatBVH(lo=lo[:next_node], hi=hi[:next_node], left=left[:next_node],
                   right=right[:next_node], prim=leaf_prim[:next_node], depth=max_depth)


# Which builder ran, per call (reported by chip_smoke.py's build split).
build_bvh.runs = {"native": 0, "numpy": 0}
