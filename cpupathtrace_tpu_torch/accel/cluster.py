"""The two-level cluster structure: the flat BVH cut into spatially coherent
clusters of up to `cluster_size` primitives, emitted in left-first DFS
order, and a top tree over the clusters' bounds.

Port of `cpupathtrace_tpu/accel/cluster.py:build_cluster_bvh` (`ClusterBVH`).
A cluster is the subtree of the first node, walking from the root, that
holds at most `cluster_size` primitives; its members are a contiguous run
of the DFS leaf order and its bounds are that node's stored bounds. The
top tree (`lo`, `hi`, `left`, `right`, `cluster`, `depth`) is the flat BVH
over the cluster bounds: the cluster walker of ops/intersect.py descends
it. The in-kernel traversal tiers read only `members`, `c_lo` and `c_hi`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .build import NATIVE_THRESHOLD, build_bvh, build_bvh_native


@dataclasses.dataclass
class ClusterBVH:
    # Top tree over the clusters: `cluster` holds the cluster id on leaves.
    lo: np.ndarray  # [N, 3] f32
    hi: np.ndarray  # [N, 3] f32
    left: np.ndarray  # [N] i32
    right: np.ndarray  # [N] i32
    cluster: np.ndarray  # [N] i32 cluster id on leaves, -1 on internal nodes
    depth: int
    members: np.ndarray  # [C, L] i32 primitive indices, -1 padding
    c_lo: np.ndarray  # [C, 3] f32 cluster bounds
    c_hi: np.ndarray  # [C, 3] f32
    n_clusters: int
    cluster_size: int


def _members(starts, lens, order, cluster_size):
    c = starts.shape[0]
    members = np.full((c, cluster_size), -1, np.int32)
    cols = np.arange(cluster_size, dtype=np.int64)
    in_run = cols[None, :] < lens[:, None]
    gather = starts[:, None] + np.minimum(cols[None, :], lens[:, None] - 1)
    members[in_run] = order[gather[in_run]]
    return members


def _with_top_tree(members, c_lo, c_hi, cluster_size, use_native):
    top = build_bvh(c_lo, c_hi, use_native=use_native)
    return ClusterBVH(lo=top.lo, hi=top.hi, left=top.left, right=top.right,
                      cluster=top.prim, depth=top.depth, members=members,
                      c_lo=c_lo, c_hi=c_hi, n_clusters=members.shape[0],
                      cluster_size=cluster_size)


def build_cluster_bvh(prim_lo: np.ndarray, prim_hi: np.ndarray,
                      cluster_size: int = 64,
                      use_native: bool | None = None) -> ClusterBVH:
    """Cut the flat BVH over primitive bounds [P,3] into clusters and build
    the top tree over them."""
    n = prim_lo.shape[0]
    if (use_native is None and n >= NATIVE_THRESHOLD) or use_native:
        # The C++ builder hands back each node's first-leaf DFS rank and
        # subtree size, and the DFS primitive order: no tree sweeps needed.
        lo, hi, left, right, prim, _, begin, size, dfs = build_bvh_native(
            np.asarray(prim_lo, np.float32), np.asarray(prim_hi, np.float32),
            want_subtree_info=True,
        )
        leaf = prim >= 0
        parent_size = np.full(size.shape[0], np.iinfo(np.int32).max, np.int64)
        internal = np.flatnonzero(~leaf)
        parent_size[left.astype(np.int64)[internal]] = size[internal]
        parent_size[right.astype(np.int64)[internal]] = size[internal]
        cut = np.flatnonzero((size <= cluster_size) & (parent_size > cluster_size))
        cut = cut[np.argsort(begin[cut], kind="stable")]
        starts = begin[cut].astype(np.int64)
        lens = size[cut].astype(np.int64)
        members = _members(starts, lens, dfs, cluster_size)
        return _with_top_tree(members, lo[cut].astype(np.float32),
                              hi[cut].astype(np.float32), cluster_size, use_native)

    base = build_bvh(prim_lo, prim_hi, use_native=use_native)
    # Level-by-level numpy sweeps: levels (root -> children), subtree sizes
    # (bottom-up), DFS first-leaf ranks (top-down: the left child inherits,
    # the right adds the left subtree's size), then the cut.
    n_nodes = base.prim.shape[0]
    leaf = base.prim >= 0
    left = base.left.astype(np.int64)
    right = base.right.astype(np.int64)
    levels: list[np.ndarray] = [np.zeros(1, np.int64)]
    while True:
        inner = levels[-1][~leaf[levels[-1]]]
        if inner.size == 0:
            break
        levels.append(np.concatenate([left[inner], right[inner]]))
    size = np.where(leaf, 1, 0).astype(np.int64)
    for lvl in reversed(levels):
        inner = lvl[~leaf[lvl]]
        size[inner] = size[left[inner]] + size[right[inner]]
    leaf_start = np.zeros(n_nodes, np.int64)
    for lvl in levels:
        inner = lvl[~leaf[lvl]]
        leaf_start[left[inner]] = leaf_start[inner]
        leaf_start[right[inner]] = leaf_start[inner] + size[left[inner]]
    parent_size = np.full(n_nodes, np.iinfo(np.int64).max, np.int64)
    internal = np.flatnonzero(~leaf)
    parent_size[left[internal]] = size[internal]
    parent_size[right[internal]] = size[internal]
    cut = np.flatnonzero((size <= cluster_size) & (parent_size > cluster_size))
    cut = cut[np.argsort(leaf_start[cut], kind="stable")]
    leaf_nodes = np.flatnonzero(leaf)
    ordered = np.empty(n, np.int64)
    ordered[leaf_start[leaf_nodes]] = base.prim[leaf_nodes]
    members = _members(leaf_start[cut], size[cut], ordered, cluster_size)
    return _with_top_tree(members, base.lo[cut].astype(np.float32),
                          base.hi[cut].astype(np.float32), cluster_size, use_native)
