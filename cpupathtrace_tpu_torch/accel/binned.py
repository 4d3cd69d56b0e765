"""Bin-by-cluster machinery in plain torch: candidate generation, binning
and the exact resolve, with a dense compute stage.

Port of `cpupathtrace_tpu/accel/binned.py`. `binned_intersect` is the
oracle of the cluster-major entry point of accel/cluster_major.py, which
replaces `test_candidates` with the K7 kernel; the wavefront's own binned
intersector is accel/traverse.py.
"""
from __future__ import annotations

import torch

from ..ops.intersect import (
    _nearest_in_blocks,
    _nearest_sphere,
    intersect_aabb,
    sweep_intersect,
    top_k_smallest,
)


def generate_candidates(scene, o, d, max_candidates: int):
    """Per ray, the clusters whose box the ray enters, nearest first:
    (cluster ids [R, M] i64, entry t [R, M]) with -1 / inf padding, M =
    max_candidates (binned.py:25-42). Ties of entry keep the lower id."""
    t_c = intersect_aabb(o[:, None, :], d[:, None, :], scene.blk_lo[None], scene.blk_hi[None])
    valid = (scene.blk_prim >= 0).any(dim=1)
    t_c = torch.where((t_c >= 0.0) & valid[None, :], t_c, float("inf"))
    vals, idx = top_k_smallest(t_c, min(max_candidates, t_c.shape[1]))
    has = torch.isfinite(vals)
    return torch.where(has, idx, -1), torch.where(has, vals, float("inf"))


def bin_candidates(cluster_ids, n_clusters: int):
    """Flattened (ray, slot) candidates ordered by cluster (binned.py:45-61):
    (order [R*M] into the flat list, sorted cluster keys [R*M], counts [C]);
    empty slots key n_clusters and sort last. The sort is stable."""
    flat = cluster_ids.reshape(-1)
    key = torch.where(flat >= 0, flat, n_clusters)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_clusters + 1)[:n_clusters]
    return order, key[order], counts


def test_candidates(scene, o, d, cluster_ids):
    """The dense compute stage (`_test_candidates_jnp`, binned.py:64-85):
    the nearest (t [R, M], prim [R, M]) within each candidate cluster, the
    first of equal-t rows winning (argmin); (inf, -1) for empty slots."""
    r, m = cluster_ids.shape
    t = torch.empty((r, m), device=o.device)
    p = torch.empty((r, m), dtype=torch.int64, device=o.device)
    for s in range(m):
        t[:, s], p[:, s] = _nearest_in_blocks(scene, o, d, cluster_ids[:, s:s + 1])
    return t, p


def resolve(scene, o, d, entry, t_cand, p_cand):
    """The nearest candidate per ray, then the residual round: rays whose
    M slots are all used and whose farthest candidate entry beats the hit
    take the sweep's exact answer; then the spheres (binned.py:99-141).
    Returns (t [R], prim [R]), -1 / -1 on a miss."""
    j = t_cand.argmin(1, keepdim=True)
    best_t = t_cand.gather(1, j)[:, 0]
    best_p = p_cand.gather(1, j)[:, 0]
    worst_entry = torch.where(torch.isfinite(entry), entry, -float("inf")).amax(1)
    needs_residual = torch.isfinite(entry[:, -1]) & (worst_entry < best_t)
    if scene.n_tri and bool(needs_residual.any()):
        rt, rp = sweep_intersect(scene, o, d)
        rt = torch.where(rt < 0.0, float("inf"), rt)
        best_t = torch.where(needs_residual, rt, best_t)
        best_p = torch.where(needs_residual, rp, best_p)
    best_p = torch.where(torch.isfinite(best_t), best_p, -1)
    best_t, best_p = _nearest_sphere(scene, o, d, best_t, best_p)
    hit = (best_p >= 0) & torch.isfinite(best_t)
    return torch.where(hit, best_t, -1.0), torch.where(hit, best_p, -1)


def binned_intersect(scene, o, d, max_candidates: int = 8):
    """Exact nearest hit by candidate generation and resolve, with the
    dense compute stage (binned.py:88-141). o, d: [R, 3]."""
    o, d = o.detach(), d.detach()
    ids, entry = generate_candidates(scene, o, d, max_candidates)
    t_cand, p_cand = test_candidates(scene, o, d, ids)
    return resolve(scene, o, d, entry, t_cand, p_cand)
