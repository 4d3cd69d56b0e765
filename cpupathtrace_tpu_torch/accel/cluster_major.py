"""The cluster-major compute stage of the bin-by-cluster intersector (K8).

Port of `cpupathtrace_tpu/accel/pallas_binned.py`:
`binned_intersect_cluster_major`, the counterpart of
`binned_intersect_pallas` (:179-276). After candidate generation and
binning (accel/binned.py), the compute stage finds each binned (ray,
cluster) pair's nearest (t, prim) over the cluster's triangles; the
resolve, the residual round and the spheres are accel/binned.py's.

The TPU kernel of the stage, `_cluster_kernel` (:62, pallas_call :170),
computes the same per-pair function as K7 (`_isect_kernel`) on another
layout (valid at column 10, prim at column 11, 128-aligned ranges with a
sequential read-modify-write of the tail), with the same tie rule. On the
card the stage launches K7's kernel (csrc/binned_isect.cu through
accel/traverse.py `isect`, whose launch counter counts it) on the binned
pairs, over K7's own cluster blocks (`cluster_blocks`); the plain version,
`_test_candidates`, applies the same rule in torch.
"""
from __future__ import annotations

import torch

from . import traverse
from .binned import bin_candidates, generate_candidates, resolve


def cluster_blocks(scene) -> torch.Tensor:
    """K7's [C, L, BLK_COLS] cluster blocks of `scene`, on its device: the
    build's `trv_blocks` where it packed them (binned, not lean), else
    packed here from the scene's `blk_*` by traverse.pack_blocks."""
    if scene.accel == "binned" and not scene.lean:
        return scene.trv_blocks
    blk = (getattr(scene, f).cpu().numpy()
           for f in ("blk_v0", "blk_v1", "blk_v2", "blk_cull", "blk_prim"))
    return torch.from_numpy(traverse.pack_blocks(*blk)).to(scene.device)


def _test_candidates(blocks, o, d, ids):
    """The plain version of the compute stage: the nearest (t [R, M],
    prim [R, M]) of each candidate slot over its cluster's rows, by the
    kernels' rule (traverse.nearest_in_rows); (inf, -1) for empty slots."""
    _test_candidates.calls += 1
    r, m = ids.shape
    flat = ids.reshape(-1)
    t = torch.full((r * m,), float("inf"), device=o.device)
    p = torch.full((r * m,), -1, dtype=torch.int64, device=o.device)
    step = max(1, traverse._CHUNK_ELEMS // blocks.shape[1])
    for a in range(0, r * m, step):
        sel = torch.nonzero(flat[a:a + step] >= 0).squeeze(1) + a
        t[sel], p[sel] = traverse.nearest_in_rows(blocks[flat[sel]], o[sel // m], d[sel // m])
    return t.view(r, m), p.view(r, m)


_test_candidates.calls = 0


def test_candidates(blocks, o, d, ids):
    """The compute stage on [R, M] candidate ids over `blocks`
    (`cluster_blocks`): bin the pairs by cluster, run K7's per-pair
    function on them (the kernel for CUDA tensors, its plain version on the
    CPU), and put the results back in slot order."""
    if o.device.type == "cpu":
        return _test_candidates(blocks, o, d, ids)
    r, m = ids.shape
    c = blocks.shape[0]
    order, _, counts = bin_candidates(ids, c)
    offs = torch.zeros(c + 1, dtype=torch.int32, device=o.device)
    offs[1:] = torch.cumsum(counts, 0)
    ray_of = order // m  # pair p = r * M + s
    rays = torch.cat([o.t(), d.t()])[:, ray_of].contiguous()
    t_sorted, p_sorted = traverse.isect(blocks, rays, offs)
    t = torch.empty_like(t_sorted)
    p = torch.empty_like(p_sorted)
    t[order] = t_sorted
    p[order] = p_sorted
    return t.view(r, m), p.view(r, m).long()


def binned_intersect_cluster_major(scene, o, d, max_candidates: int = 4, blocks=None):
    """Exact nearest hit with the cluster-major compute stage (the
    counterpart of `binned_intersect_pallas`): candidates and binning as
    accel/binned.py, the stage above, then its resolve with the residual
    sweep and the spheres. o, d: [R, 3]; `blocks`: `cluster_blocks(scene)`,
    made here when None. Returns (t [R], prim [R] i64), -1 / -1 on a miss."""
    o = o.detach().to(torch.float32).contiguous()
    d = d.detach().to(torch.float32).contiguous()
    if blocks is None:
        blocks = cluster_blocks(scene)
    ids, entry = generate_candidates(scene, o, d, max_candidates)
    t_cand, p_cand = test_candidates(blocks, o, d, ids)
    return resolve(scene, o, d, entry, t_cand, p_cand)
