"""The cluster-major compute stage of the bin-by-cluster intersector (K8).

Port of `cpupathtrace_tpu/accel/pallas_binned.py`:
`binned_intersect_cluster_major`, the counterpart of
`binned_intersect_pallas` (:179-276). After candidate generation and
binning (accel/binned.py), the compute stage finds each binned (ray,
cluster) pair's nearest (t, prim) over the cluster's triangles; the
resolve, the residual round and the spheres are accel/binned.py's.

The TPU kernel of the stage, `_cluster_kernel` (:62, pallas_call :170),
computes K7's per-pair function on another layout (valid at column 10,
prim at column 11, 128-aligned ranges with a sequential read-modify-write
of the tail), with the same tie rule. On the card the stage launches its
own kernel, csrc/cluster_major.cu (`test_candidates`, counted by
`test_candidates.launches`), over K7's cluster blocks (`cluster_blocks`):
each pair's rows are cut into S ranges at 8-row group boundaries, one warp
a range, and the partials merged by the key (t, group, prim).
`split_stage_model` is the plain model of that split and merge;
`_test_candidates`, the plain version, applies the sequential rule.
"""
from __future__ import annotations

import ctypes
import weakref

import torch

from .. import _build
from . import traverse
from .binned import bin_offsets, generate_candidates, resolve
from .kernel_traverse import check_tensor

# The rows are staged in shared memory where a cluster's rows fit
# STAGE_MAX_BYTES (every cluster height the scene build makes for the 200k
# dragon; 7.2M-triangle clusters of ~3,500 rows go through L1), as
# experiments/cluster_major_sweep.py chose (PERF.md §6); the block,
# csrc/cluster_major.cu's kThreads, is the library's (`stage_shape`).
STAGE_MAX_BYTES = 96 * 1024
# The least 8-row groups a row range keeps when the wrapper splits a pair's
# rows: a range's fixed cost (its ray load and its share of the merge) stays
# small beside its row tests.
MIN_RANGE_GROUPS = 4

_BLK_FIELDS = ("blk_v0", "blk_v1", "blk_v2", "blk_cull", "blk_prim")
# id(scene) -> (weak reference to it, its blk_* tensors' ids and versions,
# the packed blocks): a lean or unbinned scene is packed once.
_BLOCKS: dict = {}


def _blk_key(scene):
    return tuple((id(t), t._version) for t in (getattr(scene, f) for f in _BLK_FIELDS))


def cluster_blocks(scene) -> torch.Tensor:
    """K7's [C, L, BLK_COLS] cluster blocks of `scene`, on its device: the
    build's `trv_blocks` where it packed them (binned, not lean), else
    packed from the scene's `blk_*` by traverse.pack_blocks at the first
    call and kept while the scene and those tensors live unchanged."""
    if scene.accel == "binned" and not scene.lean:
        return scene.trv_blocks
    key = id(scene)
    hit = _BLOCKS.get(key)
    if hit is not None and hit[0]() is scene and hit[1] == _blk_key(scene):
        return hit[2]
    blk = (getattr(scene, f).cpu().numpy() for f in _BLK_FIELDS)
    blocks = torch.from_numpy(traverse.pack_blocks(*blk)).to(scene.device)
    _BLOCKS[key] = (weakref.ref(scene, lambda _, k=key: _BLOCKS.pop(k, None)), _blk_key(scene),
                    blocks)
    return blocks


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


# ---------------------------------------------------------------------------
# The split: ranges, the merge, the launch's shape and the launch.
# ---------------------------------------------------------------------------


def range_bounds(groups, splits: int, j: int):
    """Range j of `splits` over `groups` filled 8-row groups (a tensor or an
    int): the groups [j g / S, (j + 1) g / S), as the kernel cuts them."""
    return j * groups // splits, (j + 1) * groups // splits


def merge_key(parts):
    """The kernel's merge of a pair's range partials [(t, group, prim)], in
    range order: the least by the key (t, group, prim). Ranges are
    contiguous and in group order, so it takes range j only by a strictly
    smaller t, as the kernel does."""
    t, g, p = parts[0]
    for tj, gj, pj in parts[1:]:
        take = (tj < t) | ((tj == t) & ((gj < g) | ((gj == g) & (pj < p))))
        t, g, p = torch.where(take, tj, t), torch.where(take, gj, g), torch.where(take, pj, p)
    return t, p


def _range_partial(gmin, gprim, groups, splits, j):
    """One range's partial (t, group, prim) per pair by the group rule: the
    first group of the range at its least t, that group's prim (-1 where
    the range hits nothing); (inf, the range's first group, -1) for an
    empty range."""
    lo, hi = range_bounds(groups, splits, j)
    gi = torch.arange(gmin.shape[1], device=gmin.device)[None, :]
    inside = (gi >= lo[:, None]) & (gi < hi[:, None])
    tg = torch.where(inside, gmin, float("inf"))
    t = tg.amin(1)
    first = torch.where(inside & (tg == t[:, None]), gi, gmin.shape[1]).amin(1)
    first = torch.where(hi > lo, first, lo)
    hit = t < float("inf")
    prim = gprim.gather(1, first.clamp_max(gmin.shape[1] - 1)[:, None])[:, 0]
    return t, first, torch.where(hit, prim, -1.0)


def split_stage_model(blocks, o, d, ids, splits: int, merge=merge_key):
    """The plain model of the kernel's split: each binned (ray, cluster)
    pair's rows up to its cluster's last filled group cut into `splits`
    ranges (`range_bounds`), each range's partial by the group rule, the
    partials merged in range order by `merge`. Returns (t [R, M], prim
    [R, M] i64) in slot order, (inf, -1) for empty slots, as
    `test_candidates`."""
    r, m = ids.shape
    flat = ids.reshape(-1)
    t = torch.full((r * m,), float("inf"), device=o.device)
    p = torch.full((r * m,), -1, dtype=torch.int64, device=o.device)
    groups = traverse.last_filled_groups(blocks).long()
    step = max(1, traverse._CHUNK_ELEMS // blocks.shape[1])
    for a in range(0, r * m, step):
        sel = torch.nonzero(flat[a:a + step] >= 0).squeeze(1) + a
        cl = flat[sel]
        gmin, gprim = traverse.group_minima(blocks[cl], o[sel // m], d[sel // m])
        parts = [_range_partial(gmin, gprim, groups[cl], splits, j) for j in range(splits)]
        ts, ps = merge(parts)
        t[sel] = ts
        p[sel] = torch.where(ts < float("inf"), ps, -1.0).long()
    return t.view(r, m), p.view(r, m)


def stage_splits(rows: int, threads: int) -> int:
    """S, the row ranges a pair, from the shapes alone: doubled from 1
    while the block's warps hold S ranges and each range keeps at least
    MIN_RANGE_GROUPS of the cluster's L / 8 groups. The pairs a query gives
    are known only on the device (most of the R * M slots are empty), so S
    does not wait for them; with many pairs the card is full whatever S."""
    s = 1
    while 2 * s <= threads // 32 and rows // traverse.GROUP_ROWS >= 2 * s * MIN_RANGE_GROUPS:
        s *= 2
    return s


def stage_staged(rows: int) -> bool:
    """Whether the wrapper stages a cluster's rows in shared memory: where
    L rows of 64 bytes fit STAGE_MAX_BYTES (else they go through L1)."""
    return rows * traverse.BLK_COLS * 4 <= STAGE_MAX_BYTES


def item_pairs(threads: int, splits: int) -> int:
    """Pairs of a work item: 32 a slot, threads / 32 / S slots a block."""
    return 32 * (threads // 32 // splits)


def stage_grid(n_slots: int, n_clusters: int, pairs_per_item: int, blocks_per_sm: int,
               sms: int) -> int:
    """The launch's grid from the shapes alone: the bound on the work
    items (traverse.work_items: ceil(R M / item pairs) + C), at most the
    resident blocks. Raises ValueError when no block fits an SM."""
    if blocks_per_sm < 1:
        raise ValueError("no block of the stage's kernel fits an SM")
    bound = -(-n_slots // pairs_per_item) + n_clusters
    return max(1, min(bound, blocks_per_sm * sms))


def _stage_fn():
    fn = _build.load("cluster_major").ptx_cluster_major_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        # blocks C L o d order n_slots m offs chunk_start groups grid splits
        # staged t prim stream
        fn.argtypes = [p, i, i, p, p, p, i, i, p, p, p, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _library_shape(staged: bool, rows: int):
    """(threads a block, resident blocks per SM) of the loaded library's
    instance `staged` at L = `rows` (the staged rows' shared memory), on
    the current card."""
    fn = _build.load("cluster_major").ptx_cluster_major_shape
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
        fn.restype = ctypes.c_int
    threads, per_sm = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(int(staged), rows, ctypes.byref(threads), ctypes.byref(per_sm))
    if err:
        raise RuntimeError(f"cluster_major shape query failed: cudaError_t {err}")
    return threads.value, per_sm.value


# (library, card, staged, L) -> _library_shape.
_SHAPES: dict = {}


def stage_shape(blocks, n_slots: int, splits=None, staged=None):
    """The launch's shape from the shapes alone, on the blocks' card: the
    block (threads: the library's), S (`splits`), the row source
    (`staged`), item_pairs, the resident blocks per SM and the grid.
    `splits` and `staged` default to the wrapper's choice (`stage_splits`,
    `stage_staged`)."""
    dev = blocks.device
    c, l = blocks.shape[0], blocks.shape[1]
    staged = stage_staged(l) if staged is None else bool(staged)
    with torch.cuda.device(dev):
        key = (_build.load("cluster_major")._name, torch.cuda.current_device(), staged, l)
        if key not in _SHAPES:
            _SHAPES[key] = _library_shape(staged, l)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
    threads, per_sm = _SHAPES[key]
    splits = stage_splits(l, threads) if splits is None else splits
    if splits < 1 or splits & (splits - 1) or splits > threads // 32:
        raise ValueError(f"splits {splits}: need a power of two up to {threads // 32}")
    per_item = item_pairs(threads, splits)
    return dict(threads=threads, splits=splits, staged=staged, item_pairs=per_item,
                blocks_per_sm=per_sm, grid=stage_grid(n_slots, c, per_item, per_sm, sms))


def stage_run(blocks, o, d, order, offs, m: int, splits=None, staged=None):
    """csrc/cluster_major.cu on binned pairs: the work list (chunk_start,
    built on the device from the bin offsets) and one launch, with no host
    read. `order` [R*M] i64 and `offs` [C+1] i32 are `bin_offsets` of the
    [R, M] candidate ids; `splits`, `staged` as `stage_shape`'s. Returns
    (t [R, M] f32, prim [R, M] i64) in slot order, every slot written by the
    kernel. Counted by `test_candidates.launches`."""
    dev = o.device
    r = o.shape[0]
    n = r * m
    c, l = blocks.shape[0], blocks.shape[1]
    check_tensor("o", o, dev, torch.float32, (r, 3))
    check_tensor("d", d, dev, torch.float32, (r, 3))
    check_tensor("order", order, dev, torch.int64, (n,))
    check_tensor("offs", offs, dev, torch.int32, (c + 1,))
    check_tensor("blocks", blocks, dev, torch.float32, (None, None, traverse.BLK_COLS))
    if l % traverse.GROUP_ROWS or l == 0:
        raise ValueError(f"cluster height {l}: need a positive multiple of {traverse.GROUP_ROWS}")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks: the row loads need a 16-byte aligned tensor")
    t = torch.empty(n, device=dev)
    p = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        shape = stage_shape(blocks, n, splits, staged)
        chunk_start, _ = traverse.work_items(offs, n, shape["item_pairs"])
        with torch.cuda.device(dev):
            err = _stage_fn()(blocks.data_ptr(), c, l, o.data_ptr(), d.data_ptr(),
                              order.data_ptr(), n, m, offs.data_ptr(), chunk_start.data_ptr(),
                              traverse.filled_groups(blocks).data_ptr(), shape["grid"],
                              shape["splits"], int(shape["staged"]), t.data_ptr(),
                              p.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"cluster_major launch failed: cudaError_t {err}")
        test_candidates.launches += 1
    return t.view(r, m), p.view(r, m)


def test_candidates(blocks, o, d, ids):
    """The compute stage on [R, M] candidate ids (i64, -1 for an empty
    slot) over `blocks` (`cluster_blocks`): (t [R, M], prim [R, M] i64),
    (inf, -1) where a slot hits nothing. CPU tensors take the plain
    version; CUDA tensors bin the slots (`bin_offsets`) and launch
    csrc/cluster_major.cu once (`stage_run`), with no host read."""
    dev = o.device
    if dev.type == "cpu":
        return _test_candidates(blocks, o, d, ids)
    if dev.type != "cuda":
        raise ValueError(f"test_candidates: no kernel for device {dev}")
    check_tensor("ids", ids, dev, torch.int64, (o.shape[0], None))
    order, _, offs = bin_offsets(ids, blocks.shape[0])
    return stage_run(blocks, o, d, order, offs, ids.shape[1])


test_candidates.launches = 0


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
