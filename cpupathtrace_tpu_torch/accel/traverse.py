"""The binned wavefront: the large-scene intersector of the wavefront path.

Port of `cpupathtrace_tpu/accel/pallas_traverse.py` (the `pallas_` prefix
dropped, as for integrator/megakernel.py). Per query, over the
small-triangle partition of a binned scene:

  1. K6, the candidate scan (csrc/binned_cand.cu, the port of
     `_cand_kernel` :121): per ray, the slab test against every cluster
     box, keeping the top-M (entry, id) candidates in lexicographic order
     above the bound (t_lo, id_lo) and below the ray's best hit, plus the
     (M+1)-th as the overflow row.
  2. Binning: the M candidate slots of each ray become (ray, cluster)
     pairs, ordered by cluster with one stable argsort; `bincount` and
     `cumsum` give each cluster's range.
  3. K7, the cluster-major intersect (csrc/binned_isect.cu, the port of
     `_isect_kernel` :238): per pair, the nearest (t, prim) over the
     cluster's triangles.
  4. Resolve: the nearest over the M slots per ray; then the exactness
     rounds: a ray whose overflow entry still beats its best hit runs
     1-3 again with the lower bound advanced past the clusters it has
     tested. The bound advances strictly through a finite cluster set, so
     the loop ends, and the result is the exact nearest hit.

The big triangles and the spheres are tested for every ray first
(`_dense_part`, through K5 on the card), and only rays that enter the
small partition's root box before that hit reach the rounds.

On a CUDA device the pipeline launches K6, K7 and K5; on the CPU the same
pipeline runs their plain versions (`candidates_reference`,
`isect_reference`, `dense_intersect_reference`). The TPU pipeline moved
data only with sorts (a TPU measurement); on the card the glue is one
stable argsort per round and index gathers and scatters. Its flags are
read on the host: the live count once per query and the pending flag once
per round (`binned_intersect.host_reads`).

Layouts (the port's own): cluster blocks [C, L, 16] f32, one row per
triangle: v0 (0:3), e1 (3:6), e2 (6:9), cull (9), prim (10, f32, -1 on
padding rows), zeros; bounds [C, 8]: lo (0:3), hi (3:6), valid (6).
`untile_blocks` turns the TPU's [C, L/64, 8, 128] tile layout into it.

Geometry is not differentiable on this path (pallas_traverse.py:37-39):
rays and bounds enter detached.
"""
from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from .. import _build
from .kernel_traverse import _inv_dir, check_tensor

FLT_MAX = 3.4028234663852886e38
TRI_EPS = 1e-6
BLK_COLS = 16  # cluster block row: v0 e1 e2 cull prim, zeros
BND_COLS = 8  # cluster bounds row: lo hi valid, zero
C_CULL, C_PRIM = 9, 10
RAY_ROWS = 9  # K6's ray planes: o (3), d (3), best, t_lo, id_lo
GROUP_ROWS = 8  # K7's tie group: 8 consecutive rows
M_ROWS = 8  # at most 7 candidate slots + the overflow row
# K7's work item (csrc/binned_isect.cu kItemPairs): 128 threads of one pair.
ITEM_PAIRS = 128
# The largest cluster count of a binned scene: K6 keeps the bounds table
# (32 bytes a cluster, 128 KB at 4096) in one block's shared memory.
MAX_CLUSTERS = 4096
DEFAULT_BATCH = 1 << 17
# The plain versions hold at most this many (pair, triangle) tests or
# (cluster, ray) entries at once.
_CHUNK_ELEMS = 1 << 22
_CAND_CHUNK = 1 << 25


# ---------------------------------------------------------------------------
# Host-side packing (scene build).
# ---------------------------------------------------------------------------


def pack_blocks(blk_v0, blk_v1, blk_v2, blk_cull, blk_prim) -> np.ndarray:
    """[C, L, BLK_COLS] f32 cluster blocks (the components of
    pack_blocks_np, pallas_traverse.py:68-96, row-major)."""
    v0 = np.asarray(blk_v0, np.float32)
    prim = np.asarray(blk_prim)
    c, l, _ = v0.shape
    if l % GROUP_ROWS:
        raise ValueError(f"cluster_size must be a multiple of {GROUP_ROWS}")
    if prim.max(initial=0) >= 2 ** 24:
        raise ValueError("binned traversal carries prim ids as f32 (< 2^24)")
    out = np.zeros((c, l, BLK_COLS), np.float32)
    out[:, :, 0:3] = v0
    out[:, :, 3:6] = np.asarray(blk_v1, np.float32) - v0
    out[:, :, 6:9] = np.asarray(blk_v2, np.float32) - v0
    out[:, :, C_CULL] = np.asarray(blk_cull)
    out[:, :, C_PRIM] = prim
    return out


def pack_bounds(blk_lo, blk_hi, valid=None) -> np.ndarray:
    """[C, BND_COLS] f32 cluster bounds for K6 (pack_bounds_np,
    pallas_traverse.py:99-114)."""
    lo = np.asarray(blk_lo, np.float32)
    c = lo.shape[0]
    if c > MAX_CLUSTERS:
        raise ValueError(f"{c} clusters exceed K6's bounds table ({MAX_CLUSTERS}); "
                         "increase cluster_size")
    out = np.zeros((c, BND_COLS), np.float32)
    out[:, 0:3] = lo
    out[:, 3:6] = np.asarray(blk_hi, np.float32)
    out[:, 6] = 1.0 if valid is None else np.asarray(valid, np.float32)
    return out


def untile_blocks(tiled) -> np.ndarray:
    """The TPU's [C, L/64, 8, 128] tile layout (row = tile*64 + octet*8 +
    sub at [c, tile, sub, octet*16 + comp]) as the port's [C, L, 16]."""
    a = np.asarray(tiled, np.float32)
    c, tiles = a.shape[:2]
    a = a.reshape(c, tiles, 8, 8, BLK_COLS).transpose(0, 1, 3, 2, 4)
    return np.ascontiguousarray(a.reshape(c, tiles * 64, BLK_COLS))


def placeholder_tables():
    """(blocks, bounds) of a scene without binned-wavefront tables."""
    return (np.zeros((1, GROUP_ROWS, BLK_COLS), np.float32),
            np.zeros((1, BND_COLS), np.float32))


# ---------------------------------------------------------------------------
# K6: the candidate scan.
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


def _slab_entries(bounds, ox, oy, oz, ix, iy, iz):
    """(entry, ok-without-bound) of every (cluster, ray) pair [C, n], in
    `_cand_kernel`'s operations and order."""
    b = [bounds[:, j, None] for j in range(7)]
    t1x, t2x = (b[0] - ox) * ix, (b[3] - ox) * ix
    t1y, t2y = (b[1] - oy) * iy, (b[4] - oy) * iy
    t1z, t2z = (b[2] - oz) * iz, (b[5] - oz) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    entry = torch.where(tmin < 0.0, 0.0, tmin)
    return entry, (b[6] > 0.5) & (tmax >= 0.0) & (tmin <= tmax)


def candidates_reference(bounds, rays, m: int):
    """The plain version of K6: (ids [m+1, n] i32, entries [m+1, n] f32)
    of rays [RAY_ROWS, n], -1 / inf in empty slots. The slab tests of all
    clusters at once, then `_cand_kernel`'s insertion, cluster by cluster
    in ascending order."""
    candidates_reference.calls += 1
    n = rays.shape[1]
    c = bounds.shape[0]
    dev = rays.device
    ids = torch.full((m + 1, n), -1, dtype=torch.int32, device=dev)
    ent = torch.full((m + 1, n), float("inf"), device=dev)
    step = max(1, _CAND_CHUNK // max(c, 1))
    for a in range(0, n, step):
        ox, oy, oz, dx, dy, dz, best, t_lo, id_lo = rays[:, a:a + step]
        entry, box_ok = _slab_entries(bounds, ox, oy, oz, _inv_dir(dx), _inv_dir(dy), _inv_dir(dz))
        inf = torch.full_like(ox, float("inf"))
        e = [inf] * (m + 1)
        cid = [inf] * (m + 1)
        for k in range(c):
            ek = entry[k]
            cf = float(k)
            after = (ek > t_lo) | ((ek == t_lo) & (cf > id_lo))
            ok = box_ok[k] & (ek < best) & after
            ce = torch.where(ok, ek, inf)
            ci = torch.where(ok, cf, inf)
            for j in range(m):
                less = (ce < e[j]) | ((ce == e[j]) & (ci < cid[j]))
                e[j], ce = torch.where(less, ce, e[j]), torch.where(less, e[j], ce)
                cid[j], ci = torch.where(less, ci, cid[j]), torch.where(less, cid[j], ci)
            less = (ce < e[m]) | ((ce == e[m]) & (ci < cid[m]))
            e[m] = torch.where(less, ce, e[m])
            cid[m] = torch.where(less, ci, cid[m])
        es = torch.stack(e)
        ent[:, a:a + step] = es
        ids[:, a:a + step] = torch.where(es < float("inf"), torch.stack(cid), -1.0).to(torch.int32)
    return ids, ent


candidates_reference.calls = 0


def _cand_fn():
    lib = _build.load("binned_cand")
    fn = lib.ptx_binned_cand_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _P, _I, _I, _P, _P, _P]  # bounds C rays n m ids ent stream
        fn.restype = ctypes.c_int
    return fn


def candidates(bounds, rays, m: int):
    """K6: per ray of `rays` [RAY_ROWS, n] f32 (planes ox oy oz dx dy dz
    best t_lo id_lo), the top-`m` candidate clusters of `bounds`
    [C, BND_COLS] above the lexicographic bound (t_lo, id_lo) and below
    best, plus the overflow row: (ids [m+1, n] i32, entries [m+1, n]
    f32), -1 / inf in empty slots. CPU tensors take the plain version;
    CUDA tensors launch csrc/binned_cand.cu."""
    dev = rays.device
    if not 1 <= m <= M_ROWS - 1:
        raise ValueError(f"m = {m}: need 1 <= m <= {M_ROWS - 1}")
    if dev.type == "cpu":
        return candidates_reference(bounds, rays, m)
    if dev.type != "cuda":
        raise ValueError(f"candidates: no kernel for device {dev}")
    n = rays.shape[1]
    check_tensor("rays", rays, dev, torch.float32, (RAY_ROWS, n))
    check_tensor("bounds", bounds, dev, torch.float32, (None, BND_COLS))
    if not 1 <= bounds.shape[0] <= MAX_CLUSTERS:
        raise ValueError(f"{bounds.shape[0]} clusters: K6 takes 1..{MAX_CLUSTERS}")
    ids = torch.empty((m + 1, n), dtype=torch.int32, device=dev)
    ent = torch.empty((m + 1, n), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = _cand_fn()(bounds.data_ptr(), bounds.shape[0], rays.data_ptr(), n, m,
                             ids.data_ptr(), ent.data_ptr(),
                             torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"binned_cand launch failed: cudaError_t {err}")
        candidates.launches += 1
    return ids, ent


candidates.launches = 0


# ---------------------------------------------------------------------------
# K7: the cluster-major intersect.
# ---------------------------------------------------------------------------


def nearest_in_rows(rows, o, d):
    """Nearest (t [P], prim [P] i64) of rays o, d [P, 3] over their own
    triangle rows [P, L, BLK_COLS] by `_isect_kernel`'s rule: Möller-Trumbore
    in its operations and order; rows tested in groups of 8 consecutive
    rows, inside a group the smallest prim among the rows at the group's
    minimum t, across groups a later group only by strict improvement.
    (inf, -1) where nothing hits."""
    p, l, _ = rows.shape
    c = [rows[:, :, j] for j in range(11)]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, cull, prim = c
    ox, oy, oz = (o[:, j, None] for j in range(3))
    dx, dy, dz = (d[:, j, None] for j in range(3))
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    miss_det = torch.where(cull > 0.5, det <= TRI_EPS, det.abs() <= TRI_EPS)
    one = torch.ones(1, device=rows.device)  # the kernel's IEEE 1.0f / det
    inv_det = one / torch.where(miss_det, 1.0, det)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((prim >= 0.0) & ~miss_det & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= 0.0))
    th = torch.where(ok, t, float("inf")).view(p, l // GROUP_ROWS, GROUP_ROWS)
    gmin = th.amin(-1)
    gprim = torch.where(th <= gmin[..., None], prim.view(th.shape), 3e38).amin(-1)
    g = gmin.argmin(-1, keepdim=True)  # the first group at the minimum
    tmin = gmin.gather(-1, g)[:, 0]
    hit = tmin < float("inf")
    return tmin, torch.where(hit, gprim.gather(-1, g)[:, 0], -1.0).long()


def _pair_clusters(offs, n_pairs):
    """Cluster of each binned pair [n_pairs] from the ranges `offs` [C+1];
    C for pairs past the last range."""
    pos = torch.arange(n_pairs, device=offs.device, dtype=offs.dtype)
    return torch.searchsorted(offs[1:].contiguous(), pos, right=True)


def isect_reference(blocks, rays, offs):
    """The plain version of K7 (see `isect`)."""
    isect_reference.calls += 1
    n_pairs = rays.shape[1]
    c, l, _ = blocks.shape
    dev = rays.device
    t = torch.full((n_pairs,), float("inf"), device=dev)
    prim = torch.full((n_pairs,), -1, dtype=torch.int32, device=dev)
    cl = _pair_clusters(offs, n_pairs)
    step = max(1, _CHUNK_ELEMS // l)
    for a in range(0, n_pairs, step):
        sel = torch.nonzero(cl[a:a + step] < c).squeeze(1) + a
        if sel.numel() == 0:
            continue
        ts, ps = nearest_in_rows(blocks[cl[sel]], rays[0:3, sel].t(), rays[3:6, sel].t())
        t[sel] = ts
        prim[sel] = ps.to(torch.int32)
    return t, prim


isect_reference.calls = 0


def _isect_fn():
    lib = _build.load("binned_isect")
    fn = lib.ptx_binned_isect_launch
    if fn.argtypes is None:
        # blocks C L rays n_pairs offs chunk_start groups n_items t prim stream
        fn.argtypes = [_P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _P, _P]
        fn.restype = ctypes.c_int
    return fn


def last_filled_groups(blocks):
    """[C] int32: the 8-row groups of each cluster of `blocks` [C, L,
    BLK_COLS] up to and including its last group with a filled row (prim
    >= 0); 0 for a cluster with none. K7 tests no row past them: a group
    of padding rows gives t = inf and never wins. Padding groups before the
    last filled one count. On the blocks' device, with no host read."""
    c, l = blocks.shape[0], blocks.shape[1]
    filled = (blocks[:, :, C_PRIM] >= 0).view(c, l // GROUP_ROWS, GROUP_ROWS).any(2)
    rank = torch.arange(1, l // GROUP_ROWS + 1, dtype=torch.int32, device=blocks.device)
    return (filled * rank).amax(1).to(torch.int32)


# id(blocks) -> (weak reference to them, their version, last_filled_groups):
# a build's blocks are scanned once, at their first query.
_GROUPS: dict = {}


def filled_groups(blocks):
    """`last_filled_groups(blocks)`, computed at the first call for a
    blocks tensor and kept while it lives unchanged."""
    key = id(blocks)
    hit = _GROUPS.get(key)
    if hit is not None and hit[0]() is blocks and hit[1] == blocks._version:
        return hit[2]
    groups = last_filled_groups(blocks)
    _GROUPS[key] = (weakref.ref(blocks, lambda _, k=key: _GROUPS.pop(k, None)),
                    blocks._version, groups)
    return groups


def work_items(offs, n_pairs):
    """K7's work list from the bin offsets `offs` [C+1] i32: (chunk_start
    [C+1] i32, the first item of each cluster, each cluster's range cut in
    chunks of ITEM_PAIRS pairs; n_items, an upper bound on their number
    from the shapes alone, so no host read sizes the grid)."""
    c = offs.shape[0] - 1
    n_chunks = (offs[1:] - offs[:-1] + ITEM_PAIRS - 1) // ITEM_PAIRS
    chunk_start = torch.zeros(c + 1, dtype=torch.int32, device=offs.device)
    chunk_start[1:] = torch.cumsum(n_chunks, 0)
    return chunk_start, -(-n_pairs // ITEM_PAIRS) + c


def isect_occupancy():
    """(resident blocks per SM, threads per block, pairs per work item) of
    K7 on the current card."""
    fn = _build.load("binned_isect").ptx_binned_isect_occupancy
    if fn.argtypes is None:
        fn.argtypes = [ctypes.POINTER(_I)] * 3
        fn.restype = ctypes.c_int
    out = [ctypes.c_int(0) for _ in range(3)]
    err = fn(*(ctypes.byref(v) for v in out))
    if err:
        raise RuntimeError(f"binned_isect occupancy query failed: cudaError_t {err}")
    return tuple(v.value for v in out)


def isect(blocks, rays, offs):
    """K7: the nearest (t [P] f32, prim [P] i32) of each binned pair over
    its cluster's triangles. `blocks` [C, L, BLK_COLS]; `rays` [6, P] f32
    planes (ox oy oz dx dy dz) ordered by cluster; `offs` [C+1] i32, the
    pairs of cluster c at [offs[c], offs[c+1]). Pairs past offs[C] and
    pairs that hit nothing give (inf, -1). CPU tensors take the plain
    version; CUDA tensors launch csrc/binned_isect.cu over the work list of
    (cluster, ITEM_PAIRS pairs) items built here on the device, each
    cluster's rows cut at its last filled group (`filled_groups`)."""
    dev = rays.device
    if dev.type == "cpu":
        return isect_reference(blocks, rays, offs)
    if dev.type != "cuda":
        raise ValueError(f"isect: no kernel for device {dev}")
    n_pairs = rays.shape[1]
    c, l = blocks.shape[0], blocks.shape[1]
    check_tensor("rays", rays, dev, torch.float32, (6, n_pairs))
    check_tensor("blocks", blocks, dev, torch.float32, (None, None, BLK_COLS))
    check_tensor("offs", offs, dev, torch.int32, (c + 1,))
    if l % GROUP_ROWS:
        raise ValueError(f"cluster height {l}: need a multiple of {GROUP_ROWS}")
    if blocks.data_ptr() % 16:
        raise ValueError("blocks: the bulk copies need a 16-byte aligned tensor")
    t = torch.full((n_pairs,), float("inf"), device=dev)
    prim = torch.full((n_pairs,), -1, dtype=torch.int32, device=dev)
    if n_pairs:
        groups = filled_groups(blocks)
        chunk_start, n_items = work_items(offs, n_pairs)
        with torch.cuda.device(dev):
            err = _isect_fn()(blocks.data_ptr(), c, l, rays.data_ptr(), n_pairs,
                              offs.data_ptr(), chunk_start.data_ptr(), groups.data_ptr(),
                              n_items, t.data_ptr(), prim.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"binned_isect launch failed: cudaError_t {err}")
        isect.launches += 1
    return t, prim


isect.launches = 0


# ---------------------------------------------------------------------------
# The pipeline: dense part, rounds, batches.
# ---------------------------------------------------------------------------


def binned_tables(scene):
    """K5's tables of the dense part of a binned scene, (big-partition
    triangles [B, 24], spheres [S, 8]), on the scene's device: packed once
    by a caller that queries many times."""
    from ..ops.intersect import dense_tables_of

    return dense_tables_of(scene.big_v0, scene.big_v1, scene.big_v2, scene.big_cull,
                           scene.big_prim >= 0, scene)


def _dense_part(scene, o, d, tables):
    """Nearest (t, prim) over the big triangles and the spheres, (inf, -1)
    on a miss (pallas_traverse.py:406-442). K5 on the big-partition table:
    its first-row-wins rule among equal t is JAX's smallest prim, since
    big_prim increases with the row."""
    from ..ops.intersect import dense_intersect

    rows = tables[0].shape[0]
    t, p = dense_intersect(scene, o, d, tables, n_tri_rows=rows)
    hit = p >= 0
    big = scene.big_prim.long()[p.clamp(0, rows - 1)]
    p = torch.where(p < rows, big, p - rows + scene.n_tri)
    return torch.where(hit, t, float("inf")), torch.where(hit, p, -1)


def _root_entry(scene, o, d):
    from ..ops.intersect import intersect_aabb

    return intersect_aabb(o, d, scene.root_lo[None], scene.root_hi[None])


def pack_rays(o, d, best, t_lo, id_lo):
    """K6's ray planes [RAY_ROWS, n] from rays o, d [n, 3] and the per-ray
    best hit and lower bound (t_lo, id_lo) [n]."""
    return torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                        best, t_lo, id_lo]).contiguous()


def bin_pairs(rays, ids, n_clusters: int, m: int):
    """K7's input from K6's: the (ray, slot) pairs of the first m slots
    (pair p = s * n + r) ordered by cluster with one stable argsort, empty
    slots last. Returns (pair rays [6, m*n] in that order, offs [C+1] i32,
    the order [m*n])."""
    n = rays.shape[1]
    flat = ids[:m].reshape(-1).long()
    key = torch.where(flat >= 0, flat, n_clusters)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_clusters + 1)[:n_clusters]
    offs = torch.zeros(n_clusters + 1, dtype=torch.int32, device=rays.device)
    offs[1:] = torch.cumsum(counts, 0)
    return rays[:6, order % n].contiguous(), offs, order


def _round(scene, o, d, best_t, best_p, t_lo, id_lo, live, m, any_hit):
    """One candidate -> bin -> intersect -> resolve round over a batch of
    rays (pallas_traverse.py:461-568)."""
    n = o.shape[0]
    c = scene.trv_bounds.shape[0]
    inf = float("inf")
    rays = pack_rays(o, d, torch.where(live, best_t, 0.0), torch.where(live, t_lo, inf), id_lo)
    ids, ent = candidates(scene.trv_bounds, rays, m)
    pair_rays, offs, order = bin_pairs(rays, ids, c, m)
    t_sorted, p_sorted = isect(scene.trv_blocks, pair_rays, offs)
    t_flat = torch.empty_like(t_sorted)
    p_flat = torch.empty_like(p_sorted)
    t_flat[order] = t_sorted
    p_flat[order] = p_sorted
    valid = ids[:m] >= 0
    t_cand = torch.where(valid, t_flat.view(m, n), inf)
    p_cand = p_flat.view(m, n).long()

    # Resolve: the nearest slot, the first slot among equal t.
    t_new = t_cand.amin(0)
    p_new = torch.full_like(best_p, -1)
    chosen = torch.zeros_like(live)
    for s in range(m):
        on = ~chosen & (t_cand[s] == t_new)
        p_new = torch.where(on, p_cand[s], p_new)
        chosen = chosen | on
    better = live & (t_new < best_t)
    best_t = torch.where(better, t_new, best_t)
    best_p = torch.where(better, p_new, best_p)

    # Advance the bound past this round's clusters: the last valid slot.
    worst_e = torch.full_like(best_t, -inf)
    worst_i = torch.full_like(best_t, -inf)
    for s in range(m):
        worst_e = torch.where(valid[s], ent[s], worst_e)
        worst_i = torch.where(valid[s], ids[s].to(torch.float32), worst_i)
    pending = live & valid[0] & (ent[m] < best_t)
    if any_hit:
        pending = pending & (best_p < 0)
    t_lo = torch.where(pending, worst_e, inf)
    id_lo = torch.where(pending, worst_i, inf)
    return best_t, best_p, t_lo, id_lo, pending


def _prepare(o, d, t_max):
    o = o.detach().to(torch.float32).contiguous()
    d = d.detach().to(torch.float32).contiguous()
    if t_max is not None:
        t_max = torch.as_tensor(t_max, dtype=torch.float32, device=o.device).detach()
    return o, d, t_max


def binned_intersect(scene, o, d, t_max=None, live=None, any_hit: bool = False,
                     m: int = 4, batch: int = DEFAULT_BATCH, tables=None):
    """Exact nearest hit through the binned wavefront (the counterpart of
    `binned_intersect_tpu`, pallas_traverse.py:571-706).

    o, d: [R, 3]. `t_max` [R] or None: hits at t >= t_max are misses
    (shadow rays; also a pruning bound). `live` [R] bool or None: lanes with
    live False skip the cluster stage and keep the dense part's result.
    `any_hit`: the rounds stop once a ray has any hit in range (the hit
    need not be the nearest). `m`: candidate slots per round (1..7).
    `batch`: live rays per pass of the rounds. `tables`: binned_tables(),
    packed once by a caller that queries many times. Returns (t [R],
    prim [R] i64), -1 / -1 on a miss."""
    if scene.lean:
        raise ValueError("lean-built scene: its binned-wavefront tables were not packed")
    o, d, t_max = _prepare(o, d, t_max)
    if tables is None:
        tables = binned_tables(scene.to(o.device))
    inf = float("inf")
    t0, p0 = _dense_part(scene, o, d, tables)
    if t_max is not None:
        miss = t0 >= t_max
        t0 = torch.where(miss, inf, t0)
        p0 = torch.where(miss, -1, p0)
    entry = _root_entry(scene, o, d)
    live0 = (entry >= 0.0) & (entry < t0)
    if t_max is not None:
        live0 = live0 & (entry < t_max)
    if live is not None:
        live0 = live0 & live.to(o.device)
    if any_hit:
        live0 = live0 & (p0 < 0)  # a dense occluder already decides
    best0 = t0 if t_max is None else torch.minimum(t0, t_max)

    # Live rays first, in batches of `batch`: one host read of the count.
    idx = torch.nonzero(live0).squeeze(1)
    binned_intersect.host_reads += 1
    out_t, out_p = t0.clone(), p0.clone()
    c = scene.trv_bounds.shape[0]
    for a in range(0, idx.numel(), batch):
        sel = idx[a:a + batch]
        ob, db = o[sel], d[sel]
        bt = best0[sel]
        bp = torch.full_like(sel, -1)
        t_lo = torch.full_like(bt, -inf)
        id_lo = torch.full_like(bt, -inf)
        live_r = torch.ones_like(sel, dtype=torch.bool)
        rnd = 0
        while rnd < c + 1:
            binned_intersect.host_reads += 1
            if not bool((t_lo < inf).any()):
                break
            bt, bp, t_lo, id_lo, pend = _round(scene, ob, db, bt, bp, t_lo, id_lo, live_r,
                                               m, any_hit)
            live_r = live_r & pend
            rnd += 1
            binned_intersect.rounds += 1
        # Cluster hits replace the dense result; other lanes keep it.
        won = bp >= 0
        out_t[sel] = torch.where(won, bt, out_t[sel])
        out_p[sel] = torch.where(won, bp, out_p[sel])
    hit = (out_p >= 0) & torch.isfinite(out_t)
    return torch.where(hit, out_t, -1.0), torch.where(hit, out_p, -1)


# Per-process totals: host reads of the pipeline's flags, exactness rounds.
binned_intersect.host_reads = 0
binned_intersect.rounds = 0


def binned_intersect_ref(scene, o, d, t_max=None, tables=None):
    """The oracle of `binned_intersect` (pallas_traverse.py:713-731): the
    dense part and the sweep intersector over the cluster blocks, the
    nearest hit of every ray."""
    from ..ops.intersect import sweep_intersect

    o, d, t_max = _prepare(o, d, t_max)
    if tables is None:
        tables = binned_tables(scene.to(o.device))
    t0, p0 = _dense_part(scene, o, d, tables)
    ts, ps = sweep_intersect(scene, o, d)
    ts = torch.where(ts >= 0.0, ts, float("inf"))
    better = ts < t0
    t = torch.where(better, ts, t0)
    p = torch.where(better, ps, p0)
    if t_max is not None:
        miss = t >= t_max
        t = torch.where(miss, float("inf"), t)
        p = torch.where(miss, -1, p)
    hit = (p >= 0) & torch.isfinite(t)
    return torch.where(hit, t, -1.0), torch.where(hit, p, -1)


def krn_intersect(scene, o, d, t_max=None, live=None, any_hit: bool = False, tables=None):
    """The same contract as `binned_intersect`, with the small partition
    resolved by the in-kernel cluster traversal (K4, `cluster_intersect` of
    accel/kernel_traverse.py) instead of the binned pipeline
    (pallas_traverse.py:738-803): it serves lean scenes, whose binned
    tables were never packed, and PTX_WAVEFRONT_KRN=1. For any_hit the
    returned prim is only an occlusion flag (>= 0 where occluded)."""
    from .kernel_traverse import cluster_intersect

    o, d, t_max = _prepare(o, d, t_max)
    if tables is None:
        tables = binned_tables(scene.to(o.device))
    t0, p0 = _dense_part(scene, o, d, tables)
    if t_max is not None:
        miss = t0 >= t_max
        t0 = torch.where(miss, float("inf"), t0)
        p0 = torch.where(miss, -1, p0)
    # The cluster query's bound: the dense hit (or the shadow limit); dead
    # lanes, and occluded lanes of a visibility query, get 0 (inactive).
    lim = t0 if t_max is None else torch.minimum(t0, t_max)
    if live is not None:
        lim = torch.where(live.to(o.device), lim, 0.0)
    if any_hit:
        lim = torch.where(p0 >= 0, 0.0, lim)
    t1, p1 = cluster_intersect(scene, o, d, t_max=lim.contiguous(), any_hit=any_hit)
    if any_hit:
        occ = (p1 >= 0) | (p0 >= 0)
        t = torch.where(p0 >= 0, t0, t1)
        return torch.where(occ, t, -1.0), torch.where(occ, torch.maximum(p1, p0), -1)
    hit1 = p1 >= 0
    t = torch.where(hit1, t1, t0)
    p = torch.where(hit1, p1, p0)
    hit = (p >= 0) & torch.isfinite(t)
    return torch.where(hit, t, -1.0), torch.where(hit, p, -1)
