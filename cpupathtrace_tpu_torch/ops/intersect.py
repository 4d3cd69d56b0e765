"""Batched ray-primitive intersection and the scene intersectors of the
wavefront (port of `cpupathtrace_tpu/ops/intersect.py`).

Primitive tests as the reference's:
  * triangle: Moller-Trumbore, eps 1e-6, optional backface culling
    (ref: src/scene/object.cpp:146-182)
  * sphere: near root; rays starting inside report the negative entry
    distance and so miss (ref: object.cpp:72-84)
  * AABB: slab test, FLT_MAX inverse for zero direction components, 0 when
    the origin is inside, -1 on a miss (ref: bounding_box.cpp:38-73)

`scene_intersect` dispatches by the scene's accelerator, as
ops/intersect.py:439-508 does:
  * dense: the dense query K5 (csrc/dense_query.cu, the port of
    `_dense_kernel`, ops/pallas_intersect.py:31) on a CUDA device,
    whatever the scene's size; its plain version
    `dense_intersect_reference` on the CPU;
  * binned: the binned wavefront (accel/traverse.py: K6, K7 and K5), or
    the in-kernel cluster traversal K4 for lean scenes and under
    PTX_WAVEFRONT_KRN=1 (`krn_intersect`);
  * sweep, cluster, bvh: the torch walkers below (`sweep_intersect`,
    `cluster_intersect`, `bvh_intersect`), plain tensor code on either
    device. They loop until no ray is pending, reading that flag on the
    host once per iteration.
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _build
from ..accel.kernel_traverse import check_tensor
from ..scene.scene import SceneData
from ..utils.math import cross, dot

TRI_EPS = 1e-6
FLT_MAX = 3.4028234663852886e38
# K5's table row layouts: the megakernel's (tri [T, 24]: v0 e1 e2 cull
# valid, then unused columns; sph [S, 8]: center radius valid).
TRI_COLS = 24
SPH_COLS = 8


def intersect_triangles(o, d, v0, v1, v2, cull):
    """Moller-Trumbore, broadcasting rays [..., 3] against triangles
    [..., 3]. Returns t (negative behind the origin, as the reference);
    -1 on a miss."""
    ab = v1 - v0
    ac = v2 - v0
    pvec = cross(d, ac)
    det = dot(ab, pvec)
    miss_det = torch.where(cull, det <= TRI_EPS, det.abs() <= TRI_EPS)
    inv_det = 1.0 / torch.where(miss_det, 1.0, det)
    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, ab)
    v = dot(d, qvec) * inv_det
    t = dot(ac, qvec) * inv_det
    miss = miss_det | (u < 0) | (u > 1) | (v < 0) | (u + v > 1)
    return torch.where(miss, -1.0, t)


def intersect_spheres(o, d, center, radius):
    """Near-root sphere intersection (ref: object.cpp:72-84); -1 on a miss."""
    co = o - center
    dd = dot(d, co)
    disc = dd * dd - dot(co, co) + radius * radius
    t = -(dd + torch.sqrt(disc.clamp_min(0.0)))
    return torch.where(disc >= 0, t, -1.0)


def intersect_aabb(o, d, lo, hi):
    """Slab test (ref: bounding_box.cpp:38-73): the entry distance, 0 when
    the origin is inside, -1 on a miss."""
    inv = torch.where(d.abs() > 0.0, 1.0 / torch.where(d == 0, 1.0, d), FLT_MAX)
    t_lo = (lo - o) * inv
    t_hi = (hi - o) * inv
    t_min = torch.minimum(t_lo, t_hi).amax(dim=-1)
    t_max = torch.maximum(t_lo, t_hi).amin(dim=-1)
    t = torch.where(t_min < 0.0, 0.0, t_min)
    return torch.where((t_max < 0.0) | (t_min > t_max), -1.0, t)


def intersect_prim(scene: SceneData, prim, o, d):
    """Rays against the global primitive `prim` (triangles first, then
    spheres); shapes broadcast."""
    is_tri = prim < scene.n_tri
    ti = torch.where(is_tri, prim, 0).clamp(0, scene.tri_v0.shape[0] - 1).long()
    t_tri = intersect_triangles(o, d, scene.tri_v0[ti], scene.tri_v1[ti], scene.tri_v2[ti],
                                scene.tri_cull[ti])
    si = (prim - scene.n_tri).clamp(0, scene.sph_center.shape[0] - 1).long()
    t_sph = intersect_spheres(o, d, scene.sph_center[si], scene.sph_radius[si])
    return torch.where(is_tri, t_tri, t_sph)


def table_nearest(tri, sph, ox, oy, oz, dx, dy, dz, n_tri):
    """Nearest hit over the triangle table rows [0, n_tri) and then the
    sphere table (`_intersect_tables`, pallas_megakernel.py:141-234; the
    same tests as `_dense_kernel`, pallas_intersect.py:31). Tables in the
    megakernel's row layout (tri [T, 24], sph [S, 8]).
    Returns (t, prim, nx, ny, nz, mid) per ray; t = inf on a miss. A row
    wins only by improving strictly, so the first of equal-t rows wins."""
    n = ox.shape[0]
    dev = ox.device
    best_t = torch.full((n,), float("inf"), device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nx = torch.zeros(n, device=dev)
    ny = torch.ones(n, device=dev)
    nz = torch.zeros(n, device=dev)
    mid = torch.zeros(n, dtype=torch.int64, device=dev)
    if n_tri:
        tr = tri[:n_tri, :, None]  # [T, 24, 1] against [n] rays
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (tr[:, j] for j in range(9))
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        is_cull = tr[:, 9] > 0.5
        miss_det = torch.where(is_cull, det <= TRI_EPS, det.abs() <= TRI_EPS)
        inv_det = torch.reciprocal(torch.where(miss_det, 1.0, det))
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = (
            (tr[:, 10] > 0.5) & ~miss_det
            & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= 0.0)
        )
        key = torch.where(ok, t, float("inf"))
        tmin, k = key.min(dim=0)
        won = tmin < best_t
        uk = u.gather(0, k[None])[0]
        vk = v.gather(0, k[None])[0]
        row = tri[k]
        w0 = 1.0 - uk - vk
        snx = w0 * row[:, 11] + uk * row[:, 14] + vk * row[:, 17]
        sny = w0 * row[:, 12] + uk * row[:, 15] + vk * row[:, 18]
        snz = w0 * row[:, 13] + uk * row[:, 16] + vk * row[:, 19]
        inv = torch.rsqrt(snx * snx + sny * sny + snz * snz + 1e-30)
        best_t = torch.where(won, tmin, best_t)
        best_p = torch.where(won, k, best_p)
        nx = torch.where(won, snx * inv, nx)
        ny = torch.where(won, sny * inv, ny)
        nz = torch.where(won, snz * inv, nz)
        mid = torch.where(won, row[:, 20].long(), mid)

    sp = sph[:, :, None]  # [S, 8, 1]
    cx, cy, cz, r = sp[:, 0], sp[:, 1], sp[:, 2], sp[:, 3]
    cox = ox - cx
    coy = oy - cy
    coz = oz - cz
    dd = dx * cox + dy * coy + dz * coz
    disc = dd * dd - (cox * cox + coy * coy + coz * coz) + r * r
    t = -(dd + torch.sqrt(disc.clamp_min(0.0)))
    ok = (sp[:, 4] > 0.5) & (disc >= 0.0) & (t >= 0.0)
    key = torch.where(ok, t, float("inf"))
    tmin, k = key.min(dim=0)
    won = tmin < best_t
    row = sph[k]
    hx = ox + dx * tmin - row[:, 0]
    hy = oy + dy * tmin - row[:, 1]
    hz = oz + dz * tmin - row[:, 2]
    inv = torch.rsqrt(hx * hx + hy * hy + hz * hz + 1e-30)
    best_t = torch.where(won, tmin, best_t)
    best_p = torch.where(won, k + n_tri, best_p)
    nx = torch.where(won, hx * inv, nx)
    ny = torch.where(won, hy * inv, ny)
    nz = torch.where(won, hz * inv, nz)
    mid = torch.where(won, row[:, 5].long(), mid)
    return best_t, best_p, nx, ny, nz, mid


def dense_tables(scene: SceneData):
    """K5's tables on the scene's device: (tri [T, 24], sph [S, 8])."""
    return dense_tables_of(scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_cull,
                           scene.tri_valid, scene)


def dense_tables_of(v0, v1, v2, cull, valid, scene: SceneData):
    """K5's tables of the triangles (v0, v1, v2, cull, valid) and of the
    scene's spheres."""
    f32 = torch.float32
    t_rows = v0.shape[0]
    s_rows = scene.sph_center.shape[0]
    dev = scene.device
    tri = torch.cat([
        v0, v1 - v0, v2 - v0, cull.to(f32)[:, None], valid.to(f32)[:, None],
        torch.zeros((t_rows, TRI_COLS - 11), dtype=f32, device=dev),
    ], dim=1)
    sph = torch.cat([
        scene.sph_center, scene.sph_radius[:, None], scene.sph_valid.to(f32)[:, None],
        torch.zeros((s_rows, SPH_COLS - 5), dtype=f32, device=dev),
    ], dim=1)
    return tri.contiguous(), sph.contiguous()


def dense_intersect_reference(scene: SceneData, o, d, tables=None, n_tri_rows=None):
    """The plain version of K5: nearest (t, prim) over every triangle, then
    every sphere, a primitive winning only by strict improvement (so the
    lowest row wins a tie, as `argmin` in the jnp version). t = -1 and
    prim = -1 on a miss; prim in the global index space, or with
    `n_tri_rows` (the triangle rows of `tables` to scan) in the tables'
    row space: rows, then n_tri_rows + sphere."""
    dense_intersect_reference.calls += 1
    if tables is None:
        tables = dense_tables(scene.to(o.device))
    tri, sph = tables
    n_tri = scene.n_tri if n_tri_rows is None else n_tri_rows
    t, p, *_ = table_nearest(tri, sph, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                             n_tri)
    hit = p >= 0
    return torch.where(hit, t, -1.0), p


dense_intersect_reference.calls = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _dense_fn():
    lib = _build.load("dense_query")
    fn = lib.ptx_dense_query_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, _P, _I, _P, _I, _P, _I, _P]  # o d t prim n tri sph stream
        fn.restype = ctypes.c_int
    return fn


def dense_occupancy(n_tri: int, n_sph: int):
    """(resident blocks per SM, threads per block, dynamic shared memory,
    stage limit) of the K5 instance a launch over tables of `n_tri`
    triangle and `n_sph` sphere rows takes on the current card: the tables
    are staged in each block's shared memory up to the stage limit (in
    bytes), else read through L1 (shared memory 0)."""
    fn = _build.load("dense_query").ptx_dense_query_occupancy
    if fn.argtypes is None:
        ll = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I), ll, ll]
        fn.restype = ctypes.c_int
    out = [ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)]
    err = fn(n_tri, n_sph, *(ctypes.byref(v) for v in out))
    if err:
        raise RuntimeError(f"dense_query occupancy query failed: cudaError_t {err}")
    return tuple(v.value for v in out)


def dense_intersect(scene: SceneData, o, d, tables=None, n_tri_rows=None):
    """Nearest (t [R] f32, prim [R] i64) over all primitives of a dense
    scene; -1 / -1 on a miss. `tables` / `n_tri_rows`: other tables (the
    big partition of a binned scene), as dense_intersect_reference. CPU
    rays take the plain version; CUDA rays launch K5 (csrc/dense_query.cu)
    whatever the scene's size, one launch a call (the kernel writes the
    int64 prim)."""
    dev = o.device
    if dev.type == "cpu":
        return dense_intersect_reference(scene, o, d, tables, n_tri_rows)
    if dev.type != "cuda":
        raise ValueError(f"dense_intersect: no kernel for device {dev}")
    r = o.shape[0]
    check_tensor("origin", o, dev, torch.float32, (r, 3))
    check_tensor("direction", d, dev, torch.float32, (r, 3))
    if tables is None:
        tables = dense_tables(scene.to(dev))
    tri, sph = tables
    check_tensor("tri", tri, dev, torch.float32, (None, TRI_COLS))
    check_tensor("sph", sph, dev, torch.float32, (None, SPH_COLS))
    n_tri = scene.n_tri if n_tri_rows is None else n_tri_rows
    if n_tri > tri.shape[0]:
        raise ValueError(f"dense_intersect: {n_tri} triangles, table has {tri.shape[0]}")
    t = torch.empty(r, dtype=torch.float32, device=dev)
    p = torch.empty(r, dtype=torch.int64, device=dev)
    if r:
        with torch.cuda.device(dev):
            err = _dense_fn()(
                o.data_ptr(), d.data_ptr(), t.data_ptr(), p.data_ptr(), r,
                tri.data_ptr(), n_tri, sph.data_ptr(), sph.shape[0],
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err:
            raise RuntimeError(f"dense_query launch failed: cudaError_t {err}")
        dense_intersect.launches += 1
    return t, p


dense_intersect.launches = 0


def _nearest_sphere(scene: SceneData, o, d, best_t, best_prim):
    """The walkers' dense sphere pass: a sphere replaces the triangle hit
    only by strictly improving on it (ops/intersect.py:303-316)."""
    if scene.n_sph == 0:
        return best_t, best_prim
    t_sph = intersect_spheres(o[:, None, :], d[:, None, :], scene.sph_center[None],
                              scene.sph_radius[None])
    t_sph = torch.where(scene.sph_valid[None] & (t_sph >= 0.0), t_sph, float("inf"))
    js = t_sph.argmin(1)
    ts = t_sph.gather(1, js[:, None])[:, 0]
    better = ts < best_t
    return torch.where(better, ts, best_t), torch.where(better, js + scene.n_tri, best_prim)


def _walk(o, d, lo, hi, left, right, depth, leaf_of, visit_leaf):
    """The short-stack walk of a flat tree shared by the bvh and cluster
    walkers (ops/intersect.py:136-213): descend the nearer child whose box
    the ray enters before its best hit, push the farther, pop at a leaf or
    a dead end. `leaf_of(node)` gives the leaf payload (-1 on internal
    nodes); `visit_leaf(lanes, payload)` gives (t, prim) of those lanes."""
    n = o.shape[0]
    dev = o.device
    stack_depth = depth + 2
    levels = torch.arange(stack_depth, device=dev)[None, :]
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    best_t = torch.full((n,), float("inf"), device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    active = intersect_aabb(o, d, lo[0], hi[0]) >= 0.0
    left, right = left.long(), right.long()
    while bool(active.any()):
        payload = leaf_of(node)
        is_leaf = payload >= 0
        lanes = torch.nonzero(active & is_leaf).squeeze(1)
        if lanes.numel():
            t_leaf, p_leaf = visit_leaf(lanes, payload[lanes])
            better = t_leaf < best_t[lanes]
            best_t[lanes] = torch.where(better, t_leaf, best_t[lanes])
            best_prim[lanes] = torch.where(better, p_leaf, best_prim[lanes])
        li = left[node]
        ri = right[node]
        t_l = intersect_aabb(o, d, lo[li], hi[li])
        t_r = intersect_aabb(o, d, lo[ri], hi[ri])
        hit_l = (t_l >= 0.0) & (t_l < best_t)
        hit_r = (t_r >= 0.0) & (t_r < best_t)
        l_near = torch.where(hit_l & hit_r, t_l <= t_r, hit_l)
        near = torch.where(l_near, li, ri)
        far = torch.where(l_near, ri, li)
        n_hits = hit_l.long() + hit_r.long()
        push = active & ~is_leaf & (n_hits == 2)
        stack = torch.where(push[:, None] & (levels == sp[:, None]), far[:, None], stack)
        sp = torch.where(push, sp + 1, sp)
        descend = active & ~is_leaf & (n_hits > 0)
        pop = active & ~descend & (sp > 0)
        sp = torch.where(pop, sp - 1, sp)
        popped = stack.gather(1, sp.clamp_min(0)[:, None])[:, 0]
        node = torch.where(descend, near, torch.where(pop, popped, node))
        active = descend | pop
    return best_t, best_prim


def bvh_intersect(scene: SceneData, o, d):
    """The per-primitive BVH walk (ops/intersect.py:136-213): one primitive
    per leaf, a leaf improving the ray's hit only strictly. Returns (t [R],
    prim [R] i64), -1 / -1 on a miss."""
    o, d = o.detach(), d.detach()

    def visit(lanes, prim):
        t = intersect_prim(scene, prim, o[lanes], d[lanes])
        return torch.where(t >= 0.0, t, float("inf")), prim

    best_t, best_prim = _walk(o, d, scene.bvh_lo, scene.bvh_hi, scene.bvh_left,
                              scene.bvh_right, scene.bvh_depth,
                              lambda node: scene.bvh_prim.long()[node], visit)
    hit = best_prim >= 0
    return torch.where(hit, best_t, -1.0), best_prim


def _nearest_in_blocks(scene: SceneData, o, d, cid):
    """Nearest (t, prim) of rays [n] over the cluster blocks `cid` [n, k]
    (flattened, the first of equal t wins: argmin); (inf, -1) where no
    block is hit. `cid` < 0 marks an empty slot."""
    n, k = cid.shape
    c = cid.clamp_min(0)
    pid = scene.blk_prim[c].long()  # [n, k, L]
    t = intersect_triangles(o[:, None, None, :], d[:, None, None, :], scene.blk_v0[c],
                            scene.blk_v1[c], scene.blk_v2[c], scene.blk_cull[c])
    t = torch.where((cid[..., None] >= 0) & (pid >= 0) & (t >= 0.0), t, float("inf"))
    t = t.reshape(n, -1)
    j = t.argmin(1, keepdim=True)
    return t.gather(1, j)[:, 0], pid.reshape(n, -1).gather(1, j)[:, 0]


def cluster_intersect(scene: SceneData, o, d):
    """The walk of the top tree over clusters (ops/intersect.py:216-319):
    a leaf visit tests its whole [L]-triangle block, then the spheres are
    tested densely. Returns (t [R], prim [R] i64), -1 / -1 on a miss."""
    o, d = o.detach(), d.detach()

    def visit(lanes, cluster):
        t, p = _nearest_in_blocks(scene, o[lanes], d[lanes], cluster[:, None])
        return t, torch.where(torch.isfinite(t), p, -1)

    best_t, best_prim = _walk(o, d, scene.cl_lo, scene.cl_hi, scene.cl_left, scene.cl_right,
                              scene.cl_depth, lambda node: scene.cl_leaf.long()[node], visit)
    best_t, best_prim = _nearest_sphere(scene, o, d, best_t, best_prim)
    hit = best_prim >= 0
    return torch.where(hit, best_t, -1.0), best_prim


SWEEP_K = 4


def top_k_smallest(x, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, the lower index first among equal values: `jax.lax.top_k`
    of -x. A stable sort, since torch.topk promises no order among ties."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def sweep_tables(scene: SceneData):
    """The sweep's per-cluster mask: clusters with a triangle (padding
    clusters have none)."""
    return (scene.blk_prim >= 0).any(dim=1)


def sweep_intersect(scene: SceneData, o, d, k: int = SWEEP_K, tables=None):
    """The dense-top sweep (ops/intersect.py:325-427): every ray against
    every cluster box, then rounds that test the k nearest pending
    clusters' blocks until no cluster's entry beats a ray's best hit; the
    spheres last. Exact nearest hit. Rays go through in chunks (their
    results are independent) so that the [R, k, L] tests fit in memory.
    Returns (t [R], prim [R] i64), -1 / -1 on a miss."""
    o, d = o.detach(), d.detach()
    n = o.shape[0]
    c = scene.blk_lo.shape[0]
    k = min(k, c)
    l = scene.blk_prim.shape[1]
    valid = sweep_tables(scene) if tables is None else tables
    inf = float("inf")
    best_t = torch.full((n,), inf, device=o.device)
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    step = max(1, min((1 << 22) // max(k * l, 1), (1 << 22) // c))
    for a in range(0, n, step):
        oc, dc = o[a:a + step], d[a:a + step]
        t_c = intersect_aabb(oc[:, None, :], dc[:, None, :], scene.blk_lo[None],
                             scene.blk_hi[None])
        t_c = torch.where((t_c >= 0.0) & valid[None, :], t_c, inf)
        bt = best_t[a:a + step]
        bp = best_prim[a:a + step]
        while bool((t_c < bt[:, None]).any()):
            pend = torch.where(t_c < bt[:, None], t_c, inf)
            vals, idx = top_k_smallest(pend, k)
            has = torch.isfinite(vals)
            t_min, p_min = _nearest_in_blocks(scene, oc, dc, torch.where(has, idx, -1))
            better = t_min < bt
            bt = torch.where(better, t_min, bt)
            bp = torch.where(better, p_min, bp)
            mark = torch.zeros_like(t_c, dtype=torch.bool).scatter_(1, idx, has)
            t_c = torch.where(mark, inf, t_c)
        best_t[a:a + step] = bt
        best_prim[a:a + step] = bp
    best_t, best_prim = _nearest_sphere(scene, o, d, best_t, best_prim)
    hit = best_prim >= 0
    return torch.where(hit, best_t, -1.0), best_prim


def query_tables(scene: SceneData):
    """The tables `scene_intersect` reads, packed once for a caller that
    queries many times (the wavefront packs them once per trace): K5's for
    a dense scene, the dense part's for a binned one, the sweep's cluster
    mask; None for the bvh and cluster walkers, which read the scene."""
    if scene.accel == "dense":
        return dense_tables(scene)
    if scene.accel == "binned":
        from ..accel.traverse import binned_tables

        return binned_tables(scene)
    if scene.accel == "sweep":
        return sweep_tables(scene)
    return None


def _use_krn(scene: SceneData) -> bool:
    return scene.has_kernel_records and (
        scene.lean or os.environ.get("PTX_WAVEFRONT_KRN", "0") == "1")


def scene_intersect(scene: SceneData, o, d, t_max=None, live=None, any_hit: bool = False,
                    tables=None):
    """Nearest hit (t [R], prim [R] i64; -1 / -1 on a miss) of rays o, d
    [R, 3] (ops/intersect.py:439-508). `t_max` [R]: hits at t >= t_max
    count as misses (shadow rays). `live` [R] bool: lanes with live False
    may return any result (the binned intersectors skip them). `any_hit`:
    the hit need not be the nearest (the binned intersectors stop early).
    `tables`: query_tables(scene), packed once by a caller that queries
    many times."""
    if scene.accel == "binned":
        from ..accel.traverse import binned_intersect, krn_intersect

        if _use_krn(scene):
            return krn_intersect(scene, o, d, t_max=t_max, live=live, any_hit=any_hit,
                                 tables=tables)
        if scene.lean:
            raise ValueError("lean-built scene without kernel records: rebuild with "
                             "lean=False for the wavefront")
        return binned_intersect(scene, o, d, t_max=t_max, live=live, any_hit=any_hit,
                                tables=tables)
    if scene.accel == "sweep":
        t, p = sweep_intersect(scene, o, d, tables=tables)
    elif scene.accel == "cluster":
        t, p = cluster_intersect(scene, o, d)
    elif scene.accel == "bvh":
        t, p = bvh_intersect(scene, o, d)
    else:
        t, p = dense_intersect(scene, o, d, tables)
    if t_max is not None:
        miss = (t < 0.0) | (t >= t_max)
        t = torch.where(miss, -1.0, t)
        p = torch.where(miss, -1, p)
    return t, p
