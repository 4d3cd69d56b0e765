"""Batched ray-primitive intersection and the scene intersector of the
wavefront (port of `cpupathtrace_tpu/ops/intersect.py`).

Primitive tests as the reference's:
  * triangle: Moller-Trumbore, eps 1e-6, optional backface culling
    (ref: src/scene/object.cpp:146-182)
  * sphere: near root; rays starting inside report the negative entry
    distance and so miss (ref: object.cpp:72-84)
  * AABB: slab test, FLT_MAX inverse for zero direction components, 0 when
    the origin is inside, -1 on a miss (ref: bounding_box.cpp:38-73)

`scene_intersect` serves dense scenes: on a CUDA device through the dense
query kernel K5 (csrc/dense_query.cu, the port of `_dense_kernel`,
ops/pallas_intersect.py:31), whatever the scene's size; on the CPU through
its plain version `dense_intersect_reference`. The binned, sweep, bvh and
cluster intersectors are ROADMAP.md Queue 1 item 17 and raise.
"""
from __future__ import annotations

import ctypes

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
    f32 = torch.float32
    t_rows = scene.tri_v0.shape[0]
    s_rows = scene.sph_center.shape[0]
    dev = scene.device
    tri = torch.cat([
        scene.tri_v0, scene.tri_v1 - scene.tri_v0, scene.tri_v2 - scene.tri_v0,
        scene.tri_cull.to(f32)[:, None], scene.tri_valid.to(f32)[:, None],
        torch.zeros((t_rows, TRI_COLS - 11), dtype=f32, device=dev),
    ], dim=1)
    sph = torch.cat([
        scene.sph_center, scene.sph_radius[:, None], scene.sph_valid.to(f32)[:, None],
        torch.zeros((s_rows, SPH_COLS - 5), dtype=f32, device=dev),
    ], dim=1)
    return tri.contiguous(), sph.contiguous()


def dense_intersect_reference(scene: SceneData, o, d, tables=None):
    """The plain version of K5: nearest (t, prim) over every triangle, then
    every sphere, a primitive winning only by strict improvement (so the
    lowest row wins a tie, as `argmin` in the jnp version). t = -1 and
    prim = -1 on a miss; prim in the global index space."""
    dense_intersect_reference.calls += 1
    if tables is None:
        tables = dense_tables(scene.to(o.device))
    tri, sph = tables
    t, p, *_ = table_nearest(tri, sph, o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                             scene.n_tri)
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


def dense_intersect(scene: SceneData, o, d, tables=None):
    """Nearest (t [R] f32, prim [R] i64) over all primitives of a dense
    scene; -1 / -1 on a miss. CPU rays take the plain version; CUDA rays
    launch K5 (csrc/dense_query.cu) whatever the scene's size."""
    dev = o.device
    if dev.type == "cpu":
        return dense_intersect_reference(scene, o, d, tables)
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
    if scene.n_tri > tri.shape[0]:
        raise ValueError(f"dense_intersect: {scene.n_tri} triangles, table has {tri.shape[0]}")
    t = torch.empty(r, dtype=torch.float32, device=dev)
    p = torch.empty(r, dtype=torch.int32, device=dev)
    if r:
        with torch.cuda.device(dev):
            err = _dense_fn()(
                o.data_ptr(), d.data_ptr(), t.data_ptr(), p.data_ptr(), r,
                tri.data_ptr(), scene.n_tri, sph.data_ptr(), sph.shape[0],
                torch.cuda.current_stream(dev).cuda_stream,
            )
        if err:
            raise RuntimeError(f"dense_query launch failed: cudaError_t {err}")
        dense_intersect.launches += 1
    return t, p.long()


dense_intersect.launches = 0


def scene_intersect(scene: SceneData, o, d, t_max=None, live=None, any_hit: bool = False,
                    tables=None):
    """Nearest hit (t [R], prim [R] i64; -1 / -1 on a miss) of rays o, d
    [R, 3] (ops/intersect.py:439-508). `t_max` [R]: hits at t >= t_max
    count as misses (shadow rays). `live` and `any_hit` are qualifiers an
    intersector may use to skip work; the dense query computes every lane
    and the nearest hit, which satisfies both. `tables`: dense_tables(),
    packed once by a caller that queries many times."""
    if scene.accel != "dense":
        raise NotImplementedError(
            f"scene_intersect for accel {scene.accel!r}: the binned, sweep, bvh "
            "and cluster intersectors of the wavefront are ROADMAP.md Queue 1 item 17"
        )
    t, p = dense_intersect(scene, o, d, tables)
    if t_max is not None:
        miss = (t < 0.0) | (t >= t_max)
        t = torch.where(miss, -1.0, t)
        p = torch.where(miss, -1, p)
    return t, p
