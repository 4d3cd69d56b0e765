"""An analytic sphere beside the reference's triangles, and the frozen path
tracer (tracer.py) over both.

The sphere test is the upstream near root (src/scene/object.cpp:72-84), in
the order of cpupathtrace_tpu_torch/ops/intersect.py `table_nearest`:
co = o - c, dd = d . co, disc = dd^2 - co . co + r^2, t = -(dd +
sqrt(max(disc, 0))), a hit where disc >= 0 and t >= 0; a ray that starts
inside the sphere misses it. The program tests its spheres first and its
triangles must improve strictly on them, so the sphere wins a tie. Its
shading normal is (o + d t - c) normalised as tracer.py normalises every
shading normal.

tracer.py takes a triangle's shading normal and material at the hit's
`prim`. `SphereGeometry.nearest` gives a ray that hits the sphere the prim
n_tri + its row in the query, barycentrics (0, 0), and keeps the query's
(o + d t - c); `SphereView` is the scene as tracer.py reads it, whose
n0 / n1 / n2 / mat rows past the triangles are that vector, zero, zero and
the sphere's material. So the tracer's own branches (the mirror among
them) shade the sphere with its normal. The sphere emits nothing: the
emitter table is the triangles'.
"""
from __future__ import annotations

import dataclasses

import torch

from .intersect import Geometry
from .scene import RefScene
from .tracer import trace


@dataclasses.dataclass
class SphereScene:
    """The triangles' RefScene and one sphere (float32 centre [3] and
    radius on the same device, material id into the triangles' table)."""

    tris: RefScene
    center: torch.Tensor
    radius: torch.Tensor
    material: int


def sphere_hit(o, d, center, radius):
    """(t [R], hit [R]) of rays o, d [R, 3] against the sphere, in o's
    dtype."""
    c = center.to(o.dtype)
    r = radius.to(o.dtype)
    cox = o[:, 0] - c[0]
    coy = o[:, 1] - c[1]
    coz = o[:, 2] - c[2]
    dd = d[:, 0] * cox + d[:, 1] * coy + d[:, 2] * coz
    disc = dd * dd - (cox * cox + coy * coy + coz * coz) + r * r
    t = -(dd + torch.sqrt(disc.clamp_min(0.0)))
    return t, (disc >= 0.0) & (t >= 0.0)


class SphereGeometry:
    """Nearest and shadow queries over the triangles (intersect.Geometry)
    and the sphere."""

    def __init__(self, scene: SphereScene, dtype=torch.float32):
        self.tris = Geometry(scene.tris, dtype=dtype)
        self.n_tri = scene.tris.n_tri
        self.center = scene.center
        self.radius = scene.radius
        # [R, 3] o + d t - c of the last nearest query. SphereView reads it
        # by that query's rows, so a sphere hit's normal must be read before
        # the next `nearest` call (tracer.py reads n0[prim] right after its
        # query); a later query overwrites it.
        self.hit_vector = None

    def nearest(self, o, d):
        """(t, prim, u, v) as Geometry.nearest's; a sphere hit has prim
        n_tri + its row and u = v = 0."""
        t, prim, u, v = self.tris.nearest(o, d)
        ts, ok = sphere_hit(o, d, self.center, self.radius)
        won = ok & ~(t < ts)
        rows = torch.arange(o.shape[0], device=o.device)
        t = torch.where(won, ts, t)
        self.hit_vector = (o + d * t[:, None]) - self.center.to(o.dtype)
        zero = torch.zeros_like(u)
        return (t, torch.where(won, self.n_tri + rows, prim), torch.where(won, zero, u),
                torch.where(won, zero, v))

    def occluded(self, o, d, t_max):
        """True where a triangle or the sphere lies below t_max."""
        ts, ok = sphere_hit(o, d, self.center, self.radius)
        return self.tris.occluded(o, d, t_max) | (ok & (ts < t_max))


class _HitRows:
    """A per-triangle table whose rows past the triangles are `extra(j)`
    for the sphere hit of query row j."""

    def __init__(self, table, extra):
        self.table = table
        self.extra = extra

    def __getitem__(self, prim):
        n = self.table.shape[0]
        tri = prim < n
        rows = self.table[torch.where(tri, prim, 0)]
        extra = self.extra(torch.where(tri, 0, prim - n)).to(rows.dtype)
        return torch.where(tri.view(-1, *[1] * (rows.dim() - 1)), rows, extra)


class SphereView:
    """`scene` as tracer.py reads it over `geo`'s queries: the triangles'
    tables, with the sphere hits' normal vector and material past them."""

    def __init__(self, scene: SphereScene, geo: SphereGeometry):
        self._tris = scene.tris
        zero = torch.zeros((1, 3), dtype=torch.float32, device=scene.center.device)
        mat = torch.full((1,), scene.material, dtype=torch.int64, device=scene.center.device)
        self.n0 = _HitRows(scene.tris.n0, lambda j: geo.hit_vector[j])
        self.n1 = _HitRows(scene.tris.n1, lambda j: zero.expand(j.shape[0], 3))
        self.n2 = _HitRows(scene.tris.n2, lambda j: zero.expand(j.shape[0], 3))
        self.mat = _HitRows(scene.tris.mat, lambda j: mat.expand(j.shape[0]))

    def __getattr__(self, name):
        return getattr(self._tris, name)


def sphere_tracer(scene: SphereScene, dtype=torch.float32):
    """tracer.py's `trace` over the triangles and the sphere, queried in
    `dtype`: a tracer as reference/film.py describes."""
    geo = SphereGeometry(scene, dtype=dtype)
    view = SphereView(scene, geo)

    def run(origin, direction, state, max_depth: int, eps: float, params=None):
        return trace(view, geo, origin, direction, state, max_depth, eps, params=params,
                     dtype=dtype)

    return run
