"""Surface queries on the unified primitive index space: shading normals and
uniform surface sampling (port of `cpupathtrace_tpu/ops/surface.py`).

  * triangle: barycentric-interpolated vertex normals
    (ref: src/scene/object.cpp:126-144)
  * sphere: radial normal (ref: object.cpp:86-88)
  * triangle sampling: sqrt warp, pdf 1/area (ref: object.cpp:192-207)
  * sphere sampling: uniform, pdf 1/(4 pi r^2) (ref: object.cpp:101-116)
"""
from __future__ import annotations

import torch

from ..scene.scene import SceneData
from ..utils.math import PI, cross, dot, length, normalize


def _gather_tri(scene: SceneData, idx: torch.Tensor):
    idx = idx.clamp(0, scene.tri_v0.shape[0] - 1).long()
    return (
        scene.tri_v0[idx], scene.tri_v1[idx], scene.tri_v2[idx],
        scene.tri_n0[idx], scene.tri_n1[idx], scene.tri_n2[idx],
        scene.tri_cull[idx],
    )


def surface_normal(scene: SceneData, prim: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Shading normal at `pos` [..., 3] on primitive `prim` [...]."""
    is_tri = prim < scene.n_tri
    v0, v1, v2, n0, n1, n2, _ = _gather_tri(scene, torch.where(is_tri, prim, 0))
    ab = v1 - v0
    ac = v2 - v0
    ap = pos - v0
    d00 = dot(ab, ab)
    d01 = dot(ab, ac)
    d11 = dot(ac, ac)
    d20 = dot(ap, ab)
    d21 = dot(ap, ac)
    inv_d = 1.0 / (d00 * d11 - d01 * d01)
    v = (d11 * d20 - d01 * d21) * inv_d
    w = (d00 * d21 - d01 * d20) * inv_d
    u = 1.0 - v - w
    n_tri = normalize(n0 * u[..., None] + n1 * v[..., None] + n2 * w[..., None])
    sidx = (prim - scene.n_tri).clamp(0, scene.sph_center.shape[0] - 1).long()
    n_sph = normalize(pos - scene.sph_center[sidx])
    return torch.where(is_tri[..., None], n_tri, n_sph)


def sample_prim_surface(scene: SceneData, prim: torch.Tensor, u1: torch.Tensor,
                        u2: torch.Tensor):
    """A uniform point on primitive `prim`: (pos [..., 3], pdf [...],
    cull [...] bool), Object::sampleSurface's contract (ref: object.h:54)."""
    is_tri = prim < scene.n_tri
    v0, v1, v2, _, _, _, cull_tri = _gather_tri(scene, torch.where(is_tri, prim, 0))
    rr1 = torch.sqrt(u1)
    pos_tri = (
        v0 * (1.0 - rr1)[..., None]
        + v1 * (rr1 * (1.0 - u2))[..., None]
        + v2 * (rr1 * u2)[..., None]
    )
    area = length(cross(v1 - v0, v2 - v0)) / 2.0
    pdf_tri = 1.0 / area.clamp_min(1e-30)

    sidx = (prim - scene.n_tri).clamp(0, scene.sph_center.shape[0] - 1).long()
    c = scene.sph_center[sidx]
    r = scene.sph_radius[sidx]
    theta = 2.0 * PI * u1
    phi = torch.arccos((1.0 - 2.0 * u2).clamp(-1.0, 1.0))
    sp = torch.sin(phi)
    unit = torch.stack([sp * torch.cos(theta), sp * torch.sin(theta), torch.cos(phi)], dim=-1)
    pos_sph = c + unit * r[..., None]
    pdf_sph = 1.0 / (4.0 * PI * r * r).clamp_min(1e-30)

    pos = torch.where(is_tri[..., None], pos_tri, pos_sph)
    pdf = torch.where(is_tri, pdf_tri, pdf_sph)
    cull = is_tri & cull_tri
    return pos, pdf, cull
