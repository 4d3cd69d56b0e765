"""Batched BSDFs: Lambertian, glass (Fresnel), mirror (port of
`cpupathtrace_tpu/bsdf/bsdf.py`; ref: src/scene/propagation.cpp).

The reference's virtual `BSDF` dispatch becomes a type code per material and
masked selects. Contracts kept:
  * propagate -> (next_origin, next_dir, ray_factor, ray_pd)
  * eval_spectrum -> (spectrum, shade_factor, pd); `synthetic=True` marks
    NEE shadow rays, for which specular BSDFs report pd = 0 and so opt out
    of next-event estimation (ref: propagation.cpp:173, 214).

Sampled directions are detached; the spectrum evaluations stay
differentiable in the material table (diffuse / specular / emission).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.scene import BSDF_GLASS, BSDF_MIRROR, SceneData
from ..utils.math import PI, dot, local_to_global, normalize, reflect


class RayMaterial(NamedTuple):
    """Material table rows gathered for a batch of hit points."""

    diffuse: torch.Tensor  # [R,4]
    specular: torch.Tensor  # [R,4]
    ior: torch.Tensor  # [R]
    emission: torch.Tensor  # [R,4]
    bsdf: torch.Tensor  # [R] i32
    one_way: torch.Tensor  # [R] bool


def material_ids(scene: SceneData, prim: torch.Tensor) -> torch.Tensor:
    """prim -> material id (int64); invalid prims clamp to row 0."""
    is_tri = prim < scene.n_tri
    p = prim.clamp_min(0)
    tid = scene.tri_material[p.clamp(0, scene.tri_material.shape[0] - 1).long()]
    sid = scene.sph_material[(p - scene.n_tri).clamp(0, scene.sph_material.shape[0] - 1).long()]
    return torch.where(is_tri, tid, sid).long()


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] by index_select, whose backward is an index_add: a
    handful of materials gathered by a million lanes would serialise the
    sort-based backward of advanced indexing on CUDA."""
    return torch.index_select(table, 0, idx.reshape(-1)).reshape(idx.shape + table.shape[1:])


def gather_material(scene: SceneData, prim: torch.Tensor) -> RayMaterial:
    """prim -> material id -> table rows."""
    mid = material_ids(scene, prim)
    return RayMaterial(
        diffuse=_rows(scene.mat_diffuse, mid),
        specular=_rows(scene.mat_specular, mid),
        ior=_rows(scene.mat_ior, mid),
        emission=_rows(scene.mat_emission, mid),
        bsdf=_rows(scene.mat_bsdf, mid),
        one_way=_rows(scene.mat_one_way, mid),
    )


def importance_sample_cosine(u1, u2, e=1.0):
    """Cosine-power hemisphere sample in tangent space with pdf
    (e+1) cos^e(theta) / 2pi (ref: propagation.cpp:11-21)."""
    fac = torch.sqrt(1.0 - torch.pow(u2, 2.0 / (e + 1.0)))
    cos_theta = torch.pow(u2, 1.0 / (e + 1.0))
    vec = torch.stack(
        [fac * torch.cos(2.0 * PI * u1), fac * torch.sin(2.0 * PI * u1), cos_theta], dim=-1
    )
    p = (e + 1.0) * torch.pow(cos_theta, e) / (2.0 * PI)
    return vec, p


def fresnel_reflectance(ray_dot, ri_leaving, ri_entering):
    """Unpolarised Fresnel reflectance and the transmitted cosine; total
    internal reflection gives (1, 0) (ref: propagation.cpp:64-83)."""
    sin_i = torch.sqrt((1.0 - ray_dot * ray_dot).clamp_min(0.0))
    sin_t = ri_leaving / ri_entering * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt((1.0 - sin_t * sin_t).clamp_min(0.0))
    r_par = (ri_entering * ray_dot - ri_leaving * cos_t) / (
        ri_entering * ray_dot + ri_leaving * cos_t
    )
    r_perp = (ri_leaving * ray_dot - ri_entering * cos_t) / (
        ri_leaving * ray_dot + ri_entering * cos_t
    )
    reflectance = (r_par * r_par + r_perp * r_perp) / 2.0
    return torch.where(tir, 1.0, reflectance), torch.where(tir, 0.0, cos_t)


def propagate(mat: RayMaterial, ray_dir, pos, normal, epsilon, u):
    """Sample the outgoing ray of every lane from uniforms u [R,3]
    (u1, u2, bernoulli): (next_origin [R,3], next_dir [R,3] detached,
    ray_factor [R], ray_pd [R])."""
    u1, u2, ub = u[..., 0], u[..., 1], u[..., 2]

    # Lambertian (ref: propagation.cpp:89-104).
    local, p_lam = importance_sample_cosine(u1, u2, 1.0)
    dir_lam = local_to_global(local, normal)
    ones = torch.ones_like(p_lam)

    # Glass (ref: propagation.cpp:120-160).
    ray_dot = -dot(ray_dir, normal)
    entering = ray_dot >= 0.0
    ri_leaving = torch.where(entering, 1.0, mat.ior)
    ri_entering = torch.where(entering, mat.ior, 1.0)
    rat, cos_t = fresnel_reflectance(ray_dot.abs(), ri_leaving, ri_entering)
    reflect_choice = ub < rat
    sign = torch.where(ray_dot < 0.0, -1.0, 1.0)
    dir_reflect = reflect(ray_dir, normal * sign[..., None])
    ratio = ri_leaving / ri_entering
    dir_refract = normalize(
        ray_dir * ratio[..., None]
        + normal * ((ratio * ray_dot.abs() - cos_t) * sign)[..., None]
    )
    ri_fac = (ri_entering * ri_entering) / (ri_leaving * ri_leaving)
    dir_glass = torch.where(reflect_choice[..., None], dir_reflect, dir_refract)
    fac_glass = torch.where(reflect_choice, rat, ri_fac * (1.0 - rat))
    p_glass = torch.where(reflect_choice, rat, 1.0 - rat)

    # Mirror (ref: propagation.cpp:180-204).
    unaligned = dot(ray_dir, normal) > 0.0
    pass_through = mat.one_way & unaligned
    flip = ~mat.one_way & unaligned
    normal_dir = normal * torch.where(flip, -1.0, 1.0)[..., None]
    dir_mirror = torch.where(pass_through[..., None], ray_dir, reflect(ray_dir, normal_dir))

    is_glass = mat.bsdf == BSDF_GLASS
    is_mirror = mat.bsdf == BSDF_MIRROR
    next_dir = torch.where(
        is_glass[..., None], dir_glass, torch.where(is_mirror[..., None], dir_mirror, dir_lam)
    )
    ray_factor = torch.where(is_glass, fac_glass, ones)
    ray_pd = torch.where(is_glass, p_glass, torch.where(is_mirror, ones, p_lam))
    next_dir = next_dir.detach()
    return pos + next_dir * epsilon, next_dir, ray_factor, ray_pd


def eval_spectrum(mat: RayMaterial, from_dir, to_dir, normal, light_spectrum,
                  synthetic: bool):
    """(spectrum, shade_factor, pd) for a direction pair, the batched
    BSDF::getSpectrum (ref: propagation.cpp:107-116, 163-177, 207-219)."""
    shade_lam = dot(normal, to_dir).clamp_min(0.0) / PI
    spec_lam = mat.diffuse * light_spectrum
    ones = torch.ones_like(shade_lam)

    # Glass: the specular colour when transmitting to the other side.
    same_side = dot(from_dir, to_dir) <= 0.0
    spec_glass = light_spectrum * torch.where(same_side[..., None], mat.specular, mat.diffuse)
    # Mirror: specular unless one-way backface transmission.
    mirror_mul = torch.where(
        (~mat.one_way | same_side)[..., None], mat.specular, torch.ones_like(mat.specular)
    )
    spec_mirror = light_spectrum * mirror_mul

    pd_specular = torch.zeros_like(ones) if synthetic else ones
    is_glass = mat.bsdf == BSDF_GLASS
    is_mirror = mat.bsdf == BSDF_MIRROR
    spectrum = torch.where(
        is_glass[..., None], spec_glass, torch.where(is_mirror[..., None], spec_mirror, spec_lam)
    )
    is_spec = is_glass | is_mirror
    return spectrum, torch.where(is_spec, ones, shade_lam), torch.where(is_spec, pd_specular, ones)
