"""Next-event-estimation light sampling (port of
`cpupathtrace_tpu/scene/lights.py`; ref: src/scene/scene.cpp:222-289).

Every shading point gets all point lights plus `emissive_sample_count`
CDF-drawn emissive primitive samples: a fixed [R, L+K] batch. Invalid
samples (zero cosine, coincident points, culled backfaces: the `continue`s
of scene.cpp:266-277) carry valid = False and contribute exactly 0.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..bsdf.bsdf import gather_material
from ..ops.surface import sample_prim_surface, surface_normal
from ..scene.scene import SceneData
from ..utils.math import dot, length_squared, normalize


class LightSamples(NamedTuple):
    target: torch.Tensor  # [R, NL, 3] sampled light position
    spectrum: torch.Tensor  # [R, NL, 4] emitted spectrum toward the point
    pd: torch.Tensor  # [R, NL] solid-angle pdf
    valid: torch.Tensor  # [R, NL] bool


def num_light_samples(scene: SceneData) -> int:
    return scene.n_point_lights + scene.emissive_sample_count


def sample_lights(scene: SceneData, pos: torch.Tensor, u: torch.Tensor | None) -> LightSamples:
    """pos [R,3]; u [R, K, 3] uniforms (rsel, u1, u2) of the K emissive
    draws (None when K = 0). Returns the [R, L+K] light batch."""
    r = pos.shape[0]
    dev = pos.device
    targets, specs, pds, valids = [], [], [], []

    # Point lights: delta lights, pdf 1 (ref: light.cpp:33-41).
    nl = scene.n_point_lights
    if nl > 0:
        targets.append(scene.light_pos[:nl][None].expand(r, nl, 3))
        specs.append(scene.light_spectrum[:nl][None].expand(r, nl, 4))
        pds.append(torch.ones((r, nl), device=dev))
        valids.append(torch.ones((r, nl), dtype=torch.bool, device=dev))

    # Emissive primitives by CDF lower bound (ref: scene.cpp:238-287).
    k = scene.emissive_sample_count
    if k > 0:
        cdf = scene.emissive_cdf
        rsel = u[..., 0].contiguous()
        idx = torch.searchsorted(cdf, rsel, right=False).clamp(0, cdf.shape[0] - 1)
        cdf_hi = cdf[idx]
        cdf_lo = torch.where(idx > 0, cdf[(idx - 1).clamp_min(0)], 0.0)
        selection_p = (cdf_hi - cdf_lo) * float(k)

        prim = scene.emissive_prim[idx].long()
        spos, surface_p, cull = sample_prim_surface(scene, prim, u[..., 1], u[..., 2])
        snorm = surface_normal(scene, prim, spos)

        to_light = spos - pos[:, None, :]
        dist2 = length_squared(to_light)
        ldir = normalize(to_light)
        abs_dot = dot(-ldir, snorm).abs()
        valid = (abs_dot > 0.0) & (dist2 > 0.0)
        valid = valid & torch.where(cull, dot(ldir, snorm) < 0.0, True)
        # Area -> solid-angle measure, |d|^2 / |cos| (ref: scene.cpp:280).
        conversion = dist2 / abs_dot.clamp_min(1e-30)
        targets.append(spos)
        specs.append(gather_material(scene, prim).emission)
        pds.append(selection_p * surface_p * conversion)
        valids.append(valid)

    if not targets:
        return LightSamples(
            torch.zeros((r, 0, 3), device=dev), torch.zeros((r, 0, 4), device=dev),
            torch.zeros((r, 0), device=dev), torch.zeros((r, 0), dtype=torch.bool, device=dev),
        )
    return LightSamples(
        torch.cat(targets, 1), torch.cat(specs, 1), torch.cat(pds, 1), torch.cat(valids, 1)
    )
