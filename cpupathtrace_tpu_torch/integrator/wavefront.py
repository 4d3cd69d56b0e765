"""The wavefront path-tracing integrator (port of
`cpupathtrace_tpu/integrator/wavefront.py`; ref: src/worker.cpp:26-146).

A batch of rays advances bounce by bounce under an alive mask. Per vertex:
emission weighted by 1 / (divisor * bounce_pd) (worker.cpp:62-64); NEE
toward every point light and K CDF-drawn emitter samples (:72-103);
Russian roulette with p = 1 to depth 4, then 0.1 + 0.1 * min(contrib *
mean_rgb, 1) (:67-70); termination on a miss, a roulette stop, bounce_pd
or divisor <= 1e-20 (:47, 106, 112, 134); alpha = any hit (:141-143).

Every intersection goes through `scene_intersect`, twice per bounce
(camera-side rays, then all shadow rays at once), with the query tables
packed once per trace: on a CUDA device a dense scene launches K5, a
binned scene the binned wavefront (K6, K7 and K5 for its dense part; K4
and K5 for a lean scene), a sweep, cluster or bvh scene runs its torch
walker. Geometry is not differentiable: the intersectors take the rays
detached, and gradients reach the materials.

Differentiation: pdf-side weights (divisor, bounce_pd, roulette p, light
and BSDF pdfs) are detached; the radiance side (albedo products, emission)
keeps its graph, so gradients reach the material table (the detached-
sampling estimator). The `where` guards on denominators of masked lanes
stay: a masked 1/0 would give the backward 0 * inf = NaN.

Random numbers: per bounce u_rt [n], u_nee [n, K, 3] (K > 0), u_prop
[n, 3] from `generator` (integrator/rng.py `uniform`: a torch.Generator,
or a RecordedDraws holding the JAX package's jax.random draws).
"""
from __future__ import annotations

import torch

from ..bsdf.bsdf import eval_spectrum, gather_material, propagate
from ..core import debug
from ..core.config import RenderOptions
from ..core.rays import Rays
from ..ops.intersect import query_tables, scene_intersect
from ..ops.surface import surface_normal
from ..scene.lights import num_light_samples, sample_lights
from ..scene.scene import BSDF_GLASS, BSDF_MIRROR, SceneData
from ..utils.math import length, normalize
from .rng import uniform

PD_CUTOFF = 1e-20


def _mean_rgb(spectrum):
    """getContribution: (r+g+b)/3 (ref: worker.cpp:12-14)."""
    return (spectrum[..., 0] + spectrum[..., 1] + spectrum[..., 2]) / 3.0


def _bounce(scene, tables, options, s, depth, generator):
    """One bounce over the whole batch; returns the new state dict."""
    o, d = s["o"], s["d"]
    n = o.shape[0]
    dev = o.device
    eps = options.epsilon
    debug.check_normalized(d, "ray direction")
    debug.check_non_negative(s["sample_spectrum"], "sample_spectrum")
    debug.check_non_negative(s["out"], "accumulated spectrum")
    debug.check_finite(s["divisor"], "sample_divisor")
    debug.check_finite(s["bounce_pd"], "sample_bounce_pd")

    t, prim = scene_intersect(scene, o, d, live=s["alive"], tables=tables)
    hit = s["alive"] & (t >= 0.0)
    prim_safe = prim.clamp_min(0)
    pos = o + d * t[:, None]
    normal = surface_normal(scene, prim_safe, pos)
    mat = gather_material(scene, prim_safe)
    collected = s["collected"] | hit

    divisor = s["divisor"]
    bounce_pd = s["bounce_pd"]
    ss = s["sample_spectrum"]
    # Dead lanes may carry divisor * bounce_pd == 0: guard the masked
    # denominator so the where's backward sees no 0 * inf.
    den = divisor * bounce_pd
    weight = torch.where(hit, 1.0 / torch.where(hit, den, 1.0), 0.0)
    out = s["out"] + torch.where(hit[:, None], ss * mat.emission * weight[:, None], 0.0)

    # Russian roulette (ref: worker.cpp:67-70); every alive lane is at
    # path length depth + 1.
    if depth + 1 <= 4:
        bp = torch.ones(n, device=dev)
    else:
        bp = 0.1 + 0.1 * torch.minimum(s["contrib"] * _mean_rgb(ss), torch.ones(n, device=dev))
    bp = bp.detach()
    u_rt = uniform(generator, (n,), dev)
    do_bounce = u_rt < bp

    # Next-event estimation (ref: worker.cpp:72-103).
    nl = num_light_samples(scene)
    if nl > 0:
        k = scene.emissive_sample_count
        u_nee = uniform(generator, (n, k, 3), dev) if k > 0 else None
        lights = sample_lights(scene, pos, u_nee)
        to_light = lights.target - pos[:, None, :]
        ldir = normalize(to_light)
        sh_o = (pos[:, None, :] + ldir * eps).reshape(-1, 3)
        sh_d = ldir.reshape(-1, 3)
        dist = length(to_light)
        is_spec = ((mat.bsdf == BSDF_GLASS) | (mat.bsdf == BSDF_MIRROR))[:, None]
        # Any occluder strictly before the light blocks (worker.cpp:84-86).
        # Specular lanes take no NEE, so they are not live for the query.
        lt, _ = scene_intersect(
            scene, sh_o.contiguous(), sh_d.contiguous(), t_max=(dist - eps).reshape(-1),
            live=(hit[:, None] & lights.valid & ~is_spec).reshape(-1), any_hit=True,
            tables=tables,
        )
        visible = lt.reshape(n, nl) < 0.0
        mat_l = type(mat)(*(
            x[:, None].expand((n, nl) + x.shape[1:]) for x in mat
        ))
        from_dir = d[:, None, :].expand(n, nl, 3)
        nrm = normal[:, None, :].expand(n, nl, 3)
        base_spec, shading, spd = eval_spectrum(mat_l, from_dir, ldir, nrm, lights.spectrum,
                                                synthetic=True)
        lpd = lights.pd.detach()
        spd = spd.detach()
        denom = divisor[:, None] * bounce_pd[:, None] * lpd * torch.where(spd > 0, spd, 1.0)
        use = hit[:, None] & lights.valid & visible & (spd > 0.0)
        contrib = (base_spec * shading[..., None] * ss[:, None, :]
                   / torch.where(use, denom, 1.0)[..., None])
        out = out + torch.where(use[..., None], contrib, 0.0).sum(dim=1)

    # Roulette bookkeeping (ref: worker.cpp:106-110).
    bounce_pd = torch.where(
        hit, torch.where(do_bounce, bounce_pd * bp, bounce_pd * (1.0 - bp)), bounce_pd
    )
    cont = hit & do_bounce & (bounce_pd > PD_CUTOFF)

    # Sample the next ray (ref: worker.cpp:117-130).
    u_prop = uniform(generator, (n, 3), dev)
    no, nd, ray_factor, ray_pd = propagate(mat, d, pos, normal, eps, u_prop)
    shaded, shading_factor, shading_pd = eval_spectrum(mat, d, nd, normal, ss, synthetic=False)
    ray_pd = ray_pd.detach()
    ray_factor = ray_factor.detach()
    shading_pd = shading_pd.detach()
    shading_factor = shading_factor.detach()
    divisor = torch.where(
        cont, divisor * (ray_pd / ray_factor) * (shading_pd / shading_factor), divisor
    )
    contrib_new = torch.where(cont, s["contrib"] * ray_factor * shading_factor, s["contrib"])
    ss = torch.where(cont[:, None], shaded, ss)
    alive = cont & (divisor > PD_CUTOFF)
    return dict(
        o=torch.where(alive[:, None], no, o).contiguous(),
        d=torch.where(alive[:, None], nd, d).contiguous(),
        sample_spectrum=ss, out=out, divisor=divisor, bounce_pd=bounce_pd,
        contrib=contrib_new, collected=collected, alive=alive,
    )


def trace(scene: SceneData, rays: Rays, options: RenderOptions, generator=None,
          differentiable: bool = False):
    """Trace a flat batch of rays to completion on the rays' device: returns
    (spectrum [R, 4] with alpha = any hit, collected [R] bool).

    `differentiable=True` runs all max_depth bounces (the JAX package's
    fixed-length scan, so the backward sees one graph per bounce);
    otherwise the loop stops once no ray is alive (one host read of the
    alive mask per bounce). `generator`: a torch.Generator (default: a new
    one on the device, unseeded) or a RecordedDraws."""
    o = rays.origin.contiguous()
    d = rays.direction.contiguous()
    n = o.shape[0]
    dev = o.device
    scene = scene.to(dev)
    if generator is None:
        generator = torch.Generator(device=dev)
    tables = query_tables(scene)
    s = dict(
        o=o, d=d,
        sample_spectrum=torch.ones((n, 4), device=dev),
        out=torch.zeros((n, 4), device=dev),
        divisor=torch.ones(n, device=dev),
        bounce_pd=torch.ones(n, device=dev),
        contrib=torch.ones(n, device=dev),
        collected=torch.zeros(n, dtype=torch.bool, device=dev),
        alive=torch.ones(n, dtype=torch.bool, device=dev),
    )
    for depth in range(int(options.max_depth)):
        if not differentiable and not bool(s["alive"].any()):
            break
        s = _bounce(scene, tables, options, s, depth, generator)
    collected = s["collected"]
    out = torch.cat([s["out"][:, :3], collected.to(torch.float32)[:, None]], dim=1)
    return out, collected


# With PTX_DEBUG=1 the checks of `trace` raise on the host themselves, so
# the JAX package's checked_trace is `trace`.
checked_trace = trace
