"""The plain reference's path tracer: the upstream estimator
(CPUPathTrace src/worker.cpp traceRay, src/scene/propagation.cpp,
src/scene/scene.cpp's emitter sampling) over a batch of camera paths, in
plain torch, one bounce of every live path at a time.

A path draws, per vertex, from its own stream (rng.py) in the order the
program's estimator defines: the roulette draw, then (selection, u1, u2)
per emitter draw, then (u1, u2, u_bsdf) when it bounces on. Russian
roulette starts past depth 4 (continue with 0.1 + 0.1 min(contrib * mean
throughput, 1)); next-event estimation samples `em_k` emitters by their
power CDF, area-uniformly on the triangle, with a shadow ray from the
vertex offset by epsilon; glass is Fresnel-weighted reflection or
refraction, Lambertian a cosine sample.

With `params` (diffuse / specular / emission [M,3] tensors), the radiance
keeps its graph to them while every sampling decision is made on detached
values: the gradient of the estimate under fixed samples.
"""
from __future__ import annotations

import math

import torch

from . import rng as prng
from .intersect import Geometry
from .scene import RefScene

PD_CUTOFF = 1e-20
PI = math.pi


def _dot(a, b):
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)


def trace(scene: RefScene, geo: Geometry, origin, direction, state, max_depth: int,
          eps: float, params: dict | None = None, dtype=torch.float32):
    """Trace paths from `origin`, `direction` [N,3] with streams `state` [N]
    (int64). Returns (radiance [N,3], collected [N] bool, bounces [max_depth]
    live paths entering each depth)."""
    dev = origin.device
    n = origin.shape[0]
    grad = params is not None
    mats = params if grad else {"diffuse": scene.diffuse, "specular": scene.specular,
                                "emission": scene.emission}
    keys = ("diffuse", "specular", "emission")
    dif, spc, emi = (mats[k].detach().to(dtype) for k in keys)
    # With params the radiance is carried in float64 with its graph, so the
    # reference's gradient sums are exact to far below the program's.
    rd = torch.float64 if grad else dtype
    difr, spcr, emir = (mats[k].to(rd) for k in keys) if grad else (dif, spc, emi)
    ior_t = scene.ior.to(dtype)
    em = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in scene.em.items()}
    n_em = em["cdf"].shape[0]
    o = origin.to(dtype).clone()
    d = direction.to(dtype).clone()
    ones = torch.ones(n, dtype=dtype, device=dev)
    # Divisors as tensors: a CUDA division by a Python number is a product
    # with its reciprocal.
    three, pi, two_pi = (torch.full((1,), v, dtype=dtype, device=dev) for v in (3.0, PI, 2 * PI))
    divisor, bounce_pd, contrib = ones.clone(), ones.clone(), ones.clone()
    s = torch.ones((n, 3), dtype=dtype, device=dev)
    sr = torch.ones((n, 3), dtype=rd, device=dev)
    out = torch.zeros((n, 3), dtype=rd, device=dev)
    collected = torch.zeros(n, dtype=torch.bool, device=dev)
    rs = state.clone()
    live = torch.arange(n, device=dev)
    entering = []

    def draw(idx):
        rs[idx], u = prng.next_u01(rs[idx])
        return u.to(dtype)

    for depth in range(max_depth):
        if live.numel() == 0:
            break
        entering.append(live.numel())
        t, prim, hu, hv = geo.nearest(o[live], d[live])
        hit = prim >= 0
        live, t, prim, hu, hv = live[hit], t[hit], prim[hit], hu[hit], hv[hit]
        if live.numel() == 0:
            break
        collected[live] = True
        ol, dl = o[live], d[live]
        w0 = 1.0 - hu - hv
        sn = (w0[:, None] * scene.n0[prim].to(dtype) + hu[:, None] * scene.n1[prim].to(dtype)
              + hv[:, None] * scene.n2[prim].to(dtype))
        nrm = sn * torch.rsqrt(_dot(sn, sn) + 1e-30)[:, None]
        p = ol + dl * t[:, None]
        mid = scene.mat[prim]
        bsdf = scene.bsdf[mid]
        is_glass, is_mirror = bsdf == 1, bsdf == 2
        is_spec = is_glass | is_mirror
        one_way = scene.one_way[mid]
        sl = s[live]
        slr = sr[live] if grad else sl
        div0, bpd0 = divisor[live], bounce_pd[live]

        # Emission.
        weight = 1.0 / (div0 * bpd0)
        out = out.index_add(0, live, slr * emir[mid] * weight[:, None].to(rd))

        # Russian roulette (worker.cpp:67-70).
        if depth + 1 > 4:
            mean_s = (sl[:, 0] + sl[:, 1] + sl[:, 2]) / three
            bpv = 0.1 + 0.1 * torch.minimum(contrib[live] * mean_s, torch.ones_like(mean_s))
        else:
            bpv = torch.ones_like(div0)
        do_bounce = draw(live) < bpv

        # Next-event estimation over emitter draws.
        for _ in range(scene.em_k):
            rsel, u1, u2 = draw(live), draw(live), draw(live)
            row = torch.searchsorted(em["cdf"].float(), rsel.float()).clamp_max(n_em - 1)
            sq = torch.sqrt(u1)
            w2 = sq * (1.0 - u2)
            w3 = sq * u2
            sp = em["v0"][row] + w2[:, None] * em["e1"][row] + w3[:, None] * em["e2"][row]
            snl = em["normal"][row]
            s_pd = em["sel_p"][row] * em["pd_area"][row]
            tl = sp - p
            dist2 = _dot(tl, tl)
            invd = torch.rsqrt(dist2.clamp_min(1e-30))
            ldn = _dot(tl * invd[:, None], snl)
            adot = (-ldn).abs()
            cullm = scene.cull[em["prim"][row]]
            lvalid = (adot > 0) & (dist2 > 0) & (~cullm | (ldn < 0))
            lpd = s_pd * dist2 / adot.clamp_min(1e-30)
            use = ~is_spec & lvalid & (lpd > 0)
            dist = torch.sqrt(dist2)
            ld = tl * (1.0 / dist.clamp_min(1e-30))[:, None]
            occ = torch.ones_like(use)
            q = use.nonzero()[:, 0]
            if q.numel():
                occ[q] = geo.occluded(p[q] + ld[q] * eps, ld[q], dist[q] - eps)
            use = use & ~occ
            cos_s = _dot(nrm, ld).clamp_min(0.0)
            w = torch.where(use, (cos_s / pi) / (div0 * bpd0 * lpd), torch.zeros_like(lpd))
            out = out.index_add(0, live, w[:, None].to(rd) * difr[mid] * emir[em["mat"][row]] * slr)

        # Roulette bookkeeping (worker.cpp:106-110).
        bpd = torch.where(do_bounce, bpd0 * bpv, bpd0 * (1.0 - bpv))
        bounce_pd[live] = bpd
        go = do_bounce & (bpd > PD_CUTOFF)
        live, nrm, p, dl, sl, slr = live[go], nrm[go], p[go], dl[go], sl[go], slr[go]
        mid, is_glass, is_mirror, one_way = mid[go], is_glass[go], is_mirror[go], one_way[go]
        if live.numel() == 0:
            break
        u1, u2, ub = draw(live), draw(live), draw(live)

        # Propagation (propagation.cpp): glass, mirror, Lambertian.
        ray_factor = torch.ones_like(u1)
        ray_pd = torch.ones_like(u1)
        # Fresnel, unpolarised.
        ior = ior_t[mid]
        ray_dot = -_dot(dl, nrm)
        entering_g = ray_dot >= 0
        ri_l = torch.where(entering_g, torch.ones_like(ior), ior)
        ri_e = torch.where(entering_g, ior, torch.ones_like(ior))
        adot = ray_dot.abs()
        sin_i = torch.sqrt((1.0 - adot * adot).clamp_min(0.0))
        sin_t = ri_l / ri_e * sin_i
        tir = sin_t >= 1.0
        cos_tt = torch.sqrt((1.0 - sin_t * sin_t).clamp_min(0.0))
        r_par = (ri_e * adot - ri_l * cos_tt) / (ri_e * adot + ri_l * cos_tt)
        r_perp = (ri_l * adot - ri_e * cos_tt) / (ri_l * adot + ri_e * cos_tt)
        rat = torch.where(tir, torch.ones_like(adot), (r_par * r_par + r_perp * r_perp) * 0.5)
        cos_tt = torch.where(tir, torch.zeros_like(cos_tt), cos_tt)
        refl = ub < rat
        sgn = torch.where(ray_dot < 0, -torch.ones_like(adot), torch.ones_like(adot))
        ns = nrm * sgn[:, None]
        g_refl = dl - 2.0 * _dot(dl, ns)[:, None] * ns
        ratio = ri_l / ri_e
        f = dl * ratio[:, None] + nrm * (ratio * adot - cos_tt)[:, None] * sgn[:, None]
        g_refr = f * torch.rsqrt(_dot(f, f) + 1e-30)[:, None]
        g_dir = torch.where(refl[:, None], g_refl, g_refr)
        g_factor = torch.where(refl, rat, (ri_e * ri_e) / (ri_l * ri_l) * (1.0 - rat))
        g_pd = torch.where(refl, rat, 1.0 - rat)
        # Mirror.
        unaligned = _dot(dl, nrm) > 0
        msgn = torch.where(unaligned, -torch.ones_like(adot), torch.ones_like(adot))
        nm = nrm * msgn[:, None]
        m_dir = torch.where((one_way & unaligned)[:, None], dl,
                            dl - 2.0 * _dot(dl, nm)[:, None] * nm)
        # Lambertian: cosine sample in a tangent frame of the normal.
        fac = torch.sqrt((1.0 - u2).clamp_min(0.0))
        cos_t = torch.sqrt(u2)
        ang = two_pi * u1
        lx, ly = fac * torch.cos(ang), fac * torch.sin(ang)
        nx, ny, nz = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        has_x, has_y = nx.abs() > 0, ny.abs() > 0
        zero, one = torch.zeros_like(nx), torch.ones_like(nx)
        tg = torch.stack([torch.where(has_x, zero, torch.where(has_y, -ny, one)),
                          torch.where(has_x, -nx, torch.where(has_y, nz, zero)),
                          torch.where(has_x, torch.where(has_y, ny, nz), zero)], 1)
        tg = tg * torch.rsqrt(_dot(tg, tg) + 1e-30)[:, None]
        b1 = _cross(tg, nrm)
        b1 = b1 * torch.rsqrt(_dot(b1, b1) + 1e-30)[:, None]
        b2 = _cross(b1, nrm)
        b2 = b2 * torch.rsqrt(_dot(b2, b2) + 1e-30)[:, None]
        l_dir = b1 * lx[:, None] + b2 * ly[:, None] + nrm * cos_t[:, None]
        l_pd = 2.0 * cos_t / two_pi

        nd = torch.where(is_glass[:, None], g_dir, torch.where(is_mirror[:, None], m_dir, l_dir))
        ray_factor = torch.where(is_glass, g_factor, ray_factor)
        ray_pd = torch.where(is_glass, g_pd, torch.where(is_mirror, ray_pd, l_pd))
        same_side = _dot(dl, nd) <= 0
        mm = ~one_way | same_side

        def colour(dm, sm):
            """The BSDF branch's colour: specular where glass reflects or a
            mirror reflects, 1 through a one-way mirror, else diffuse."""
            return torch.where((is_glass & same_side)[:, None], sm,
                               torch.where(is_glass[:, None], dm,
                                           torch.where(is_mirror[:, None],
                                                       torch.where(mm[:, None], sm,
                                                                   torch.ones_like(sm)),
                                                       dm)))

        lam = ~is_glass & ~is_mirror
        shading = torch.where(lam, _dot(nrm, nd).clamp_min(0.0) / pi, torch.ones_like(u1))
        div = (divisor[live] * (ray_pd / ray_factor.clamp_min(1e-30))
               * (1.0 / shading.clamp_min(1e-30)))
        divisor[live] = div
        contrib[live] = contrib[live] * ray_factor * shading
        s = s.index_copy(0, live, colour(dif[mid], spc[mid]) * sl)
        if grad:
            sr = sr.index_copy(0, live, colour(difr[mid], spcr[mid]) * slr)
        keep = div > PD_CUTOFF
        live, p, nd = live[keep], p[keep], nd[keep]
        o[live] = p + nd * eps
        d[live] = nd
    return out, collected, entering
