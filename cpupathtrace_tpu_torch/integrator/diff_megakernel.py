"""Differentiable rendering through the bounce kernel: record and replay
(port of `cpupathtrace_tpu/integrator/diff_megakernel.py`).

Under detached sampling the estimator (ref: src/worker.cpp:26-146) depends
on the material tables (theta = mat_diffuse / mat_specular / mat_emission)
only through per-vertex colour products. With S_v the running spectrum
product at vertex v (S_0 = 1, S_{v+1} = C_v(theta) * S_v for a material
colour C_v):

    out = sum_v S_v * emission[mid_v] * W_v                      (emission)
        + sum_v sum_l S_v * diffuse[mid_v] * E_l(theta) * w_vl    (NEE)

where W_v and w_vl are detached scalars, C_v is diffuse, specular or 1 by
the BSDF branch taken, and E_l is the light's spectrum (an emitter's
mat_emission, or a point light's constant spectrum).

So the forward runs K2 once per bounce in its record form (csrc/bounce.cu,
`bounce(records=...)`), which writes per (ray, bounce) only the discrete
and detached quantities: [mid, W, chain selector] + one weight per point
light + (CDF row, weight) per emitter draw. The backward is the
vector-Jacobian product of a replay of the two sums over those records,
with no traversal, sampling or BSDF logic (`trace_diff`, a
torch.autograd.Function). The replay reproduces the kernel's sums term by
term, so analytic gradients match finite differences of the forward under
common random numbers up to float32 reassociation (diff/render.py's
contract; its roulette caveat past depth 4 applies unchanged).
"""
from __future__ import annotations

import dataclasses
import os

import torch

from ..core.config import RenderOptions
from ..scene.scene import SceneData
from ..utils.profiling import trace_annotation
from .megakernel import megakernel_supported, pack_tables
from .sorted_wavefront import (
    bounce,
    clear_records,
    initial_state,
    n_diff_records,
    seed_depth_table,
)

#: The differentiable scene fields (diff/render.py).
DIFF_FIELDS = ("mat_diffuse", "mat_specular", "mat_emission")


def diff_supported(scene: SceneData) -> bool:
    """The record-and-replay path rides K2: the scene must fit the
    megakernels' limits, and PTX_ABLATE must be unset (read at the call,
    as diff_megakernel.py:62): K2's record form has no ablation."""
    return megakernel_supported(scene) and not os.environ.get("PTX_ABLATE")


def em_material_ids(scene: SceneData) -> torch.Tensor:
    """[n_em] material id of each emissive row: the replay's CDF row ->
    mat_emission map (pack_tables resolves rows alike)."""
    prim = scene.emissive_prim.long()
    is_sph = prim >= scene.n_tri
    ti = prim.clamp(0, scene.tri_v0.shape[0] - 1)
    si = (prim - scene.n_tri).clamp(0, scene.sph_center.shape[0] - 1)
    return torch.where(is_sph, scene.sph_material[si], scene.tri_material[ti]).long()


def trace_megakernel_diff(scene: SceneData, rays, options: RenderOptions, seed, tables=None):
    """The forward of the gradient path: K2 in its record form once per
    bounce over the unpermuted path state (the twin on the CPU). Returns
    (spectrum [R, 4] with alpha = collected, collected [R] bool, records
    [max_depth, R, n_drec] f32). Depths the loop never reaches keep the
    no-contribution encoding (mid -1, all weights 0). `seed`: an int32
    Python int or a 1-element tensor."""
    with trace_annotation("diff.record"):
        origin, direction = rays.origin, rays.direction
        dev = origin.device
        scene = scene.to(dev)
        if tables is None:
            tables = pack_tables(scene)
        r = origin.shape[0]
        max_depth = int(options.max_depth)
        n_drec = n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
        st = initial_state(origin, direction, seed)
        # Each bounce writes its depth's planes whole; the depths the loop
        # never reaches are cleared after it.
        planes = torch.empty((max_depth, n_drec, r), dtype=torch.float32, device=dev)
        seed_depth = seed_depth_table(seed, max_depth, dev)
        n_alive = r
        depth = 0
        while depth < max_depth and n_alive > 0:
            trace_megakernel_diff.live_rays += n_alive
            bounce(scene, st, seed_depth[depth], options, tables, records=planes[depth])
            with trace_annotation("diff.live_read"):
                n_alive = int((st[17] > 0.5).sum())  # the one host sync of the bounce
            trace_megakernel_diff.host_reads += 1
            depth += 1
        if depth < max_depth:
            clear_records(planes[depth:].transpose(0, 1))
        coll = st[16] > 0.5
        spectrum = torch.stack([st[10], st[11], st[12], coll.float()], dim=-1)
        return spectrum, coll, planes.permute(0, 2, 1)


# Per-process totals: host reads (one a bounce), rays entering each bounce.
trace_megakernel_diff.host_reads = 0
trace_megakernel_diff.live_rays = 0


def replay_spectrum(mats: dict, recs, em_mid, light_spec, n_lights: int, em_k: int):
    """The exact replay of records [D, R, n_drec] -> RGB sums [R, 3]:
    the kernel's emission and NEE accumulation term by term, kept as the
    reference of `replay_fast`."""
    dif = mats["mat_diffuse"][:, :3]
    spc = mats["mat_specular"][:, :3]
    emi = mats["mat_emission"][:, :3]
    n_mat = dif.shape[0]
    n_em = em_mid.shape[0]
    n_rays = recs.shape[1]
    s = torch.ones((n_rays, 3), dtype=dif.dtype, device=dif.device)
    out = torch.zeros((n_rays, 3), dtype=dif.dtype, device=dif.device)
    for plane in recs:
        mid = plane[:, 0].long().clamp(0, n_mat - 1)
        sel = plane[:, 2].long()
        d_m = dif[mid]
        out = out + s * emi[mid] * plane[:, 1, None]
        col = 3
        for li in range(n_lights):
            out = out + s * d_m * light_spec[li][None, :] * plane[:, col, None]
            col += 1
        for _ in range(em_k):
            row = plane[:, col].long().clamp(0, n_em - 1)
            out = out + s * d_m * emi[em_mid[row]] * plane[:, col + 1, None]
            col += 2
        c = torch.where((sel == 1)[:, None], d_m,
                        torch.where((sel == 2)[:, None], spc[mid], torch.ones_like(d_m)))
        s = torch.where((sel > 0)[:, None], c * s, s)
    return out


def preprocess_records(recs, em_mid, light_spec, n_mat: int, n_lights: int, em_k: int) -> dict:
    """One detached pass turning records [D, R, n_drec] into gather-free
    tensors for `replay_fast`: oh [D,R,M] hit-material one-hot (zero row on
    a miss); W [D,R]; sel1/2/3 [D,R] chain masks (diffuse / specular /
    ones); em_b [D,R,M] = sum_k onehot(material of CDF row k) * w_k; pl
    [D,R,3] = sum_l light_spec[l] * w_l."""
    one_hot = torch.nn.functional.one_hot
    mid = recs[:, :, 0].long()
    oh = one_hot(mid.clamp(0, n_mat - 1), n_mat).float() * (mid >= 0)[..., None]
    sel = recs[:, :, 2].long()
    col = 3
    pl = torch.zeros(recs.shape[:2] + (3,), dtype=torch.float32, device=recs.device)
    for li in range(n_lights):
        pl = pl + light_spec[li][None, None, :] * recs[:, :, col, None]
        col += 1
    n_em = em_mid.shape[0]
    em_b = torch.zeros(recs.shape[:2] + (n_mat,), dtype=torch.float32, device=recs.device)
    for _ in range(em_k):
        row = recs[:, :, col].long().clamp(0, n_em - 1)
        em_b = em_b + one_hot(em_mid[row], n_mat).float() * recs[:, :, col + 1, None]
        col += 2
    return {
        "oh": oh, "W": recs[:, :, 1].contiguous(),
        "sel1": (sel == 1).float(), "sel2": (sel == 2).float(), "sel3": (sel == 3).float(),
        "em_b": em_b, "pl": pl,
    }


def replay_fast(mats: dict, pre: dict):
    """Gather-free replay over preprocessed records -> RGB sums [R, 3]: the
    per-vertex colours as [D,R,M] x [M,3] products, then one running
    product over the depths."""
    dif = mats["mat_diffuse"][:, :3]
    spc = mats["mat_specular"][:, :3]
    emi = mats["mat_emission"][:, :3]
    diffs = torch.einsum("drm,mc->drc", pre["oh"], dif)
    specs = torch.einsum("drm,mc->drc", pre["oh"], spc)
    emis = torch.einsum("drm,mc->drc", pre["oh"], emi)
    e_nee = torch.einsum("drm,mc->drc", pre["em_b"], emi) + pre["pl"]
    a = emis * pre["W"][..., None] + diffs * e_nee
    c = pre["sel1"][..., None] * diffs + pre["sel2"][..., None] * specs + pre["sel3"][..., None]
    # No-advance rows multiply by exactly 1.
    no_adv = (pre["sel1"] + pre["sel2"] + pre["sel3"]) == 0.0
    c = torch.where(no_adv[..., None], 1.0, c)
    s = torch.ones_like(a[0])
    out = torch.zeros_like(a[0])
    for a_v, c_v in zip(a, c):
        out = out + s * a_v
        s = s * c_v
    return out


class _TraceDiff(torch.autograd.Function):
    """Forward: K2 with records; backward: the vjp of `replay_fast` over the
    preprocessed records saved by the forward."""

    @staticmethod
    def forward(ctx, dif, spc, emi, scene_ng, rays, options, seed):
        spectrum, coll, recs = trace_megakernel_diff(scene_ng, rays, options, seed)
        with trace_annotation("diff.preprocess"):
            ctx.pre = preprocess_records(
                recs, em_material_ids(scene_ng), scene_ng.light_spectrum[:, :3],
                scene_ng.num_materials, scene_ng.n_point_lights, scene_ng.emissive_sample_count,
            )
        ctx.save_for_backward(dif, spc, emi)
        ctx.mark_non_differentiable(coll)
        return spectrum, coll

    @staticmethod
    def backward(ctx, g_spec, _g_coll):
        with trace_annotation("diff.backward"):
            leaves = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            with torch.enable_grad():
                rgb = replay_fast(dict(zip(DIFF_FIELDS, leaves)), ctx.pre)
                grads = torch.autograd.grad(rgb, leaves, g_spec[:, :3], allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, leaves)]
            return (*grads, None, None, None, None)


def trace_diff(scene: SceneData, rays, options: RenderOptions, seed):
    """Differentiable trace: (spectrum [R, 4], collected [R]) whose graph
    reaches the scene's mat_diffuse / mat_specular / mat_emission, the
    contract of the wavefront's differentiable=True. The kernel tables are
    packed from detached copies; gradients reach the materials only
    through the replay."""
    mats = [getattr(scene, f) for f in DIFF_FIELDS]
    scene_ng = dataclasses.replace(scene, **{f: m.detach() for f, m in zip(DIFF_FIELDS, mats)})
    return _TraceDiff.apply(*mats, scene_ng, rays, options, seed)
