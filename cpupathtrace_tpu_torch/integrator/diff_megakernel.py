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
torch.autograd.Function). It is taken in closed form (`replay_vjp`): one
CUDA kernel over K2's planes on the card (csrc/replay_vjp.cu), its plain
twin `replay_vjp_reference` on the CPU. With g the spectrum's gradient,
G_v = g * S_v, E_v = sum_l E_l * w_vl the NEE spectrum, a_v the vertex's
two terms above and, backwards, B_D = 0, B_v = a_v + C_v * B_{v+1}:

    d emission[mid_v]         += G_v * W_v
    d diffuse[mid_v]          += G_v * E_v
    d emission[emitter of l]  += G_v * diffuse[mid_v] * w_vl   (emitter draws)
    d C_v                     += G_v * B_{v+1}                 (diffuse or specular)

The replay reproduces the kernel's sums term by term, so analytic
gradients match finite differences of the forward under common random
numbers up to float32 reassociation (diff/render.py's contract; its
roulette caveat past depth 4 applies unchanged). `replay_spectrum` and
`replay_fast` (the JAX package's replays) stay as the references the
vjp is tested against.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from .. import _build
from ..accel.kernel_traverse import SMEM_LIMIT, check_tensor
from ..core.config import RenderOptions
from ..scene.scene import SceneData
from ..utils.profiling import trace_annotation
from .megakernel import MAX_EM, MAX_LIGHTS, MAX_MAT, kernel_scene, megakernel_supported
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


def record_pass(scene: SceneData, rays, options: RenderOptions, seed, kscene=None):
    """The forward of the gradient path: K2 in its record form once per
    bounce over the unpermuted path state (the twin on the CPU). Returns
    (spectrum [R, 4] with alpha = collected, collected [R] bool, planes
    [max_depth, n_drec, R] f32 as K2 wrote them, depth): the loop stops at
    `depth`, once no ray is alive, and the planes past it are left
    unwritten. `seed`: an int32 Python int or a 1-element tensor.
    `kscene`: the scene's KernelScene on the rays' device (built here when
    None), handed to every bounce."""
    with trace_annotation("diff.record"):
        origin, direction = rays.origin, rays.direction
        dev = origin.device
        scene = scene.to(dev)
        ks = kernel_scene(scene) if kscene is None else kscene
        r = origin.shape[0]
        max_depth = int(options.max_depth)
        n_drec = n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
        st = initial_state(origin, direction, seed)
        planes = torch.empty((max_depth, n_drec, r), dtype=torch.float32, device=dev)
        seed_depth = seed_depth_table(seed, max_depth, dev)
        n_alive = r
        depth = 0
        while depth < max_depth and n_alive > 0:
            trace_megakernel_diff.live_rays += n_alive
            bounce(scene, st, seed_depth[depth], options, ks, records=planes[depth])
            with trace_annotation("diff.live_read"):
                n_alive = int((st[17] > 0.5).sum())  # the one host sync of the bounce
            trace_megakernel_diff.host_reads += 1
            depth += 1
        coll = st[16] > 0.5
        spectrum = torch.stack([st[10], st[11], st[12], coll.float()], dim=-1)
        return spectrum, coll, planes, depth


def trace_megakernel_diff(scene: SceneData, rays, options: RenderOptions, seed, kscene=None):
    """`record_pass` with every depth's records: (spectrum [R, 4],
    collected [R] bool, records [max_depth, R, n_drec] f32, a view of the
    planes). Depths the loop never reaches get the no-contribution encoding
    (mid -1, all weights 0)."""
    spectrum, coll, planes, depth = record_pass(scene, rays, options, seed, kscene)
    if depth < planes.shape[0]:
        with trace_annotation("diff.record"):
            clear_records(planes[depth:].transpose(0, 1))
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


def replay_vjp_reference(planes, g_spec, dif, spc, emi, em_mid, light_spec, n_lights: int,
                         em_k: int):
    """The plain version of the replay vjp (csrc/replay_vjp.cu): the
    gradients of sum(g_spec[:, :3] * replay_spectrum(...)) in the material
    tables [M, C], in closed form, from K2's planes as written [D, n_drec,
    R]. A forward sweep over the depths takes S_v and each term of d a_v, a
    reverse one B_{v+1} and the chain's terms (the module note). Each term
    is the kernel's float32 product in the kernel's order; the terms are
    summed in float64 and rounded once. Columns past 3 get 0. A row with
    mid -1 adds nothing and does not advance. Calls are counted in
    `replay_vjp_reference.calls`."""
    replay_vjp_reference.calls += 1
    tables = (dif, spc, emi)
    n_mat = dif.shape[0]
    dev = planes.device
    d3, s3, e3 = (t.detach()[:, :3] for t in tables)
    g = g_spec[:, :3]
    em_mid = em_mid.long()
    n_em = em_mid.shape[0]
    sums = torch.zeros((3, n_mat, 3), dtype=torch.float64, device=dev)

    def add(field, mask, m, val):
        sums[field].index_add_(0, m[mask], val[mask].double())

    s = torch.ones_like(g)
    stash = []
    for plane in planes:
        mid = plane[0].long()
        hit = mid >= 0
        m = mid.clamp(0, n_mat - 1)
        w = plane[1, :, None]
        sel = plane[2].long()
        big_g = g * s
        d_m = d3[m]
        e = torch.zeros_like(g)
        for li in range(n_lights):
            e = e + light_spec[li][None, :] * plane[3 + li, :, None]
        col = 3 + n_lights
        for _ in range(em_k):
            em = em_mid[plane[col].long().clamp(0, n_em - 1)]
            wk = plane[col + 1, :, None]
            e = e + e3[em] * wk
            add(2, hit, em, (big_g * d_m) * wk)
            col += 2
        add(2, hit, m, big_g * w)
        add(0, hit, m, big_g * e)
        a = torch.where(hit[:, None], e3[m] * w + d_m * e, 0.0)
        kind = torch.where(hit & ((sel == 1) | (sel == 2)), sel, 0)
        c = torch.where((kind == 1)[:, None], d_m,
                        torch.where((kind == 2)[:, None], s3[m], torch.ones_like(d_m)))
        s = torch.where((kind > 0)[:, None], c * s, s)
        stash.append((a, big_g, kind, m, c))
    b = torch.zeros_like(g)
    for a, big_g, kind, m, c in reversed(stash):
        add(0, kind == 1, m, big_g * b)
        add(1, kind == 2, m, big_g * b)
        b = a + c * b
    out = [torch.zeros_like(t) for t in tables]
    for f, o in enumerate(out):
        o[:, :3] = sums[f].to(o.dtype)
    return tuple(out)


replay_vjp_reference.calls = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# Per (device, depth, materials, emitter rows, lights): (threads, dynamic
# shared memory, resident blocks per SM) of the vjp's block.
_VJP_SHAPES: dict = {}


def _vjp_lib():
    lib = _build.load("replay_vjp")
    fn = lib.ptx_replay_vjp_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _I, _I, _LL, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _I, _P, _I, _I,
                       _P, _I, _I, _P, _P, _P, _P]
        fn.restype = ctypes.c_int
        occ = lib.ptx_replay_vjp_occupancy
        occ.argtypes = [_I, _I, _I, _I, _I, ctypes.POINTER(_LL), ctypes.POINTER(_I)]
        occ.restype = ctypes.c_int
    return lib


def vjp_block(depth: int, n_mat: int, n_em: int, n_lights: int):
    """(threads, dynamic shared memory, resident blocks per SM) of the vjp's
    block on the current card: 128 threads, or 64 or 32 where a block of
    128 would hold more than SMEM_LIMIT bytes (its stash is [depth, 7,
    threads] words); ValueError where none fits."""
    key = (torch.cuda.current_device(), depth, n_mat, n_em, n_lights)
    if key not in _VJP_SHAPES:
        occ = _vjp_lib().ptx_replay_vjp_occupancy
        for threads in (128, 64, 32):
            smem, blocks = _LL(0), _I(0)
            err = occ(depth, n_mat, n_em, n_lights, threads, ctypes.byref(smem),
                      ctypes.byref(blocks))
            if smem.value > SMEM_LIMIT:
                continue
            if err or blocks.value < 1:
                raise RuntimeError(f"replay_vjp occupancy query failed: cudaError_t {err}, "
                                   f"{blocks.value} blocks of {threads} threads")
            _VJP_SHAPES[key] = (threads, smem.value, blocks.value)
            break
        else:
            raise ValueError(f"replay_vjp: {depth} depths need more than {SMEM_LIMIT} bytes "
                             "of shared memory in a block of 32 threads")
    return _VJP_SHAPES[key]


def replay_vjp(planes, g_spec, dif, spc, emi, em_mid, light_spec, n_lights: int, em_k: int):
    """The material gradients (d diffuse, d specular, d emission, each the
    shape of its table [M, C], columns past 3 zero) of sum(g_spec[:, :3] *
    replay), from K2's planes as written, [D, n_drec, R] float32. CPU
    tensors take `replay_vjp_reference`; CUDA ones launch the kernel
    (csrc/replay_vjp.cu) and its fold, one call counted in
    `replay_vjp.launches`, or raise: contiguous float32 planes, g_spec [R,
    >= 3], tables [M, >= 3] and light_spec [n_lights, 3], int32 em_mid
    [n_em], all on the planes' card, within the megakernels' limits."""
    dev = planes.device
    n_drec = 3 + n_lights + 2 * em_k
    if planes.dim() != 3 or planes.shape[1] != n_drec or tuple(light_spec.shape) != (n_lights, 3):
        raise ValueError(f"replay_vjp: planes {tuple(planes.shape)} and light_spec "
                         f"{tuple(light_spec.shape)} for {n_lights} lights, {em_k} draws")
    if dev.type == "cpu":
        return replay_vjp_reference(planes, g_spec, dif, spc, emi, em_mid, light_spec,
                                    n_lights, em_k)
    if dev.type != "cuda":
        raise ValueError(f"replay_vjp: no kernel for device {dev}")
    check_tensor("planes", planes, dev, torch.float32, (None, n_drec, None))
    depth, _, r = planes.shape
    check_tensor("g_spec", g_spec, dev, torch.float32, (r, None))
    n_mat = dif.shape[0]
    for name, t in (("dif", dif), ("spc", spc), ("emi", emi)):
        check_tensor(name, t, dev, torch.float32, (n_mat, None))
    check_tensor("em_mid", em_mid, dev, torch.int32, (None,))
    check_tensor("light_spec", light_spec, dev, torch.float32, (n_lights, 3))
    n_em = em_mid.shape[0]
    if g_spec.shape[1] < 3 or min(t.shape[1] for t in (dif, spc, emi)) < 3:
        raise ValueError("replay_vjp: g_spec and the tables need 3 colour columns")
    if not (1 <= n_mat <= MAX_MAT and n_em <= MAX_EM and n_lights <= MAX_LIGHTS) or (
            em_k > 0 and n_em < 1):
        raise ValueError(f"replay_vjp: {n_mat} materials, {n_em} emitter rows, {n_lights} "
                         f"lights, {em_k} emitter draws: outside the kernel's limits")
    outs = [torch.empty_like(t) for t in (dif, spc, emi)]
    if depth == 0 or r == 0:
        return tuple(o.zero_() for o in outs)
    with torch.cuda.device(dev):
        threads, _, per_sm = vjp_block(depth, n_mat, n_em, n_lights)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(-(-r // threads), sms * per_sm))
        partial = torch.empty((grid, 3, n_mat, 3), dtype=torch.float32, device=dev)
        err = _vjp_lib().ptx_replay_vjp_launch(
            planes.data_ptr(), depth, n_drec, r, g_spec.data_ptr(), g_spec.shape[1],
            dif.data_ptr(), spc.data_ptr(), emi.data_ptr(), dif.shape[1], spc.shape[1],
            emi.shape[1], n_mat, em_mid.data_ptr(), n_em, light_spec.data_ptr(), n_lights,
            em_k, partial.data_ptr(), grid, threads, *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"replay_vjp launch failed: cudaError_t {err}")
    replay_vjp.launches += 1
    return tuple(outs)


replay_vjp.launches = 0


class _TraceDiff(torch.autograd.Function):
    """Forward: K2 with records (`record_pass`); backward: the replay's vjp
    (`replay_vjp`) over the planes K2 wrote, saved by the forward."""

    @staticmethod
    def forward(ctx, dif, spc, emi, scene_ng, rays, options, seed):
        spectrum, coll, planes, depth = record_pass(scene_ng, rays, options, seed)
        with trace_annotation("diff.preprocess"):
            em_mid = em_material_ids(scene_ng).to(torch.int32)
            light_spec = scene_ng.light_spectrum[:scene_ng.n_point_lights, :3].contiguous()
        ctx.n_lights = scene_ng.n_point_lights
        ctx.em_k = scene_ng.emissive_sample_count
        # The depths the loop reached (still contiguous): those past it add
        # nothing to the replay.
        ctx.save_for_backward(dif, spc, emi, planes[:depth], em_mid, light_spec)
        ctx.mark_non_differentiable(coll)
        return spectrum, coll

    @staticmethod
    def backward(ctx, g_spec, _g_coll):
        with trace_annotation("diff.backward"):
            dif, spc, emi, planes, em_mid, light_spec = ctx.saved_tensors
            grads = replay_vjp(planes, g_spec.contiguous(),
                               *(t.detach().contiguous() for t in (dif, spc, emi)),
                               em_mid, light_spec, ctx.n_lights, ctx.em_k)
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
