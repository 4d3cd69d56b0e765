"""The sorted-wavefront driver and its bounce kernel (K2).

Port of `cpupathtrace_tpu/integrator/sorted_wavefront.py`: the film's
default for binned scenes, and for every megakernel scene with
PTX_SORTED_WAVEFRONT=1. Each bounce runs the single-bounce kernel over the
whole path state, then re-sorts the rays by a coherence key (dead rays
last; then the Morton cell of where each ray enters the cluster set's root
box, then its direction octant), so that neighbouring threads walk the
same part of the cluster tree (a dense scene's root box is empty, +inf /
-inf, and its rays sort by octant alone):

    while depth < max_depth and any ray alive:
        state <- K2(state, depth)                    one bounce
        state <- state[:, argsort(_sort_key(state))] one sort, one gather

The path state is one [18, R] float32 tensor of the STATE_FIELDS planes
(the rng state rides bit-cast as int32). Each ray's random stream is seeded
from its ORIGINAL index (`_seed_rng_flat`) and rides its state, and no
thread's work depends on its neighbours, so a sorted run equals an
unsorted one ray for ray. At the end the sums are scattered back by the
original index.

K2 (`bounce`) is csrc/bounce.cu for CUDA state: the per-bounce body of the
megakernel (csrc/bounce_body.cuh, shared with K1) with the cluster
traversal K3 (csrc/cluster_traverse.cuh) inline, or with K1's dense
geometry for a dense scene. Its plain version (`bounce_reference`) runs the
twin's bounce (integrator/megakernel.py `_bounce`) over the live rays. With
`records`, both also write the differentiable replay's record planes
(integrator/diff_megakernel.py); with `visits`, the traversal counters
(debug_visits: per-ray counts summed per 1024 state positions, see
integrator/megakernel.py), and on the card with `warp_steps` the walks'
warp steps. The alive count is read on the host once per
bounce, for the loop test and the sort threshold together.

Not ported: the TPU's sort glue variants (PTX_SORT_GLUE).
"""
from __future__ import annotations

import ctypes
import os

import torch

from .. import _build
from ..accel.kernel_traverse import (
    GEO_VISIT_COLS,
    VISIT_BLOCK,
    WARP_STEP_COLS,
    block_sums,
    check_tensor,
    walk_layout,
)
from ..core.config import RenderOptions
from ..scene.scene import SceneData
from ..utils.profiling import trace_annotation
from .megakernel import (
    SceneArgs,
    _bounce,
    _Ctx,
    ablation_mask,
    check_warp_steps,
    kernel_scene,
    megakernel_supported,
)
from .rng import MASK32, fmix32, mul32

STATE_FIELDS = (
    "rng", "ox", "oy", "oz", "dx", "dy", "dz",
    "sr", "sg", "sb", "out_r", "out_g", "out_b",
    "divisor", "bounce_pd", "contrib_unw", "collected_f", "alive_f",
)
N_STATE = len(STATE_FIELDS)
# The twin's dict keys for the planes 1..15 (its `contrib` is contrib_unw).
_TWIN_KEYS = ("ox", "oy", "oz", "dx", "dy", "dz", "sr", "sg", "sb",
              "out_r", "out_g", "out_b", "divisor", "bounce_pd", "contrib")

# Both read at import, as sorted_wavefront.py:64 and :74 read them.
# Entry-point Morton resolution (bits per axis): 3*bits + 3-bit octant key,
# at most 8 so the miss key (1 << (3*bits + 3)) stays below the dead key.
_MORTON_BITS = min(8, max(1, int(os.environ.get("PTX_SORT_MORTON_BITS", "4"))))
# Skip the re-sort once fewer rays than min(this, rays // 4) are alive:
# the live rays are already packed at the head (a dead ray's key is
# terminal), so late sparse bounces gain no coherence from a sort.
_SORT_MIN_ALIVE = int(os.environ.get("PTX_SORT_MIN_ALIVE", str(1 << 16)))
_DEAD_KEY = 2 ** 30


def _seed_rng_flat(seed, idx: torch.Tensor) -> torch.Tensor:
    """Per-ray xorshift32 state from the ORIGINAL ray index (int64 in
    [0, 2^32) values), bit-exact with the JAX function. `seed` is an int32
    Python int or a 1-element tensor."""
    if isinstance(seed, torch.Tensor):
        seed = seed.reshape(-1)[:1].to(device=idx.device, dtype=torch.int64)
    idx = idx & MASK32
    s = (
        mul32(seed & MASK32, 2654435761)
        ^ ((mul32(idx, 40503) + 0x9E3779B9) & MASK32)
        ^ ((mul32(idx >> 7, 2246822519) + 0x85EBCA6B) & MASK32)
    )
    return fmix32(s)


def _rng_to_plane(rng: torch.Tensor) -> torch.Tensor:
    """int64 states in [0, 2^32) -> their bits as a float32 plane."""
    return torch.where(rng >= 2 ** 31, rng - 2 ** 32, rng).to(torch.int32).view(torch.float32)


def _plane_to_rng(plane: torch.Tensor) -> torch.Tensor:
    return plane.view(torch.int32).to(torch.int64) & MASK32


def _sort_key(ox, oy, oz, dx, dy, dz, alive_f, lo, hi):
    """int32 coherence key (sorted_wavefront.py:185-242): dead rays last
    (2^30); rays that miss the root box after all entering ones; entering
    rays by the Morton cell of their entry point (_MORTON_BITS per axis), then
    direction octant. `lo`, `hi`: the root box, [3] tensors."""
    i32 = torch.int32
    octant = (dx < 0).to(i32) + 2 * (dy < 0).to(i32) + 4 * (dz < 0).to(i32)
    eps = 1e-30

    def inv(d):
        return torch.reciprocal(torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps), d))

    ixd, iyd, izd = inv(dx), inv(dy), inv(dz)
    t1x, t2x = (lo[0] - ox) * ixd, (hi[0] - ox) * ixd
    t1y, t2y = (lo[1] - oy) * iyd, (hi[1] - oy) * iyd
    t1z, t2z = (lo[2] - oz) * izd, (hi[2] - oz) * izd
    tmin = torch.maximum(
        torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
        torch.minimum(t1z, t2z),
    )
    tmax = torch.minimum(
        torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
        torch.maximum(t1z, t2z),
    )
    enters = (tmax >= 0.0) & (tmin <= tmax)
    te = tmin.clamp_min(0.0)
    px = ox + dx * te
    py = oy + dy * te
    pz = oz + dz * te
    ext = (hi - lo).clamp_min(1e-30)
    scale = float(1 << _MORTON_BITS) * 0.9999
    ix = (((px - lo[0]) / ext[0]).clamp(0.0, 0.9999) * scale).to(i32)
    iy = (((py - lo[1]) / ext[1]).clamp(0.0, 0.9999) * scale).to(i32)
    iz = (((pz - lo[2]) / ext[2]).clamp(0.0, 0.9999) * scale).to(i32)
    m = torch.zeros_like(ix)
    for b in range(_MORTON_BITS):
        m = m | (((ix >> b) & 1) << (3 * b + 2))
        m = m | (((iy >> b) & 1) << (3 * b + 1))
        m = m | (((iz >> b) & 1) << (3 * b))
    key = torch.where(enters, (m << 3) | octant, (1 << (3 * _MORTON_BITS + 3)) | octant)
    return torch.where(alive_f > 0.5, key, torch.full_like(key, _DEAD_KEY))


def seed_depth_table(seed, max_depth: int, device) -> torch.Tensor:
    """[max_depth, 2] int32 on `device`: row d holds (seed, d), so K2
    reads its depth on the device and the host hands it over without a
    sync. `seed`: an int32 Python int or a 1-element tensor."""
    table = torch.zeros((max(max_depth, 1), 2), dtype=torch.int32, device=device)
    table[:, 1] = torch.arange(table.shape[0], dtype=torch.int32, device=device)
    table[:, 0] = (seed.reshape(-1)[:1].to(device=device, dtype=torch.int32)
                   if isinstance(seed, torch.Tensor) else int(seed))
    return table


def initial_state(origin, direction, seed) -> torch.Tensor:
    """The [18, R] path state of fresh rays: rng from the ray index, unit
    throughput, zero sums, all alive."""
    r = origin.shape[0]
    dev = origin.device
    st = torch.zeros((N_STATE, r), dtype=torch.float32, device=dev)
    st[0] = _rng_to_plane(_seed_rng_flat(seed, torch.arange(r, device=dev)))
    st[1:4] = origin.t()
    st[4:7] = direction.t()
    st[7:10] = 1.0
    st[13:16] = 1.0
    st[17] = 1.0
    return st


# ---------------------------------------------------------------------------
# K2: one bounce, and its plain version.
# ---------------------------------------------------------------------------


def n_diff_records(n_lights: int, em_k: int) -> int:
    """Record planes per bounce (pallas_megakernel.py:337): mid, W, sel,
    one weight per point light, (CDF row, weight) per emitter draw."""
    return 3 + n_lights + 2 * em_k


def clear_records(records: torch.Tensor) -> None:
    """The replay's no-contribution encoding: mid = -1, all else 0. The
    twin clears its records with it; K2 writes it into the columns of the
    rays dead on entry itself (csrc/bounce_body.cuh Records)."""
    records[0] = -1.0
    records[1:] = 0.0


def bounce_reference(scene: SceneData, state: torch.Tensor, depth: int, options,
                     kscene=None, ctx=None, records=None, visits=None) -> None:
    """One bounce over `state` [18, R] in place: the twin's body for the
    rays alive on entry; dead rays are left as they are (the kernel's
    threads of dead rays return at once). The twin reads its tables from
    `ctx`, else from `kscene` (the scene's KernelScene), else from one
    built here. `records` [n_drec, R]: cleared, then the live rays' record
    planes are written. `visits` [ceil(R / 1024), 9] int32: the live rays'
    traversal counts are added to the rows of their state positions."""
    bounce_reference.calls += 1
    if ctx is None:
        ks = kernel_scene(scene) if kscene is None else kscene
        ctx = _Ctx(scene, ks.tables, options, state.device)
    if records is not None:
        clear_records(records)
    idx = (state[17] > 0.5).nonzero(as_tuple=True)[0]
    if idx.numel() == 0:
        return
    live = state[:, idx]
    s = {k: live[i + 1] for i, k in enumerate(_TWIN_KEYS)}
    s["rng"] = _plane_to_rng(live[0])
    s["collected"] = live[16] > 0.5
    if visits is not None:
        s["vis"] = torch.zeros((idx.numel(), GEO_VISIT_COLS), dtype=torch.int64,
                               device=state.device)
    rec = [] if records is not None else None
    alive = _bounce(ctx, depth, s, rec)
    if visits is not None:
        per_ray = torch.zeros((state.shape[1], GEO_VISIT_COLS), dtype=torch.int64,
                              device=state.device)
        per_ray[idx] = s["vis"]
        visits += block_sums(per_ray)
    out = torch.stack(
        [_rng_to_plane(s["rng"])] + [s[k] for k in _TWIN_KEYS]
        + [s["collected"].float(), alive.float()]
    )
    state[:, idx] = out
    if rec is not None:
        records[:, idx] = torch.stack(rec)


bounce_reference.calls = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _bounce_fn():
    lib = _build.load("bounce")
    fn = lib.ptx_bounce_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.POINTER(SceneArgs), _P, _I, _P, _P]  # scene, state, depth, planes
                       + [_P, _P, ctypes.c_float, ctypes.c_longlong]  # visits, steps, eps, smem
                       + [_I, _P])  # ablation mask, stream
        fn.restype = ctypes.c_int
    return fn


def bounce(scene: SceneData, state: torch.Tensor, seed_depth: torch.Tensor, options,
           kscene=None, records=None, visits=None, warp_steps=None) -> None:
    """One bounce over `state` [18, R] in place. `seed_depth` is a [2]
    int32 tensor (seed, depth) on the state's device: the kernel reads the
    depth there, so the host need not sync to hand it over. `kscene`: the
    scene's KernelScene on the state's device, built once a trace by its
    driver (here when None). `records` ([n_diff_records, R] f32, or None)
    selects K2's record form; every column is written (a ray dead on entry
    gets the no-contribution encoding of `clear_records`), so it may come
    uninitialised. `visits` ([ceil(R / 1024), 9] int32, or None) selects
    the counting form: the traversal counts are added to it (binned scenes,
    not with records), and `warp_steps` ([3] int64, zeroed by the caller,
    on the card) gets the walks' warp steps
    (kernel_traverse.warp_utilisation). CPU state runs `bounce_reference`;
    CUDA state launches csrc/bounce.cu, with the cluster traversal for a
    binned scene and K1's dense geometry otherwise, and its ablation
    instances while a switch is set (megakernel.ablation_mask, read at the
    call). The record form has none and raises ValueError then (the JAX
    kernel asserts, pallas_megakernel.py:885; under PTX_SKIP_TRAVERSE alone
    JAX records without the walks)."""
    dev = state.device
    binned = scene.has_kernel_records
    ablate = ablation_mask(binned)
    if records is not None and ablate:
        raise ValueError("bounce: the record form runs no ablation (PTX_ABLATE / "
                         "PTX_SKIP_TRAVERSE are set)")
    if warp_steps is not None:
        if visits is None:
            raise ValueError("bounce: warp_steps count with visits")
        check_warp_steps(warp_steps, dev)
    if dev.type == "cpu":
        return bounce_reference(scene, state, int(seed_depth[1]), options, kscene,
                                records=records, visits=visits)
    if dev.type != "cuda":
        raise ValueError(f"bounce: no kernel for device {dev}")
    if not megakernel_supported(scene):
        raise ValueError("bounce: the scene exceeds the kernel's limits (megakernel_supported)")
    check_tensor("state", state, dev, torch.float32, (N_STATE, None))
    check_tensor("seed_depth", seed_depth, dev, torch.int32, (2,))
    n = state.shape[1]
    ks = kernel_scene(scene.to(dev)) if kscene is None else kscene
    ks.check_device(dev)
    rec_ptr = None
    if records is not None:
        n_drec = n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
        check_tensor("records", records, dev, torch.float32, (n_drec, n))
        rec_ptr = records.data_ptr()
    vis_ptr = None
    if visits is not None:
        if not binned or records is not None:
            raise ValueError("bounce: visits count binned scenes without records only")
        check_tensor("visits", visits, dev, torch.int32, (-(-n // VISIT_BLOCK), GEO_VISIT_COLS))
        vis_ptr = visits.data_ptr()
        if warp_steps is None:
            warp_steps = torch.zeros(WARP_STEP_COLS, dtype=torch.int64, device=dev)
    smem = ks.smem_bytes(walk_layout("bounce") if binned else None)
    if n:
        with torch.cuda.device(dev):
            err = _bounce_fn()(
                ctypes.byref(ks.args), state.data_ptr(), n, seed_depth.data_ptr(), rec_ptr,
                vis_ptr, None if vis_ptr is None else warp_steps.data_ptr(),
                float(options.epsilon), smem, ablate, torch.cuda.current_stream(dev).cuda_stream,
            )
        if err:
            raise RuntimeError(f"bounce launch failed: cudaError_t {err}")
        bounce.launches += 1
        if records is not None:
            bounce.record_launches += 1


bounce.launches = 0
bounce.record_launches = 0


def bounce_occupancy(smem_bytes, binned=True, cull=-1, rec=False, count=False, ablate=False):
    """(resident blocks per SM, threads per block) of K2's instance
    (geometry, cull class, record form, counting form, ablation instance)
    at `smem_bytes` of dynamic shared memory, by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor on the current card."""
    fn = _build.load("bounce").ptx_bounce_occupancy
    if fn.argtypes is None:
        fn.argtypes = [_I, _I, _I, _I, _I, ctypes.c_longlong, ctypes.POINTER(_I),
                       ctypes.POINTER(_I)]
        fn.restype = ctypes.c_int
    blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
    err = fn(int(bool(binned)), int(cull), int(bool(rec)), int(bool(count)), int(bool(ablate)),
             int(smem_bytes), ctypes.byref(blocks), ctypes.byref(threads))
    if err:
        raise RuntimeError(f"bounce occupancy query failed: cudaError_t {err}")
    return blocks.value, threads.value


# ---------------------------------------------------------------------------
# The driver.
# ---------------------------------------------------------------------------


def trace_megakernel_sorted(scene: SceneData, rays, options: RenderOptions, seed,
                            kscene=None, sort: bool = True, timing: dict | None = None,
                            reference: bool = False, debug_visits: bool = False,
                            warp_steps=None):
    """Full-path trace of a ray batch with per-bounce coherence sorting.
    Returns (spectrum [R,4] with alpha = collected, collected [R] bool),
    as trace_megakernel, and with `debug_visits` the per-bounce traversal
    counters [max_depth, ceil(R / 1024), 9] int32 (JAX
    sorted_wavefront.py:486-489; rows are blocks of state positions, zero
    for a dense scene). `seed` is an int32 Python int or a 1-element
    tensor. `kscene`: the scene's KernelScene on the rays' device (built
    here when None), handed to every bounce. `sort=False` skips the
    permutation; the result is the same ray for ray. Each bounce runs
    `bounce` (the kernel for CUDA rays, the twin for CPU rays), or with
    `reference` the twin on any device. A `timing`
    dict (CUDA only) gets the milliseconds of each bounce's kernel
    ("bounce_ms") and of its sort + gather ("sort_ms"), by CUDA events.
    `warp_steps` ([3] int64, zeroed, on the card; binned, with
    `debug_visits`): the warp steps of every bounce are added to it. The
    driver reads the host
    once per bounce (counted in `trace_megakernel_sorted.host_reads`; the
    rays entering each bounce in `trace_megakernel_sorted.live_rays`)."""
    with trace_annotation("sorted.trace"):
        origin, direction = rays.origin, rays.direction
        dev = origin.device
        scene = scene.to(dev)
        if not megakernel_supported(scene):
            raise ValueError("trace_megakernel_sorted: the scene exceeds the kernels' limits "
                             "(megakernel_supported)")
        binned = scene.has_kernel_records
        ks = kernel_scene(scene) if kscene is None else kscene
        ctx = _Ctx(scene, ks.tables, options, dev) if reference or dev.type == "cpu" else None
        if warp_steps is not None and (not (debug_visits and binned) or ctx is not None):
            raise ValueError("trace_megakernel_sorted: warp_steps count the kernel's binned "
                             "bounces with debug_visits")
        r = origin.shape[0]
        st = initial_state(origin, direction, seed)
        idx = torch.arange(r, device=dev)
        max_depth = int(options.max_depth)
        seed_depth = seed_depth_table(seed, max_depth, dev)
        threshold = min(_SORT_MIN_ALIVE, max(r // 4, 1))
        vis = (torch.zeros((max_depth, -(-r // VISIT_BLOCK), GEO_VISIT_COLS), dtype=torch.int32,
                           device=dev)
               if debug_visits else None)
        # A dense scene has nothing to count: its bounces run the plain form.
        count = vis is not None and binned
        if timing is not None:
            timing.update(bounce_ms=[], sort_ms=[])
        n_alive = r
        depth = 0
        while depth < max_depth and n_alive > 0:
            if timing is not None:
                e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                e[0].record()
            v = vis[depth] if count else None
            trace_megakernel_sorted.live_rays += n_alive
            with trace_annotation("sorted.bounce"):
                if ctx is not None:
                    bounce_reference(scene, st, depth, options, ctx=ctx, visits=v)
                else:
                    bounce(scene, st, seed_depth[depth], options, ks, visits=v,
                           warp_steps=warp_steps if count else None)
            if timing is not None:
                e[1].record()
            # The one host sync of the bounce: loop test and sort threshold.
            with trace_annotation("sorted.live_read"):
                alive = st[17] > 0.5
                n_alive = int(alive.sum())
            trace_megakernel_sorted.host_reads += 1
            if sort and n_alive >= threshold:
                with trace_annotation("sorted.sort"):
                    key = _sort_key(st[1], st[2], st[3], st[4], st[5], st[6], st[17],
                                    scene.root_lo, scene.root_hi)
                    order = torch.argsort(key, stable=True)
                    st = st[:, order]
                    idx = idx[order]
            if timing is not None:
                e[2].record()
                e[2].synchronize()
                timing["bounce_ms"].append(e[0].elapsed_time(e[1]))
                timing["sort_ms"].append(e[1].elapsed_time(e[2]))
            depth += 1
        # Un-permute: scatter each ray's sums back to its original index.
        with trace_annotation("sorted.unpermute"):
            out = torch.empty((4, r), dtype=torch.float32, device=dev)
            out[:, idx] = st[[10, 11, 12, 16]]
            coll = out[3] > 0.5
            spectrum = torch.stack([out[0], out[1], out[2], coll.float()], dim=-1)
        return (spectrum, coll, vis) if debug_visits else (spectrum, coll)


# Per-process totals: host reads (one a bounce), rays entering each bounce.
trace_megakernel_sorted.host_reads = 0
trace_megakernel_sorted.live_rays = 0
