"""The cluster walk of K1's binned form and K2 on the card, in what the CPU
can check: the shared-memory budget of a block (tables, staged tiers and
each thread's cp.async ring, `kernel_traverse.kernel_smem_bytes`), the
bounds of the warp-step counters (`kernel_traverse.warp_utilisation`) and a
plain model of K1's refilling persistent warps. The kernels themselves run
on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.models import scenes
from tests.torch_util import CPU

# The layout csrc/ builds (binned_geo.cuh ptx_walk_layout: 128 threads,
# 3 slots of 80 bytes, 64 KB of tiers); tests/test_torch_cuda.py holds the
# built libraries to it.
BUILT = kt.WalkLayout(threads=128, depth=3, slot_bytes=80, tier_floats=16384)

_SCENES: dict = {}


def _scene(name):
    """The 200k dragon built lean at 56- or 128-row records, or the box."""
    if name not in _SCENES:
        if name == "box":
            _SCENES[name] = scenes.bench_box_scene(device=CPU)
        else:
            rows = name.removeprefix("dragon")
            old = os.environ.get("PTX_KRN_CLUSTER")
            os.environ["PTX_KRN_CLUSTER"] = rows
            try:
                _SCENES[name] = scenes.bench_dragon_scene(dragon_tris=200000, lean=True,
                                                          device=CPU)
            finally:
                os.environ.pop("PTX_KRN_CLUSTER")
                if old is not None:
                    os.environ["PTX_KRN_CLUSTER"] = old
            assert _SCENES[name].krn_records.shape[1] == int(rows)
    return _SCENES[name]


# ---------------------------------------------------------------------------
# The block's shared memory.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["dragon56", "dragon128", "box"])
def test_main_path_scenes_fit_a_block(name):
    """The 200k dragon at both record heights and the box fit a block at the
    kept ring depth and block size; the dragon's rings are the bulk of it."""
    scene = _scene(name)
    tables = mk.pack_tables(scene)
    smem = mk.block_smem_bytes(scene, tables, BUILT)
    assert 0 < smem <= kt.SMEM_LIMIT
    ring = kt.walk_smem_bytes(BUILT)
    assert ring == 3 * 80 * 128
    if scene.has_kernel_records:
        tiers = kt.tier_floats(scene.krn_sup_bounds.shape[0], BUILT)
        assert tiers > 0  # staged: 9 pages at 56 rows, 4 at 128
        assert ring < smem <= ring + 4 * tiers + 8 * 1024
    else:
        assert smem < 8 * 1024
        assert mk.block_smem_bytes(scene, tables) == smem  # no ring, no layout


@pytest.mark.parametrize("threads,depth,fits", [
    (128, 3, True), (256, 3, True), (256, 4, True), (128, 12, True),
    (256, 12, False), (512, 6, False),
])
def test_ring_budget_against_the_limit(threads, depth, fits):
    """Rings alone of `depth` 80-byte slots at `threads` walks a block fit
    227 KB or raise instead of launching."""
    layout = BUILT._replace(threads=threads, depth=depth)
    assert kt.walk_smem_bytes(layout) == threads * depth * 80
    if fits:
        assert kt.kernel_smem_bytes(0, 0, layout) == threads * depth * 80
    else:
        with pytest.raises(ValueError, match="shared memory"):
            kt.kernel_smem_bytes(0, 0, layout)


def test_block_over_the_limit_raises():
    """Tables too large for any ring, or for a dense block, raise."""
    with pytest.raises(ValueError, match="shared memory"):
        kt.kernel_smem_bytes(kt.SMEM_LIMIT // 4, 9, BUILT)
    with pytest.raises(ValueError, match="shared memory"):
        kt.kernel_smem_bytes(kt.SMEM_LIMIT // 4 + 1)
    assert kt.kernel_smem_bytes(kt.SMEM_LIMIT // 4) == kt.SMEM_LIMIT


def test_ring_starts_on_a_16_byte_boundary():
    """The rings follow the tables and the staged tiers at the next 16-byte
    boundary (binned_geo.cuh ring_offset_floats); dense blocks have none."""
    ring = kt.walk_smem_bytes(BUILT)
    for floats in range(1, 9):
        assert kt.kernel_smem_bytes(floats, 0, BUILT) == -(-floats // 4) * 16 + ring
    pages = 3
    tiers = pages * (kt.BND_COLS + kt.GROUP2 * kt.BND_COLS)
    assert kt.kernel_smem_bytes(5, pages, BUILT) == -(-(5 + tiers) // 4) * 16 + ring
    assert kt.kernel_smem_bytes(5) == 20


def test_tiers_past_64_kb_stay_in_global_memory():
    per_page = kt.BND_COLS + kt.GROUP2 * kt.BND_COLS
    fit = BUILT.tier_floats // per_page
    assert kt.tier_floats(fit, BUILT) == fit * per_page
    assert kt.tier_floats(fit + 1, BUILT) == 0
    assert kt.kernel_smem_bytes(0, fit + 1, BUILT) == kt.walk_smem_bytes(BUILT)


# ---------------------------------------------------------------------------
# The warp-step counters.
# ---------------------------------------------------------------------------


def _visits(slabs, rows):
    """K1 / K2 counters with the given slab tests and filled rows, split
    between the nearest and shadow walks."""
    v = torch.zeros((3, kt.GEO_VISIT_COLS), dtype=torch.int32)
    v[0, kt.NEAR_COLS[2]], v[1, kt.SHADOW_COLS[2]] = slabs - slabs // 3, slabs // 3
    v[2, kt.NEAR_COLS[3]], v[0, kt.SHADOW_COLS[3]] = rows - rows // 4, rows // 4
    v[:, kt.NEAR_COLS[0]] = 7  # other columns do not enter
    return v


@pytest.mark.parametrize("slabs,rows,steps", [
    (3200, 640, (100, 20)),    # every lane busy
    (3200, 640, (3200, 640)),  # one lane a step
    (1000, 0, (40, 0)),        # no filled row tested
    (0, 0, (0, 0)),
])
def test_warp_utilisation_accepts_consistent_counts(slabs, rows, steps):
    u = kt.warp_utilisation(_visits(slabs, rows), torch.tensor(steps))
    assert (u["slab_tests"], u["row_tests"]) == (slabs, rows)
    assert (u["slab_steps"], u["row_steps"]) == steps
    for name, work, n in (("slab", slabs, steps[0]), ("row", rows, steps[1])):
        util = u[f"{name}_lane_utilisation"]
        assert (util is None) if n == 0 else (util == pytest.approx(work / (32 * n))
                                             and 1 / 32 <= util <= 1)


@pytest.mark.parametrize("slabs,rows,steps", [
    (3200, 640, (3201, 20)),  # slab steps > slab tests
    (3200, 640, (100, 641)),  # row steps > rows tested
    (3200, 640, (99, 20)),    # slab tests > 32 x slab steps
    (3200, 640, (100, 19)),   # rows > 32 x row steps
    (3200, 640, (100, 0)),    # rows tested, no row step
])
def test_warp_utilisation_rejects_inconsistent_counts(slabs, rows, steps):
    with pytest.raises(ValueError):
        kt.warp_utilisation(_visits(slabs, rows), torch.tensor(steps))


def test_warp_steps_are_counted_on_the_card_only():
    """The wrappers refuse a warp-step output on the CPU (the twins have no
    warps), and without the counting form."""
    scene = scenes.bench_dragon_scene(dragon_tris=5000, device=CPU)
    assert scene.has_kernel_records
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4)
    opts = RenderOptions(2, 2, 1, 1, max_depth=2)
    steps = torch.zeros(kt.WARP_STEP_COLS, dtype=torch.int64)
    with pytest.raises(ValueError):
        mk.trace_megakernel(scene, Rays(o, d), opts, 1, debug_visits=True, warp_steps=steps)
    with pytest.raises(ValueError):
        mk.trace_megakernel(scene, Rays(o, d), opts, 1, warp_steps=steps)
    st = sw.initial_state(o, d, 1)
    sd = torch.tensor([1, 0], dtype=torch.int32)
    visits = torch.zeros((1, kt.GEO_VISIT_COLS), dtype=torch.int32)
    with pytest.raises(ValueError):
        sw.bounce(scene, st, sd, opts, visits=visits, warp_steps=steps)
    with pytest.raises(ValueError):
        sw.bounce(scene, st, sd, opts, warp_steps=steps)
    with pytest.raises(ValueError):
        sw.trace_megakernel_sorted(scene, Rays(o, d), opts, 1, debug_visits=True,
                                   warp_steps=steps)


# ---------------------------------------------------------------------------
# K1's refilling persistent warps, as a plain model of the kernel's loop
# (csrc/megakernel.cu megakernel_binned): each turn of a warp, the lanes
# without a ray (while the counter may still hold rays) take consecutive
# indices by one atomicAdd, in lane order; then every lane with a ray runs
# one bounce, and its path may end, freeing the lane. The warp stops when
# no lane holds a ray after a refill.
# ---------------------------------------------------------------------------

LANES = 32


def refill_claims(n, warps, seed, end_p=0.3):
    """Every ray index the warps claim, in claim order, and the counter's
    final value; warps take turns and paths end in a seeded order."""
    rng = np.random.default_rng(seed)
    counter = 0
    rays = np.full((warps, LANES), -1, dtype=np.int64)
    more = np.ones(warps, dtype=bool)
    running = list(range(warps))
    claims = []
    while running:
        w = running[rng.integers(len(running))]
        free = np.flatnonzero(rays[w] < 0)
        if more[w] and free.size:
            first = counter
            counter += free.size  # the leader's atomicAdd of popc(want)
            j = first + np.arange(free.size)  # rank = popc(want & lanes below)
            got = j < n
            rays[w, free[got]] = j[got]
            claims.extend(j[got].tolist())
            more[w] = first + free.size < n
        busy = rays[w] >= 0
        if not busy.any():
            running.remove(w)
            continue
        ends = busy & (rng.random(LANES) < end_p)
        rays[w, ends] = -1
    return claims, counter


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("warps", [132, 396])
@pytest.mark.parametrize("n", [32 * 300, 32 * 300 + 19, 19])
def test_refill_claims_every_ray_exactly_once(n, warps, seed):
    """n a multiple of 32, ragged, and smaller than one warp, at 132 warps
    (one a SM) and 396 (three): each index in [0, n) claimed once, nothing
    past n, and the counter overshoots by less than one claim per warp."""
    claims, counter = refill_claims(n, warps, seed)
    assert sorted(claims) == list(range(n))
    assert n <= counter < n + LANES * warps
