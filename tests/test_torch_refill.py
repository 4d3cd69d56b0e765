"""The host side of K1's dense form on refilling persistent warps and of K2's
record form without a separate fill, in what the CPU can check: the
resident grid of a launch (`megakernel.resident_grid`) and the block's
shared-memory limit, the lane use of the dense counting instance
(`megakernel.lane_use`) and its prediction for one path per thread from
live counts per bounce (`megakernel.predicted_lane_use`, against a
simulation of warps), the no-contribution encoding of the twin's record
planes that K2 now writes itself into a dead ray's column, and the
gradient forward's record planes of the depths its loop never reaches.
The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import diff_megakernel as dm
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.models import scenes
from tests.torch_util import CPU, make_rays

H100_SMS = 132


# ---------------------------------------------------------------------------
# The resident grid and the block's shared memory.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,threads,per_sm,grid",
    [
        (1, 256, 3, 1),  # one ray: one block
        (31, 256, 3, 1),
        (257, 256, 3, 2),  # a ragged count: one thread per ray at most
        (H100_SMS * 3 * 256, 256, 3, H100_SMS * 3),  # exactly one resident wave
        (H100_SMS * 3 * 256 + 1, 256, 3, H100_SMS * 3),  # past it: the warps refill
        (4_194_304, 256, 3, H100_SMS * 3),  # the box frame
        (4_194_304, 128, 6, H100_SMS * 6),
    ],
)
def test_resident_grid_is_the_resident_blocks_at_most_one_thread_per_ray(n, threads, per_sm,
                                                                        grid):
    assert mk.resident_grid(n, threads, per_sm, H100_SMS) == grid


def test_resident_grid_refuses_an_instance_that_fits_no_sm():
    with pytest.raises(ValueError, match="fits an SM"):
        mk.resident_grid(4096, 256, 0, H100_SMS)


def test_dense_block_past_the_shared_memory_limit_is_refused():
    """The box's tables fit a dense block; a sphere table of 8,000 rows
    (256 KB) does not, and the size is refused before any launch."""
    box = scenes.bench_box_scene(device=CPU)
    ks = mk.kernel_scene(box)
    assert 0 < ks.smem_bytes() < 16 * 1024
    tri, sph, mat, lgt, em = ks.tables
    big = torch.zeros((8000, sph.shape[1]))
    with pytest.raises(ValueError, match="shared memory"):
        mk.KernelScene(box, (tri, big, mat, lgt, em)).smem_bytes()


# ---------------------------------------------------------------------------
# Lane use: the counting instance's bounds and the one-path-per-thread
# prediction.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps,bounces,use", [(10, 10, 1 / 32), (10, 320, 1.0), (4, 96, 0.75)])
def test_lane_use_within_bounds(steps, bounces, use):
    assert mk.lane_use(torch.tensor([steps, bounces])) == pytest.approx(use)


@pytest.mark.parametrize("steps,bounces", [(0, 0), (10, 9), (10, 321), (0, 5)])
def test_lane_use_refuses_counts_out_of_bounds(steps, bounces):
    with pytest.raises(ValueError, match="ray-bounces"):
        mk.lane_use(torch.tensor([steps, bounces]))


def test_predicted_lane_use_of_equal_paths_is_one():
    assert mk.predicted_lane_use([100, 100, 100]) == pytest.approx(1.0)


def test_predicted_lane_use_matches_a_simulation_of_warps():
    """Paths whose lengths are drawn independently, 32 to a warp: the
    simulated ray-bounces / (32 x the warps' longest paths) against the
    prediction from the live counts of the same paths, within 1%."""
    rng = np.random.default_rng(0)
    # The box's shape of lengths: 3 bounces always, then roulette.
    lengths = 3 + rng.geometric(0.55, size=32 * 20000) - 1
    warps = lengths.reshape(-1, 32)
    simulated = warps.sum() / (32 * warps.max(1).sum())
    live = [int((lengths > d).sum()) for d in range(int(lengths.max()))]
    assert mk.predicted_lane_use(live) == pytest.approx(simulated, rel=0.01)
    assert simulated < 0.8


def test_predicted_lane_use_of_the_box_from_the_twin_live_counts():
    """The twin's live counts per bounce of the box at 32x32 @ 1 spp give a
    prediction below one (paths end at different depths) and above the
    share of the longest path a lane waits for."""
    scene = scenes.bench_box_scene(device=CPU)
    opts = RenderOptions(32, 32, 1, 1, epsilon=1e-3, max_depth=40)
    o, d = make_rays("sphere_dirs", 1024)
    st = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), 3)
    live = []
    for depth in range(40):
        n = int((st[17] > 0.5).sum())
        if n == 0:
            break
        live.append(n)
        sw.bounce_reference(scene, st, depth, opts)
    use = mk.predicted_lane_use(live)
    assert sum(live) / (len(live) * live[0]) < use < 1.0


@pytest.mark.parametrize("live", [[], [0, 0], [10, 12], [10, -1]])
def test_predicted_lane_use_refuses_bad_live_counts(live):
    with pytest.raises(ValueError, match="live counts"):
        mk.predicted_lane_use(live)


def test_bounce_steps_are_a_card_count_of_dense_scenes():
    scene = scenes.bench_box_scene(device=CPU)
    o, d = make_rays("sphere_dirs", 64)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    with pytest.raises(ValueError, match="on the card"):
        mk.trace_megakernel(scene, rays, RenderOptions(8, 8, 1, 1), 1,
                            bounce_steps=torch.zeros(2, dtype=torch.int64))


# ---------------------------------------------------------------------------
# Record planes: the encoding K2 writes into a dead ray's column.
# ---------------------------------------------------------------------------


def _box_state(n, dead_share, seed):
    o, d = make_rays("sphere_dirs", n, seed)
    st = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), seed)
    dead = torch.from_numpy(np.random.default_rng(seed).random(n) < dead_share)
    st[17, dead] = 0.0
    return st, dead


@pytest.mark.parametrize("depth", [0, 5])
def test_twin_records_of_dead_rays_are_the_no_contribution_encoding(depth):
    """NaN-filled record planes through the twin (and through `bounce` on
    CPU state, which takes the twin): a ray dead on entry gets mid -1 and
    zeros, the encoding `clear_records` writes and csrc/bounce.cu writes
    into its column; every live ray's planes are written too."""
    scene = scenes.bench_box_scene(device=CPU)
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    st, dead = _box_state(512, 0.3, 11 + depth)
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    encoding = torch.empty((nd, 1))
    sw.clear_records(encoding)
    assert encoding[0, 0] == -1 and (encoding[1:] == 0).all()
    for run in (sw.bounce_reference, sw.bounce):
        rec = torch.full((nd, st.shape[1]), float("nan"))
        s = st.clone()
        if run is sw.bounce:
            run(scene, s, torch.tensor([3, depth], dtype=torch.int32), opts, records=rec)
        else:
            run(scene, s, depth, opts, records=rec)
        assert not bool(torch.isnan(rec).any())
        assert torch.equal(rec[:, dead], encoding.expand(nd, int(dead.sum())))
        assert torch.equal(s[:, dead].view(torch.int32), st[:, dead].view(torch.int32))


def test_gradient_forward_clears_the_depths_its_loop_never_reaches():
    """trace_megakernel_diff's records [max_depth, R, n_drec]: each bounce
    writes its depth whole, and the depths after the last live bounce hold
    the no-contribution encoding (they are cleared after the loop)."""
    scene = scenes.bench_box_scene(device=CPU)
    o, d = make_rays("sphere_dirs", 256, 4)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    _, _, recs = dm.trace_megakernel_diff(scene, rays, opts, 7)
    assert not bool(torch.isnan(recs).any())
    unreached = (recs[..., 0] == -1).all(1)
    assert bool(unreached[-1]) and not bool(unreached[0])
    first = int(unreached.float().argmax())
    assert bool(unreached[first:].all())
    assert (recs[first:, :, 1:] == 0).all()


def test_gradient_forward_fills_no_depth_when_every_depth_is_reached():
    """At max_depth 2 every ray of the box lives through both bounces: the
    loop reaches every depth, and no depth is left at the encoding."""
    scene = scenes.bench_box_scene(device=CPU)
    o, d = make_rays("sphere_dirs", 128, 5)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=2)
    _, _, recs = dm.trace_megakernel_diff(scene, rays, opts, 7)
    assert not bool(torch.isnan(recs).any())
    assert not bool((recs[..., 0] == -1).all(1).any())
