"""The sorted-wavefront driver
(cpupathtrace_tpu_torch/integrator/sorted_wavefront.py), on binned scenes
and on the box (a dense scene, PTX_SORTED_WAVEFRONT=1), and the binned
routing of the film, on the CPU, where the bounce kernel K2 is replaced by
its plain version (the twin's bounce).

The JAX side (`_bounce_call` and `trace_megakernel_sorted` in Pallas
interpret mode) is committed in tests/fixtures/torch_sorted.npz
(make_torch_sorted_fixtures.py): four single bounces from the fresh state
of 1024 rays into the 1200-triangle dragon, and the whole trace at
max_depth 4. Bounds (measured values in the comments):

  * one bounce from the JAX state, per plane: the rng plane bit-equal on
    the rays alive on entry (the JAX kernel also steps the streams of dead
    lanes in live blocks; they never reach an output), the throughput,
    roulette pdf, collected and alive planes bit-equal; origin, direction,
    divisor and contrib within rtol 1e-5 / atol 1e-6 on >= 99.9% of rays
    (1.000); the radiance sums on >= 98% (0.984-0.999). The gap is the
    emitter-NEE coin flip of tests/test_torch_megakernel.py: XLA:CPU fuses
    products into FMAs and the twin does not, and the emitter shadow ray
    ends exactly on the emitter, so its last bit decides the flip.
  * the whole trace: collected equal on every ray, the mean radiance within
    0.5% (0.06%), the spectrum within rtol 1e-5 / atol 1e-7 on >= 95% of
    rays (0.952, see BOUNDS_TRACE).
  * the box through the driver against JAX trace_megakernel_sorted
    (tests/fixtures/torch_mega_binned.npz, make_torch_mega_binned_fixtures.py):
    the bounds of tests/test_torch_megakernel.py's "box" case.
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import film
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from tests.torch_util import (
    CPU,
    SORTED_BOX_SEED,
    SORTED_DEPTH,
    SORTED_RAYS,
    SORTED_SEED,
    build_scene,
    dragon_scene,
    jax_bounce_states,
    jax_sorted_box_trace,
    jax_sorted_trace,
    make_rays,
    sorted_rays,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_sorted.npz")
FIXTURE_BOX = os.path.join(os.path.dirname(__file__), "fixtures", "torch_mega_binned.npz")
# The box against JAX: tests/test_torch_megakernel.py's "box" bounds (the
# emitter-NEE coin flip of XLA:CPU's FMAs), (rtol, atol, frac).
BOUNDS_BOX = (1e-3, 1e-5, 0.95)
OPTS = RenderOptions(8, 8, 1, 1, max_depth=SORTED_DEPTH)
EXACT_PLANES = ("sr", "sg", "sb", "bounce_pd", "collected_f", "alive_f")
CLOSE_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "divisor", "contrib_unw")
OUT_PLANES = ("out_r", "out_g", "out_b")
# (rtol, atol, frac) of the whole trace against JAX. Measured: 0.850 of the
# rays bit-equal, 0.952 close, at these tolerances and equally at rtol 1e-3
# / atol 1e-5: the rays that differ took the other side of an emitter-NEE
# flip (a whole shadow-ray contribution), not a rounding.
BOUNDS_TRACE = (1e-5, 1e-7, 0.95)


@pytest.fixture(scope="module")
def fixture():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def scene():
    return dragon_scene("port")


def _rays():
    o, d = sorted_rays()
    return Rays(torch.from_numpy(o), torch.from_numpy(d))


def test_seed_rng_flat_bit_equal_to_jax():
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.sorted_wavefront import _seed_rng_flat

    idx = np.arange(0, 1 << 22, 37, dtype=np.int64)
    for seed in (0, 1234, 2 ** 31 - 1, -5):
        ref = np.asarray(_seed_rng_flat(jnp.int32(seed), jnp.asarray(idx.astype(np.int32))))
        ours = sw._seed_rng_flat(seed, torch.from_numpy(idx)).numpy()
        np.testing.assert_array_equal(ours, ref.astype(np.int64))
    # A device seed tensor gives the same streams as the Python int.
    t = sw._seed_rng_flat(torch.tensor([1234], dtype=torch.int32), torch.from_numpy(idx))
    np.testing.assert_array_equal(t.numpy(), sw._seed_rng_flat(1234, torch.from_numpy(idx)).numpy())


def test_initial_state_matches_jax_fresh_state(fixture):
    o, d = sorted_rays()
    st = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), SORTED_SEED).numpy()
    np.testing.assert_array_equal(st.view(np.int32), fixture["bounce_states"][0].view(np.int32))


@pytest.mark.parametrize("k", range(SORTED_DEPTH + 1))
def test_sort_key_matches_jax(k, fixture, scene):
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.sorted_wavefront import _sort_key

    st = fixture["bounce_states"][k]
    lo, hi = scene.root_lo.numpy(), scene.root_hi.numpy()
    ref = np.asarray(_sort_key(*[jnp.asarray(st[i]) for i in range(1, 7)], jnp.asarray(st[17]),
                               jnp.asarray(lo), jnp.asarray(hi)))
    ours = sw._sort_key(*[torch.from_numpy(st[i].copy()) for i in range(1, 7)],
                        torch.from_numpy(st[17].copy()), scene.root_lo, scene.root_hi)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert (ours.numpy()[st[17] < 0.5] == 2 ** 30).all()  # dead rays last


def test_morton_perm_matches_jax():
    from cpupathtrace_tpu.integrator.film import morton_perm

    rng = np.random.default_rng(0)
    px = rng.integers(0, 300, 5000)
    py = rng.integers(0, 200, 5000)
    np.testing.assert_array_equal(film.morton_perm(px, py), morton_perm(px, py))
    xg, yg = np.meshgrid(np.arange(8), np.arange(8))
    perm = film.morton_perm(xg.ravel(), yg.ravel())
    assert sorted(perm.tolist()) == list(range(64)) and perm[:4].tolist() == [0, 1, 8, 9]
    with pytest.raises(ValueError):
        film.morton_perm(np.array([1 << 16]), np.array([0]))


def test_use_pixel_order_only_for_binned_scenes_on_cuda(scene):
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene

    assert film.use_pixel_order(scene, "cuda")
    assert not film.use_pixel_order(scene, "cpu")
    assert not film.use_pixel_order(bench_box_scene(device=CPU), "cuda")


@pytest.mark.parametrize("k", range(SORTED_DEPTH))
def test_twin_bounce_matches_jax_bounce(k, fixture, scene):
    _check_bounce(k, fixture["bounce_states"], scene)


def test_twin_trace_matches_jax_trace(fixture, scene):
    _check_trace(fixture["trace"], scene)


@pytest.mark.slow
def test_twin_matches_live_jax_kernels(scene):
    """The two comparisons above against live interpret-mode runs of the
    JAX `_bounce_call` and `trace_megakernel_sorted`."""
    states = jax_bounce_states()
    for k in range(SORTED_DEPTH):
        _check_bounce(k, states, scene)
    _check_trace(jax_sorted_trace(), scene)


def _check_bounce(k, states, scene):
    st = torch.from_numpy(states[k].copy())
    live = states[k][17] > 0.5
    sw.bounce_reference(scene, st, k, OPTS)
    ours, ref = st.numpy(), states[k + 1]
    plane = {name: i for i, name in enumerate(sw.STATE_FIELDS)}
    np.testing.assert_array_equal(ours[0].view(np.int32)[live], ref[0].view(np.int32)[live])
    for name in EXACT_PLANES:
        np.testing.assert_array_equal(ours[plane[name]], ref[plane[name]], err_msg=name)
    for names, frac in ((CLOSE_PLANES, 0.999), (OUT_PLANES, 0.98)):
        for name in names:
            close = np.isclose(ours[plane[name]], ref[plane[name]], rtol=1e-5, atol=1e-6).mean()
            assert close >= frac, (name, close)
    # The twin leaves dead rays as they were.
    np.testing.assert_array_equal(ours[:, ~live].view(np.int32), states[k][:, ~live].view(np.int32))


def _check_trace(ref, scene):
    spec, coll = sw.trace_megakernel_sorted(scene, _rays(), OPTS, SORTED_SEED, sort=False)
    ours = spec.numpy()
    np.testing.assert_array_equal(ours[:, 3], ref[:, 3])
    assert coll.dtype == torch.bool and bool((coll.numpy() == (ref[:, 3] > 0.5)).all())
    a, b = float(ours[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= 0.005 * abs(b), (a, b)
    rtol, atol, frac = BOUNDS_TRACE
    close = np.isclose(ours, ref, rtol=rtol, atol=atol).all(axis=1).mean()
    assert close >= frac, close


def test_sorted_equals_unsorted_per_ray(scene, monkeypatch):
    """Every ray's random stream rides its state and no ray's work depends
    on its neighbours, so sorting at every bounce changes no ray's result,
    bit for bit."""
    monkeypatch.setattr(sw, "_SORT_MIN_ALIVE", 0)
    opts = RenderOptions(8, 8, 1, 1, max_depth=8)
    a, ca = sw.trace_megakernel_sorted(scene, _rays(), opts, 99, sort=True)
    b, cb = sw.trace_megakernel_sorted(scene, _rays(), opts, 99, sort=False)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(ca, cb)


def test_bounce_wrapper_routes_cpu_state_to_the_twin(scene):
    o, d = sorted_rays(64)
    st = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), 3)
    twin = st.clone()
    calls, launches = sw.bounce_reference.calls, sw.bounce.launches
    sw.bounce(scene, st, torch.tensor([3, 0], dtype=torch.int32), OPTS)
    assert sw.bounce_reference.calls == calls + 1 and sw.bounce.launches == launches
    sw.bounce_reference(scene, twin, 0, OPTS)
    assert torch.equal(st.view(torch.int32), twin.view(torch.int32))
    meta = torch.zeros((sw.N_STATE, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        sw.bounce(scene, meta, torch.zeros(2, dtype=torch.int32, device="meta"), OPTS)


def test_sorted_driver_refuses_dense_scenes():
    """The driver takes dense scenes within the kernels' limits (JAX
    sorted_wavefront.py:383-391) and refuses, as JAX does, those beyond
    them (megakernel_supported)."""
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    for i in range(mk.MAX_SPH + 1):
        b.add_sphere((float(i), 0.0, 0.0), 0.1)
    big = b.build(device=CPU)
    assert not big.has_kernel_records and not mk.megakernel_supported(big)
    with pytest.raises(ValueError, match="limits"):
        sw.trace_megakernel_sorted(big, _rays(), OPTS, 1)
    box = build_scene("bench_box", "port")
    spec, coll = sw.trace_megakernel_sorted(box, _rays(), OPTS, 1)
    assert spec.shape == (SORTED_RAYS, 4) and bool(coll.all())


def _box_rays():
    o, d = make_rays("sphere_dirs", SORTED_RAYS)
    return Rays(torch.from_numpy(o), torch.from_numpy(d))


def _check_box(ref):
    spec, coll = sw.trace_megakernel_sorted(build_scene("bench_box", "port"), _box_rays(), OPTS,
                                            SORTED_BOX_SEED)
    ours = spec.numpy()
    np.testing.assert_array_equal(ours[:, 3], ref[:, 3])
    assert bool((coll.numpy() == (ref[:, 3] > 0.5)).all())
    a, b = float(ours[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= 0.005 * abs(b), (a, b)
    rtol, atol, frac = BOUNDS_BOX
    close = np.isclose(ours, ref, rtol=rtol, atol=atol).all(axis=1).mean()
    assert close >= frac, close


def test_twin_driver_on_the_box_matches_jax():
    """The box, a dense scene, through the sorted driver (K2's dense form,
    the sort by octant alone) against JAX trace_megakernel_sorted."""
    _check_box(np.load(FIXTURE_BOX)["sorted_box"])


@pytest.mark.slow
def test_twin_driver_on_the_box_matches_live_jax():
    _check_box(jax_sorted_box_trace())


def test_sort_key_on_a_dense_scene_matches_jax():
    """A dense scene's root box is +inf / -inf (scene.py): the keys sort by
    direction octant alone, bit-equal to JAX's."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.sorted_wavefront import _sort_key

    box = build_scene("bench_box", "port")
    assert not box.has_kernel_records and bool(torch.isinf(box.root_lo).all())
    o, d = make_rays("sphere_dirs", 2048, seed=4)
    o = o + np.random.default_rng(4).uniform(-0.9, 0.9, o.shape).astype(np.float32)
    alive = (np.arange(2048) % 5 != 0).astype(np.float32)
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], alive]
    ref = np.asarray(_sort_key(*[jnp.asarray(c) for c in cols],
                               jnp.asarray(box.root_lo.numpy()), jnp.asarray(box.root_hi.numpy())))
    ours = sw._sort_key(*[torch.from_numpy(np.ascontiguousarray(c)) for c in cols],
                        box.root_lo, box.root_hi)
    np.testing.assert_array_equal(ours.numpy(), ref)
    assert set(np.unique(ours.numpy()[alive > 0.5])) <= set(range(8))


def test_sorted_equals_unsorted_on_the_box(monkeypatch):
    """Sorting changes no ray's result on a dense scene either."""
    monkeypatch.setattr(sw, "_SORT_MIN_ALIVE", 0)
    box = build_scene("bench_box", "port")
    opts = RenderOptions(8, 8, 1, 1, max_depth=8)
    a, ca = sw.trace_megakernel_sorted(box, _box_rays(), opts, 7, sort=True)
    b, cb = sw.trace_megakernel_sorted(box, _box_rays(), opts, 7, sort=False)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32)) and torch.equal(ca, cb)


def test_pixel_order_chunks_scatter_back(scene):
    """render_chunk[_batched] with a Morton pixel order launch pixel-major
    and scatter the sums back to the caller's pixel positions: in the closed
    box every pixel collects every sample."""
    from cpupathtrace_tpu_torch.models.scenes import bench_camera

    w = 8
    opts = RenderOptions(w, w, 2, 2, max_depth=3)
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(w, dtype=np.float32))
    x, y = film.pixel_camera_coords(opts, xg.ravel(), yg.ravel())
    x, y = torch.from_numpy(np.ascontiguousarray(x)), torch.from_numpy(np.ascontiguousarray(y))
    perm = torch.from_numpy(film.morton_perm(xg.ravel(), yg.ravel()))
    gen = torch.Generator().manual_seed(0)
    s, c = film.render_chunk(scene, bench_camera(device=CPU), opts, x, y, gen, 3, pixel_order=perm)
    assert s.shape == (w * w, 4) and (c == 3).all() and torch.isfinite(s).all()
    sb, cb = film.render_chunk_batched(scene, bench_camera(device=CPU), opts, x, y, gen, 2, 3,
                                       pixel_order=perm)
    assert sb.shape == (3, w * w, 4) and (cb == 2).all() and torch.isfinite(sb).all()


def test_binned_render_on_the_cpu():
    """render() of a small binned scene runs the sorted driver's twin: a
    finite image with alpha 1 everywhere in the closed box."""
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.models.scenes import bench_camera

    scene = dragon_scene("port")
    calls = sw.bounce_reference.calls
    img = pt.render(scene, bench_camera(device=CPU), RenderOptions(16, 16, 4, 4, max_depth=6), seed=1)
    assert sw.bounce_reference.calls > calls
    assert img.shape == (16, 16, 4) and np.isfinite(img).all()
    assert (img[..., 3] == 1.0).all() and 0.005 < img[..., :3].mean() < 1.0
