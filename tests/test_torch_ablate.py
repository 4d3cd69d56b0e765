"""The JAX package's ablation switches in the port (PTX_ABLATE: nee,
bigpair, prop, mat; PTX_SKIP_TRAVERSE), on the CPU, where the twin stands
in for K1 and K2 (integrator/megakernel.py `_bounce`, read by
integrator/sorted_wavefront.py): the twin under each setting against the
JAX kernels in interpret mode under the same setting, the refusals of the
gradient path, and the kernels' mask. The CUDA ablation instances are held
bit for bit to the twin by tests/test_torch_cuda.py and chip_smoke.py
(phase 31).

The JAX side is committed in tests/fixtures/torch_ablate.npz
(make_torch_ablate_fixtures.py, one process per setting: JAX reads the
switches at import); the live comparison is marked slow. The port's
switches are module attributes read at each call, set here with
monkeypatch. Bounds, per case (measured values in the comments), as
tests/test_torch_megakernel.py's: `collected` equal on every ray, the mean
radiance within MEAN_REL, the spectrum within (rtol, atol) on at least
`frac` of the rays. Where emitter NEE runs, XLA:CPU's FMAs flip the
emitter's self-occlusion test on a few per cent of rays (that file's
docstring); "nee" removes it, and those cases agree to the bit or nearly.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cpupathtrace_tpu.integrator import diff_megakernel as jax_dm
from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import diff_megakernel as dm
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from tests.torch_util import (
    ABLATE_BOUNCE_DEPTHS,
    ABLATE_CASES,
    ABLATE_SETTINGS,
    ABLATE_TRIS,
    MEGA_BINNED_DEPTH,
    MEGA_BINNED_SEED,
    ablation_values,
    build_scene,
    dragon_scene,
    make_rays,
    mega_binned_rays,
    port_megakernel,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_ablate.npz")
GENERATOR = os.path.join(os.path.dirname(__file__), "fixtures", "make_torch_ablate_fixtures.py")
# (rtol, atol, frac, mean_rel) per case.
BOUNDS = {
    "box_nee": (1e-5, 1e-7, 0.999, 1e-4),  # 1.000 (0.9995 bit-equal), mean equal
    "box_bigpair": (0.0, 0.0, 1.0, 0.0),  # every ray escapes: all zero, as JAX
    "box_prop": (1e-3, 1e-5, 0.95, 0.005),  # 0.982, mean 1.3e-4
    "box_mat": (1e-3, 1e-5, 0.95, 0.005),  # 0.961, mean 4.4e-5
    "dragon_nee": (1e-5, 1e-7, 0.999, 1e-4),  # bit-equal
    "dragon_skip": (1e-5, 1e-7, 0.93, 0.015),  # 0.975, mean 0.24%
    "dragon_nee_skip": (1e-5, 1e-7, 0.999, 1e-4),  # bit-equal
}
BOUNCE_OPTS = RenderOptions(8, 8, 1, 1, max_depth=8)
# One bounce against JAX's, per plane (tests/test_torch_sorted.py's bounds):
# rng bit-equal on the rays alive on entry; these planes bit-equal; origin,
# direction, divisor and contrib within rtol 1e-5 / atol 1e-6 on >= 99.9%;
# the sums on >= 98%. From depth 4 on the roulette's probability
# 0.1 + 0.1 * min(contrib * mean, 1) is an FMA in XLA:CPU, so bounce_pd
# may differ by an ulp there (14 of 1024 rays at depth 5 under "nee"): it
# joins the close planes.
EXACT_PLANES = ("sr", "sg", "sb", "bounce_pd", "collected_f", "alive_f")
CLOSE_PLANES = ("ox", "oy", "oz", "dx", "dy", "dz", "divisor", "contrib_unw")
OUT_PLANES = ("out_r", "out_g", "out_b")


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


@pytest.fixture(scope="module")
def dragon():
    return dragon_scene("port", ABLATE_TRIS)


@pytest.fixture(scope="module")
def small_dragon():
    return dragon_scene("port")


def _switch(monkeypatch, setting):
    ablate, skip = ablation_values(setting)
    monkeypatch.setattr(mk, "_ABLATE", ablate)
    monkeypatch.setattr(mk, "_SKIP_TRAVERSE", skip)


def _check(ours, ref, case):
    rtol, atol, frac, mean_rel = BOUNDS[case]
    np.testing.assert_array_equal(ours[:, 3], ref[:, 3])
    a, b = float(ours[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= mean_rel * abs(b), (case, a, b)
    close = np.isclose(ours, ref, rtol=rtol, atol=atol).all(axis=1).mean()
    assert close >= frac, (case, close)


def _dragon_trace(scene, debug_visits=False):
    o, d = mega_binned_rays()
    return mk.trace_megakernel_reference(
        scene, Rays(torch.from_numpy(o), torch.from_numpy(d)),
        RenderOptions(8, 8, 1, 1, max_depth=MEGA_BINNED_DEPTH), MEGA_BINNED_SEED,
        debug_visits=debug_visits)


def _check_bounce(states, scene, depth):
    st = torch.from_numpy(states[0].copy())
    live = states[0][17] > 0.5
    assert live.sum() >= 512, "the bounce must start from live rays"
    sw.bounce_reference(scene, st, depth, BOUNCE_OPTS)
    ours, ref = st.numpy(), states[1]
    plane = {name: i for i, name in enumerate(sw.STATE_FIELDS)}
    np.testing.assert_array_equal(ours[0].view(np.int32)[live], ref[0].view(np.int32)[live])
    roulette = ("bounce_pd",) if depth + 1 > 4 else ()
    for name in EXACT_PLANES:
        if name not in roulette:
            np.testing.assert_array_equal(ours[plane[name]], ref[plane[name]], err_msg=name)
    for names, frac in ((CLOSE_PLANES + roulette, 0.999), (OUT_PLANES, 0.98)):
        for name in names:
            close = np.isclose(ours[plane[name]], ref[plane[name]], rtol=1e-5, atol=1e-6).mean()
            assert close >= frac, (name, close)


@pytest.mark.parametrize("setting", ABLATE_CASES["box"])
def test_box_twin_matches_jax_k1_dense(setting, fixture, monkeypatch):
    _switch(monkeypatch, setting)
    _check(port_megakernel("box"), fixture[f"box_{setting}"], f"box_{setting}")


@pytest.mark.parametrize("setting", ABLATE_CASES["dragon"])
def test_dragon_twin_matches_jax_k1_binned(setting, fixture, dragon, monkeypatch):
    _switch(monkeypatch, setting)
    spec, _ = _dragon_trace(dragon)
    _check(spec.numpy(), fixture[f"dragon_{setting}"], f"dragon_{setting}")


@pytest.mark.parametrize("depth", ABLATE_BOUNCE_DEPTHS)
@pytest.mark.parametrize("setting", ABLATE_CASES["bounce"])
def test_twin_bounce_matches_jax_k2(setting, depth, fixture, small_dragon, monkeypatch):
    """K2's plain version, one bounce at depth 0 (from the fresh state) and
    at depth 5 (the roulette on), the rng plane included: "nee" draws 1 + 3
    numbers a bounce, not 1 + 3 em_k + 3."""
    _switch(monkeypatch, setting)
    _check_bounce(fixture[f"bounce_{setting}_{depth}"], small_dragon, depth)


def test_each_switch_changes_the_twin(dragon, monkeypatch):
    """The settings do what they say on the box and the dragon: nee darkens
    both, bigpair lets every box ray escape, mat's emission 0.05 brightens
    the box, prop moves it; skip leaves the walk's counters at zero with a
    nearest query per ray-bounce, nee the shadow walks' columns."""
    base = port_megakernel("box")
    means = {}
    for setting in ABLATE_CASES["box"]:
        _switch(monkeypatch, setting)
        spec = port_megakernel("box")
        means[setting] = float(spec[:, :3].mean())
        if setting == "bigpair":
            assert not spec.any()
    b = float(base[:, :3].mean())
    assert means["nee"] < 0.9 * b and means["mat"] > 1.5 * b and abs(means["prop"] - b) > 0.1 * b
    _switch(monkeypatch, None)
    spec0, _, vis0 = _dragon_trace(dragon, debug_visits=True)
    _switch(monkeypatch, "skip")
    _, _, vis = _dragon_trace(dragon, debug_visits=True)
    v = vis.sum(0)
    assert v[kt.QUERY_COL] > 0 and not v[:kt.QUERY_COL].any(), v
    _switch(monkeypatch, "nee")
    spec, _, vis = _dragon_trace(dragon, debug_visits=True)
    v = vis.sum(0)
    assert not v[kt.SHADOW_COLS].any() and v[kt.NEAR_COLS].all() and vis0.sum(0)[kt.SHADOW_COLS].all()
    assert float(spec[:, :3].mean()) < float(spec0[:, :3].mean())


@pytest.mark.parametrize("ablate,skip,binned,want", [
    ("", False, True, 0),
    ("nee", False, True, 1),
    ("bigpair,mat", False, False, 2 | 8),
    ("prop,foo,,nee", False, True, 4 | 1),
    ("", True, True, 16),
    ("", True, False, 0),
    ("nee,bigpair,prop,mat", True, True, 31),
])
def test_ablation_mask(ablate, skip, binned, want, monkeypatch):
    """The kernels' mask from the switches at the call: unknown tokens are
    ignored (as JAX ignores them), the walk's bit only for a binned scene."""
    monkeypatch.setattr(mk, "_ABLATE", frozenset(x for x in ablate.split(",") if x))
    monkeypatch.setattr(mk, "_SKIP_TRAVERSE", skip)
    assert mk.ablation_mask(binned) == want


@pytest.mark.parametrize("value,want", [(None, True), ("", True), ("nee", False),
                                        ("foo", False), (",", False)])
def test_diff_supported_refuses_under_ptx_ablate_as_jax(value, want, monkeypatch):
    """diff_supported reads PTX_ABLATE at the call, as JAX's
    (diff_megakernel.py:62): set to anything, the record route is refused;
    PTX_SKIP_TRAVERSE alone does not refuse it."""
    scene_p, scene_j = build_scene("bench_box", "port"), build_scene("bench_box", "jax")
    monkeypatch.delenv("PTX_ABLATE", raising=False)
    monkeypatch.setenv("PTX_SKIP_TRAVERSE", "1")
    if value is not None:
        monkeypatch.setenv("PTX_ABLATE", value)
    assert dm.diff_supported(scene_p) == jax_dm.diff_supported(scene_j) == want


@pytest.mark.parametrize("setting", ["nee", "mat", "skip"])
def test_record_form_raises_under_a_switch(setting, small_dragon, monkeypatch):
    """K2's record form has no ablation instance: the wrapper raises
    ValueError (the JAX kernel asserts, pallas_megakernel.py:885), on the
    CPU route as on the card, and so does the gradient forward."""
    o, d = make_rays("sphere_dirs", 256)
    box = build_scene("bench_box", "port")
    _switch(monkeypatch, setting)
    for scene in (small_dragon, box):
        st = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), 3)
        n_drec = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
        records = torch.empty((n_drec, 256))
        seed_depth = torch.tensor([3, 0], dtype=torch.int32)
        if setting == "skip" and scene is box:
            # A dense scene has no walk to skip: its records run as ever.
            sw.bounce(scene, st, seed_depth, BOUNCE_OPTS, records=records)
            continue
        with pytest.raises(ValueError, match="record form"):
            sw.bounce(scene, st, seed_depth, BOUNCE_OPTS, records=records)
        with pytest.raises(ValueError, match="record form"):
            dm.trace_megakernel_diff(scene, Rays(torch.from_numpy(o), torch.from_numpy(d)),
                                     BOUNCE_OPTS, 3)


def test_switches_are_read_at_the_call(monkeypatch, small_dragon):
    """The sorted driver reads the module's switches at each call: under
    "nee" its bounces walk no shadow ray, and unsetting the switch restores
    the default trace bit for bit."""
    o, d = mega_binned_rays()
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    opts = RenderOptions(8, 8, 1, 1, max_depth=MEGA_BINNED_DEPTH)

    def trace():
        return sw.trace_megakernel_sorted(small_dragon, rays, opts, 5, sort=False,
                                          debug_visits=True)

    base, _, vis = trace()
    assert vis.sum((0, 1))[kt.SHADOW_COLS].all()
    _switch(monkeypatch, "nee")
    nee, _, vis = trace()
    assert not vis.sum((0, 1))[kt.SHADOW_COLS].any() and not torch.equal(nee, base)
    _switch(monkeypatch, None)
    again, _, _ = trace()
    assert torch.equal(again, base)


@pytest.mark.slow
@pytest.mark.parametrize("setting", sorted(ABLATE_SETTINGS))
def test_twin_matches_live_jax_kernels(setting, dragon, small_dragon, tmp_path, monkeypatch):
    """The comparisons above against live interpret-mode runs of the JAX
    kernels, in a process with the setting's environment."""
    ablate, skip = ABLATE_SETTINGS[setting]
    path = tmp_path / f"{setting}.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PTX_ABLATE=ablate, PTX_SKIP_TRAVERSE=skip)
    subprocess.run([sys.executable, GENERATOR, setting, str(path)], env=env, check=True)
    live = np.load(path)
    _switch(monkeypatch, setting)
    for key in live.files:
        if key.startswith("box_"):
            _check(port_megakernel("box"), live[key], key)
        elif key.startswith("dragon_"):
            _check(_dragon_trace(dragon)[0].numpy(), live[key], key)
        else:
            _check_bounce(live[key], small_dragon, int(key.rsplit("_", 1)[1]))
