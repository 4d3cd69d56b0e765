"""Gradients in the port (cpupathtrace_tpu_torch/diff, integrator/
diff_megakernel.py) against the JAX package and against its own finite
differences, on the setups of tests/test_diff.py.

Two routes compute gradients, as film.py:63-107 picks them: the
record-and-replay path (`trace_diff`: K2's record form, here its twin, and
the vjp of the replay) and the differentiable wavefront
(PTX_DIFF_MEGAKERNEL=0). The JAX comparisons run the wavefront on the JAX
package's own jax.random draws (RecordedDraws), since JAX on the CPU takes
its wavefront; the record comparisons use the committed interpret-mode
fixture tests/fixtures/torch_diff.npz (make_torch_diff_fixtures.py).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu import RenderOptions as JOptions
from cpupathtrace_tpu import make_camera as jmake_camera
from cpupathtrace_tpu.diff import get_material_params as jget_params
from cpupathtrace_tpu.diff import image_loss as jimage_loss
from cpupathtrace_tpu.diff import render_image_diff as jrender_image_diff
from cpupathtrace_tpu_torch import diff, make_camera
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import diff_megakernel as dm
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.integrator.rng import RecordedDraws
from tests.torch_util import (
    CPU,
    DIFF_CASES,
    DIFF_DEPTH,
    DIFF_RAYS,
    DIFF_SEED,
    build_scene,
    jax_render_draws,
    make_rays,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_diff.npz")
ROUTES = {"replay": "1", "wavefront": "0"}

# test_diff.py's setups: name -> (scene, camera kwargs, image size, JAX
# target key, JAX loss key). max_depth 4: roulette p == 1, so FD and the
# analytic gradient agree exactly (diff/render.py).
SETUPS = {
    "box": ("inward_box", dict(origin=(0, 0, 0), look_at=(0, 0, 0.9), up=(0, 1, 0)), 6, 99, 0),
    "specular": ("specular", dict(origin=(0, 0, -0.9), look_at=(0, -0.25, 0.5), up=(0, 1, 0)),
                 8, 77, 3),
}
SPP = 8


def _setup(name, port_target=True):
    scene_name, cam_kw, size, _, _ = SETUPS[name]
    scene = build_scene(scene_name, "port")
    cam = make_camera(**cam_kw, device=CPU)
    opts = RenderOptions(size, size, SPP, SPP, max_depth=4)
    target = None
    if port_target:
        target = diff.render_image_diff(scene, cam, opts, 99, SPP).detach()
    return scene, cam, opts, target


def _material(scene_name, which):
    """Material ids of specular_box_scene: mirror 3, glass 4."""
    return {"mirror": 3, "glass": 4}[which]


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setenv("PTX_DIFF_MEGAKERNEL", ROUTES[request.param])
    return request.param


# ---------------------------------------------------------------------------
# Against the JAX package.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,no_em,rtol", [
    ("box", True, 1e-5), ("specular", True, 1e-5), ("box", False, 0.1), ("specular", False, 0.1),
])
def test_image_loss_gradient_matches_jax(name, no_em, rtol, monkeypatch):
    """The port's loss_and_grad against jax.grad(image_loss) on the same
    draws (both through the wavefront), every material entry. Without
    emitter NEE they agree to float32 reassociation (within 1e-5 of the
    largest entry; measured 3.8e-7 and 5.2e-7); with it the emitter
    self-occlusion coin flips (tests/test_torch_wavefront.py) move the
    entries by a few per cent (within 0.1 of the largest entry; measured
    5.1% on the box, 2.3% on the specular scene)."""
    monkeypatch.setenv("PTX_DIFF_MEGAKERNEL", "0")
    scene_name, cam_kw, size, t_key, l_key = SETUPS[name]
    js = build_scene(scene_name, "jax")
    ps = build_scene(scene_name, "port")
    if no_em:
        js = dataclasses.replace(js, emissive_sample_count=0)
        ps = dataclasses.replace(ps, emissive_sample_count=0)
    jcam = jmake_camera(**cam_kw)
    opts_j = JOptions(size, size, SPP, SPP, max_depth=4)
    target = jax.lax.stop_gradient(jrender_image_diff(js, jcam, opts_j, jax.random.PRNGKey(t_key), SPP))
    key = jax.random.PRNGKey(l_key)
    jp = jget_params(js)
    jg = jax.grad(jimage_loss)(jp, js, jcam, opts_j, target, key, SPP)
    jl = float(jimage_loss(jp, js, jcam, opts_j, target, key, SPP))

    params = diff.material_params_from_numpy({f: np.asarray(v) for f, v in jp.items()}, CPU)
    draws = RecordedDraws(jax_render_draws(key, size * size * SPP, ps.emissive_sample_count, 4))
    loss, g = diff.loss_and_grad(params, ps, make_camera(**cam_kw, device=CPU),
                                 RenderOptions(size, size, SPP, SPP, max_depth=4),
                                 torch.from_numpy(np.asarray(target)), draws, SPP)
    np.testing.assert_allclose(float(loss), jl, rtol=max(rtol, 1e-5))
    scale = max(float(np.abs(np.asarray(jg[f])).max()) for f in diff.DIFFERENTIABLE_FIELDS)
    assert scale > 0
    for f in diff.DIFFERENTIABLE_FIELDS:
        np.testing.assert_allclose(g[f].numpy(), np.asarray(jg[f]), rtol=0, atol=rtol * scale,
                                   err_msg=f)


def test_material_params_carry_across_and_give_the_same_forward():
    """material_params_from_numpy of the JAX params: leaf tensors that
    require grad, equal to the port's own table, so the forward is the
    port scene's bit for bit."""
    js = build_scene("inward_box", "jax")
    ps = build_scene("inward_box", "port")
    params = diff.material_params_from_numpy({f: np.asarray(v) for f, v in jget_params(js).items()},
                                             CPU)
    for f, v in params.items():
        assert v.is_leaf and v.requires_grad and v.dtype == torch.float32
        np.testing.assert_array_equal(v.detach().numpy(), getattr(ps, f).numpy())
    _, cam, opts, _ = _setup("box", port_target=False)
    a = diff.render_image_diff(diff.apply_material_params(ps, params), cam, opts, 5, SPP)
    b = diff.render_image_diff(ps, cam, opts, 5, SPP)
    assert torch.equal(a.detach(), b)


# ---------------------------------------------------------------------------
# Against finite differences, both routes.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
@pytest.mark.parametrize("field,index", [
    ("mat_diffuse", (1, 0)), ("mat_diffuse", (1, 1)),
    ("mat_emission", (2, 0)), ("mat_emission", (2, 2)),
])
def test_gradient_matches_finite_difference(route, field, index):
    """test_diff.py:66's contract: rtol 0.05, atol 1e-4, common random
    numbers (measured agreement ~1e-4 relative on both routes)."""
    scene, cam, opts, target = _setup("box")
    params = diff.get_material_params(scene)
    _, g = diff.loss_and_grad(params, scene, cam, opts, target, 0, SPP)
    fd = diff.finite_difference_grad(params, scene, cam, opts, target, 0, SPP, field, index,
                                     eps=2e-3)
    analytic = float(g[field][index])
    assert np.isfinite(analytic) and analytic != 0.0
    np.testing.assert_allclose(analytic, fd, rtol=0.05, atol=1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
@pytest.mark.parametrize("which,channel", [("mirror", 0), ("mirror", 2), ("glass", 0), ("glass", 1)])
def test_specular_gradient_matches_finite_difference(route, which, channel):
    """mat_specular through the mirror and glass chain (test_diff.py:91)."""
    scene, cam, opts, target = _setup("specular")
    params = diff.get_material_params(scene)
    mat = _material("specular", which)
    _, g = diff.loss_and_grad(params, scene, cam, opts, target, 3, SPP)
    fd = diff.finite_difference_grad(params, scene, cam, opts, target, 3, SPP, "mat_specular",
                                     (mat, channel), eps=2e-3)
    analytic = float(g["mat_specular"][mat, channel])
    assert np.isfinite(analytic) and abs(analytic) > 0.0
    np.testing.assert_allclose(analytic, fd, rtol=0.05, atol=1e-4)


@pytest.mark.parametrize("route", sorted(ROUTES), indirect=True)
def test_gradients_nonzero_where_expected(route):
    scene, cam, opts, target = _setup("box")
    _, g = diff.loss_and_grad(diff.get_material_params(scene), scene, cam, opts, target, 0, SPP)
    assert float(g["mat_diffuse"][1].abs().sum()) > 0.0
    assert float(g["mat_emission"][2].abs().sum()) > 0.0
    # The default material 0 is used by no primitive: zero gradient.
    np.testing.assert_array_equal(g["mat_diffuse"][0].numpy(), 0.0)
    assert torch.isfinite(g["mat_diffuse"]).all()


def test_inverse_rendering_recovers_albedo():
    """test_diff.py:135: Adam on the unbiased loss from wall albedo 0.3
    (60 steps, 6x6 @ 8 spp, the default route) lowers the loss and moves
    the albedo above 0.55."""
    scene, cam, opts, _ = _setup("box", port_target=False)
    target = diff.render_image_diff(scene, cam, opts, 7, 16).detach()
    init = {"mat_diffuse": scene.mat_diffuse.clone()}
    init["mat_diffuse"][1, :3] = 0.3
    rec, losses = diff.inverse_render(scene, cam, opts, target, init, steps=60,
                                      learning_rate=0.05, spp=SPP)
    assert losses.shape == (60,) and losses[-1] < losses[0]
    assert (rec["mat_diffuse"][1, :3] > 0.55).all(), rec["mat_diffuse"][1]
    assert (rec["mat_diffuse"] >= 0).all()


# ---------------------------------------------------------------------------
# Records and replay.
# ---------------------------------------------------------------------------


def _port_records(case):
    scene = build_scene(case, "port")
    o, d = make_rays("sphere_dirs", DIFF_RAYS)
    spec, coll, recs = dm.trace_megakernel_diff(
        scene, Rays(torch.from_numpy(o), torch.from_numpy(d)),
        RenderOptions(8, 8, 1, 1, max_depth=DIFF_DEPTH), DIFF_SEED,
    )
    return scene, spec, recs


def _replay_args(scene):
    return dm.em_material_ids(scene), scene.light_spectrum[:, :3]


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


# case -> share of (ray, depth) rows whose records equal the JAX kernel's
# (mid, sel, CDF rows exactly; weights within rtol 1e-5), over the rows
# alive in both; measured in the comments. The emitter self-occlusion coin
# flips change weights (and, later, paths) on the rest.
RECORD_SHARE = {"bench_box": 0.95, "specular_point_light": 0.88}  # 0.973, 0.912


@pytest.mark.parametrize("case", DIFF_CASES)
def test_twin_records_match_the_jax_kernel(case, fixture):
    scene, spec, recs = _port_records(case)
    ref = fixture[f"{case}_recs"]
    ours = recs.numpy()
    assert ours.shape == ref.shape
    live = (ours[..., 0] >= 0) | (ref[..., 0] >= 0)
    exact = (ours[..., [0, 2]] == ref[..., [0, 2]]).all(-1)
    nl, k = scene.n_point_lights, scene.emissive_sample_count
    rows = [3 + nl + 2 * j for j in range(k)]
    weights = [1] + list(range(3, 3 + nl)) + [r + 1 for r in rows]
    exact &= (ours[..., rows] == ref[..., rows]).all(-1)
    close = np.isclose(ours[..., weights], ref[..., weights], rtol=1e-5, atol=0).all(-1)
    share = float((exact & close)[live].mean())
    assert share >= RECORD_SHARE[case], share
    mean_ours, mean_ref = float(spec[:, :3].mean()), float(fixture[f"{case}_spec"][:, :3].mean())
    assert abs(mean_ours - mean_ref) <= 0.03 * mean_ref, (mean_ours, mean_ref)


@pytest.mark.slow
@pytest.mark.parametrize("case", DIFF_CASES)
def test_fixture_matches_the_live_jax_kernel(case, fixture):
    """The committed fixture is what the JAX kernel computes today
    (interpret mode, ~10 s per case): regenerate it when this fails."""
    from tests.torch_util import jax_diff_records

    for name, live in zip(("spec", "recs", "replay", "fast"), jax_diff_records(case)):
        np.testing.assert_array_equal(live, fixture[f"{case}_{name}"], err_msg=name)


@pytest.mark.parametrize("case", DIFF_CASES)
def test_replay_of_the_jax_records_matches_the_jax_replay(case, fixture):
    """replay_spectrum and replay_fast of the JAX kernel's records: the
    same float32 sums as the JAX replays (rtol 1e-6 / 1e-5: einsum order)."""
    scene = build_scene(case, "port")
    recs = torch.from_numpy(fixture[f"{case}_recs"])
    mats = diff.get_material_params(scene)
    em, ls = _replay_args(scene)
    nl, k = scene.n_point_lights, scene.emissive_sample_count
    ref = dm.replay_spectrum(mats, recs, em, ls, nl, k)
    np.testing.assert_allclose(ref.numpy(), fixture[f"{case}_replay"], rtol=1e-6, atol=1e-7)
    pre = dm.preprocess_records(recs, em, ls, scene.num_materials, nl, k)
    np.testing.assert_allclose(dm.replay_fast(mats, pre).numpy(), fixture[f"{case}_fast"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", DIFF_CASES)
def test_replay_rebuilds_the_forward_and_recording_changes_nothing(case):
    """The twin's records replay to its own sums (replay_spectrum to 1e-6,
    replay_fast to f32 reassociation), and the recording forward's 18
    state planes are bit-equal to the plain twin's."""
    scene, spec, recs = _port_records(case)
    mats = diff.get_material_params(scene)
    em, ls = _replay_args(scene)
    nl, k = scene.n_point_lights, scene.emissive_sample_count
    ref = dm.replay_spectrum(mats, recs, em, ls, nl, k)
    np.testing.assert_allclose(ref.numpy(), spec[:, :3].numpy(), rtol=1e-6, atol=1e-6)
    fast = dm.replay_fast(mats, dm.preprocess_records(recs, em, ls, scene.num_materials, nl, k))
    np.testing.assert_allclose(fast.numpy(), spec[:, :3].numpy(), rtol=1e-5, atol=1e-6)

    o, d = make_rays("sphere_dirs", DIFF_RAYS)
    opts = RenderOptions(8, 8, 1, 1, max_depth=DIFF_DEPTH)
    a = sw.initial_state(torch.from_numpy(o), torch.from_numpy(d), DIFF_SEED)
    b = a.clone()
    planes = torch.empty((sw.n_diff_records(nl, k), DIFF_RAYS))
    for depth in range(DIFF_DEPTH):
        sw.bounce_reference(scene, a, depth, opts)
        sw.bounce_reference(scene, b, depth, opts, records=planes)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), depth
        dead = b[17] < 0.5
        assert (planes[0, dead] == -1).all() or depth == 0


def test_trace_diff_gradient_matches_central_difference():
    """test_megakernel.py:232: the gradient through the autograd Function
    against a central difference of the forward, common random numbers,
    exact-roulette depth (rtol 2e-2, atol 1e-5)."""
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_camera

    scene = bench_box_scene(device=CPU)
    cam = bench_camera(device=CPU)
    opts = RenderOptions(16, 16, 2, 2, epsilon=1e-3, max_depth=4)
    xs = torch.linspace(-0.9, 0.9, 16)
    x, y = torch.meshgrid(xs, xs, indexing="xy")
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays

    rays = shoot_rays(cam, x.reshape(-1).repeat(2), y.reshape(-1).repeat(2), 1 / 16, 1 / 16,
                      torch.Generator().manual_seed(0))
    mats = {f: getattr(scene, f).clone().requires_grad_(True) for f in dm.DIFF_FIELDS}

    def loss(m):
        sp, _ = dm.trace_diff(dataclasses.replace(scene, **m), rays, opts, 7)
        return sp[:, :3].mean()

    loss(mats).backward()
    eps = 2e-3
    for field, idx in (("mat_diffuse", (1, 1)), ("mat_emission", (2, 0))):
        up = {f: v.detach().clone() for f, v in mats.items()}
        dn = {f: v.detach().clone() for f, v in mats.items()}
        up[field][idx] += eps
        dn[field][idx] -= eps
        with torch.no_grad():
            fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
        np.testing.assert_allclose(float(mats[field].grad[idx]), fd, rtol=2e-2, atol=1e-5)


def test_gradients_flow_through_a_binned_scene():
    """test_diff.py:157 on a 5000-triangle dragon (binned from 4096 small
    triangles): finite, nonzero material gradients through the record path
    with the cluster traversal."""
    from cpupathtrace_tpu_torch.models.scenes import bench_camera, bench_dragon_scene

    scene = bench_dragon_scene(dragon_tris=5000, device=CPU)
    assert scene.accel == "binned" and dm.diff_supported(scene)
    params = {f: getattr(scene, f).clone().requires_grad_(True) for f in dm.DIFF_FIELDS}
    img = diff.render_image_diff(diff.apply_material_params(scene, params), bench_camera(device=CPU),
                                 RenderOptions(12, 12, 4, 4, epsilon=1e-3, max_depth=5), 0, 4)
    img[:, :3].mean().backward()
    gd = params["mat_diffuse"].grad
    assert torch.isfinite(gd).all() and (gd.abs() > 0).any()
    assert (params["mat_specular"].grad[3].abs() > 0).any()  # the glass dragon


# ---------------------------------------------------------------------------
# Device defaults.
# ---------------------------------------------------------------------------


def _resumable_chunk_tensors():
    """render_resumable of the CPU box with no device: the x_cam tensor its
    first chunk got (the tensors it rendered on)."""
    from unittest import mock

    from cpupathtrace_tpu_torch.integrator import checkpoint
    from cpupathtrace_tpu_torch.models import golden

    with mock.patch.object(checkpoint, "render_chunk", wraps=checkpoint.render_chunk) as spy:
        checkpoint.render_resumable(golden.inward_box_scene(device="cpu"),
                                    golden.box_camera(device="cpu"),
                                    RenderOptions(4, 4, 1, 1, max_depth=2), spp=1)
    return {"x_cam": spy.call_args.args[3]}


def _cache_calls(tmp):
    """load_scene and cached_build of a CPU box scene saved under `tmp`,
    each called with no device."""
    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.scene import cache

    path = os.path.join(tmp, "box.ptxt")
    cache.save_scene(scenes.bench_box_scene(device="cpu"), path)
    return {
        "load_scene": lambda: cache.load_scene(path),
        "cached_build": lambda: cache.cached_build(
            "box", lambda device: scenes.bench_box_scene(device=device), tmp)[0],
    }


def _entry_points(tmp=None):
    from cpupathtrace_tpu_torch.models import golden, scenes

    return {
        "bench_box_scene": scenes.bench_box_scene,
        "bench_dragon_scene_obj": lambda: scenes.bench_dragon_scene(
            dragon_obj="v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n"),
        "bench_camera": scenes.bench_camera,
        "cornell_demo_camera": scenes.cornell_demo_camera,
        "inward_box_scene": golden.inward_box_scene,
        "box_camera": golden.box_camera,
        "material_params_from_numpy": lambda: diff.material_params_from_numpy(
            {"mat_diffuse": np.ones((2, 4), np.float32)}),
        "render_resumable": _resumable_chunk_tensors,
        **(_cache_calls(tmp) if tmp else {"load_scene": None, "cached_build": None}),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name, tmp_path):
    """Called without `device`, an entry point puts its tensors on CUDA; on
    a machine without CUDA it raises (decided inside the test)."""
    fn = _entry_points(str(tmp_path))[name]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()
        return
    out = fn()
    t = next(iter(out.values())) if isinstance(out, dict) else getattr(out, "origin", None)
    t = t if t is not None else out.tri_v0
    assert t.device.type == "cuda"
