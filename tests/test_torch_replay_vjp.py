"""The replay vjp's plain twin (integrator/diff_megakernel.py
`replay_vjp_reference`, the CPU path of `replay_vjp`): the closed-form
gradients against autograd of `replay_spectrum` on the JAX kernel's and the
twin's records and on synthetic records that hold every encoding (misses,
chain codes 0-3, no-advance hits, point lights, one or two emitter draws);
and `trace_diff`'s CPU gradient against the path it replaced,
`replay_fast` over `preprocess_records` under autograd. The kernel itself
is held to this twin on the card (tests/test_torch_cuda.py).
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch import diff
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import diff_megakernel as dm
from tests.torch_util import DIFF_CASES, DIFF_DEPTH, DIFF_RAYS, DIFF_SEED, build_scene, make_rays

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_diff.npz")


def _autograd_vjp(mats, recs, em, ls, n_lights, em_k, g):
    """d sum(g[:, :3] * replay_spectrum) / d tables, by autograd."""
    leaves = [mats[f].detach().clone().requires_grad_(True) for f in dm.DIFF_FIELDS]
    out = dm.replay_spectrum(dict(zip(dm.DIFF_FIELDS, leaves)), recs, em, ls, n_lights, em_k)
    grads = torch.autograd.grad(out, leaves, g[:, :3], allow_unused=True)
    return [torch.zeros_like(x) if gr is None else gr for gr, x in zip(grads, leaves)]


def _close(got, want, rtol=1e-5):
    """Each gradient within rtol of the largest entry of its reference."""
    for f, a, b in zip(dm.DIFF_FIELDS, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, f
        scale = max(float(b.abs().max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=rtol * scale, err_msg=f)


def _grad_out(n, seed, signed=True):
    g = torch.from_numpy(np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32))
    return g if signed else g.abs()


def synthetic_records(n, depth, n_mat, n_lights, em_k, n_em, seed):
    """Records [D, n, n_drec] that hold every encoding: misses (mid -1, sel
    0, weights 0, drawn CDF rows kept, as K2 writes them), hits with chain
    codes 0-3, point-light and emitter weights; with the tables, em_mid and
    light spectra to replay them."""
    rng = np.random.default_rng(seed)
    nd = 3 + n_lights + 2 * em_k
    r = np.zeros((depth, n, nd), np.float32)
    mid = rng.integers(-1, n_mat, (depth, n))
    miss = mid < 0
    r[..., 0] = mid
    r[..., 1] = np.where(miss, 0.0, rng.uniform(0.0, 2.0, (depth, n)))
    r[..., 2] = np.where(miss, 0, rng.integers(0, 4, (depth, n)))
    r[..., 3:3 + n_lights] = np.where(miss[..., None], 0.0,
                                      rng.uniform(0.0, 1.0, (depth, n, n_lights)))
    for k in range(em_k):
        col = 3 + n_lights + 2 * k
        r[..., col] = rng.integers(0, n_em, (depth, n))
        r[..., col + 1] = np.where(miss, 0.0, rng.uniform(0.0, 1.5, (depth, n)))
    mats = {f: torch.from_numpy(rng.uniform(0.0, 1.0, (n_mat, 4)).astype(np.float32))
            for f in dm.DIFF_FIELDS}
    em = torch.from_numpy(rng.integers(0, n_mat, n_em))
    ls = torch.from_numpy(rng.uniform(0.0, 2.0, (n_lights, 3)).astype(np.float32))
    return torch.from_numpy(r), mats, em, ls


@pytest.fixture(scope="module")
def fixture():
    return dict(np.load(FIXTURE))


def _scene_args(scene):
    return (dm.em_material_ids(scene), scene.light_spectrum[:scene.n_point_lights, :3],
            scene.n_point_lights, scene.emissive_sample_count)


@pytest.mark.parametrize("source", ["jax", "twin"])
@pytest.mark.parametrize("case", DIFF_CASES)
def test_twin_matches_autograd_on_kernel_records(case, source, fixture):
    """The JAX kernel's records (the committed fixture) and the port's own
    twin's: the box with two emitter draws, and the specular box with a
    point light and the mirror / glass chain codes."""
    scene = build_scene(case, "port")
    if source == "jax":
        recs = torch.from_numpy(fixture[f"{case}_recs"])
    else:
        o, d = make_rays("sphere_dirs", DIFF_RAYS)
        _, _, recs = dm.trace_megakernel_diff(
            scene, Rays(torch.from_numpy(o), torch.from_numpy(d)),
            RenderOptions(8, 8, 1, 1, max_depth=DIFF_DEPTH), DIFF_SEED)
    mats = diff.get_material_params(scene)
    em, ls, nl, k = _scene_args(scene)
    g = _grad_out(recs.shape[1], 3)
    want = _autograd_vjp(mats, recs, em, ls, nl, k, g)
    got = dm.replay_vjp(recs.permute(0, 2, 1), g, *(mats[f] for f in dm.DIFF_FIELDS),
                        em.int(), ls, nl, k)
    _close(got, want)
    assert (recs[..., 0] < 0).any() or case == "bench_box"  # misses in the open scene
    assert float(want[0].abs().max()) > 0


# name -> (rays, depth, materials, point lights, emitter draws, emitter rows)
SYNTHETIC = {
    "box_like": (512, 6, 3, 0, 2, 2),
    "one_draw": (512, 6, 3, 0, 1, 2),
    "lights_only": (512, 5, 4, 2, 0, 0),
    "lights_and_draws": (384, 7, 6, 3, 2, 5),
    "many_materials": (768, 4, 40, 1, 1, 12),
    "one_depth": (100, 1, 2, 0, 1, 1),
}


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
@pytest.mark.parametrize("signed", [True, False])
def test_twin_matches_autograd_on_synthetic_records(name, signed):
    n, depth, n_mat, nl, k, n_em = SYNTHETIC[name]
    recs, mats, em, ls = synthetic_records(n, depth, n_mat, nl, k, n_em, seed=len(name))
    sel = recs[..., 2]
    hit = recs[..., 0] >= 0
    assert ((recs[..., 0] < 0) & (sel == 0)).any() and (hit & (sel == 0)).any()
    assert all((hit & (sel == c)).any() for c in (1, 2, 3))
    g = _grad_out(n, 7, signed)
    want = _autograd_vjp(mats, recs, em, ls, nl, k, g)
    planes = recs.permute(0, 2, 1).contiguous()
    got = dm.replay_vjp_reference(planes, g, *(mats[f] for f in dm.DIFF_FIELDS), em, ls, nl, k)
    _close(got, want)
    for t in got:
        assert (t[:, 3] == 0).all()


def test_misses_and_dead_rows_add_nothing():
    """Rows of mid -1 (misses, and every depth after a path ends) neither
    add a term nor advance the chain: all-miss records give zero
    gradients, and appending miss depths changes no bit."""
    recs, mats, em, ls = synthetic_records(256, 4, 3, 1, 2, 2, seed=11)
    g = _grad_out(256, 5)
    tables = [mats[f] for f in dm.DIFF_FIELDS]
    dead = recs.clone()
    dead[..., 0] = -1.0
    dead[..., 1:] = 0.0
    for t in dm.replay_vjp_reference(dead.permute(0, 2, 1), g, *tables, em, ls, 1, 2):
        assert (t == 0).all()
    longer = torch.cat([recs, dead[:2]])
    a = dm.replay_vjp_reference(recs.permute(0, 2, 1), g, *tables, em, ls, 1, 2)
    b = dm.replay_vjp_reference(longer.permute(0, 2, 1), g, *tables, em, ls, 1, 2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _scene_and_rays(name, n=512):
    from cpupathtrace_tpu_torch.models import golden, scenes

    o, d = make_rays("sphere_dirs", n, seed=4)
    rays = Rays(torch.from_numpy(o), torch.from_numpy(d))
    if name == "box":
        return scenes.bench_box_scene(device="cpu"), rays
    return golden.specular_box_scene(point_light=True, device="cpu"), rays


@pytest.mark.parametrize("name,depth", [("box", 4), ("box", 9), ("specular", 6), ("box", 40)])
def test_trace_diff_gradient_matches_the_replaced_path(name, depth):
    """trace_diff's CPU gradient (the twin) against the parent's backward:
    `replay_fast` over `preprocess_records` under autograd, on the same
    records (rtol 1e-5 of each gradient's largest entry)."""
    import dataclasses

    scene, rays = _scene_and_rays(name)
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=depth)
    g = _grad_out(rays.origin.shape[0], 9)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True) for f in dm.DIFF_FIELDS}
    spec, _ = dm.trace_diff(dataclasses.replace(scene, **leaves), rays, opts, 17)
    spec.backward(g)
    got = [leaves[f].grad for f in dm.DIFF_FIELDS]

    _, _, recs = dm.trace_megakernel_diff(scene, rays, opts, 17)
    em, ls, nl, k = _scene_args(scene)
    pre = dm.preprocess_records(recs, em, ls, scene.num_materials, nl, k)
    old = [getattr(scene, f).detach().clone().requires_grad_(True) for f in dm.DIFF_FIELDS]
    rgb = dm.replay_fast(dict(zip(dm.DIFF_FIELDS, old)), pre)
    want = torch.autograd.grad(rgb, old, g[:, :3], allow_unused=True)
    want = [torch.zeros_like(x) if w is None else w for w, x in zip(want, old)]
    _close(got, want)
    assert float(got[0].abs().max()) > 0


def test_record_pass_stops_where_no_ray_is_alive():
    """`record_pass` leaves the depths past the last live ray unwritten and
    says where it stopped; `trace_megakernel_diff` gives the same records
    there, and the no-contribution encoding past it."""
    scene, rays = _scene_and_rays("box")
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    spec, coll, planes, depth = dm.record_pass(scene, rays, opts, 17)
    assert 1 <= depth < 40 and planes.shape == (40, 7, 512)
    spec_t, coll_t, recs = dm.trace_megakernel_diff(scene, rays, opts, 17)
    assert torch.equal(spec, spec_t) and torch.equal(coll, coll_t)
    assert torch.equal(recs[:depth], planes[:depth].permute(0, 2, 1))
    assert (recs[depth:, :, 0] == -1).all() and (recs[depth:, :, 1:] == 0).all()


def test_trace_diff_saves_only_the_depths_reached(monkeypatch):
    """The backward gets the planes of the depths the forward's loop
    reached, contiguous as K2 wrote them, and nothing past them."""
    import dataclasses

    scene, rays = _scene_and_rays("box")
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    depth = dm.record_pass(scene, rays, opts, 17)[3]
    seen = []
    real = dm.replay_vjp
    monkeypatch.setattr(dm, "replay_vjp", lambda planes, *a: seen.append(planes) or
                        real(planes, *a))
    leaves = {f: getattr(scene, f).clone().requires_grad_(True) for f in dm.DIFF_FIELDS}
    spec, _ = dm.trace_diff(dataclasses.replace(scene, **leaves), rays, opts, 17)
    spec.backward(_grad_out(512, 9))
    assert len(seen) == 1 and seen[0].shape == (depth, 7, 512) and seen[0].is_contiguous()


def test_replay_vjp_on_the_cpu_takes_the_twin_and_counts_no_launch():
    recs, mats, em, ls = synthetic_records(64, 3, 3, 0, 2, 2, seed=2)
    calls, launches = dm.replay_vjp_reference.calls, dm.replay_vjp.launches
    dm.replay_vjp(recs.permute(0, 2, 1), _grad_out(64, 1), *(mats[f] for f in dm.DIFF_FIELDS),
                  em, ls, 0, 2)
    assert dm.replay_vjp_reference.calls == calls + 1 and dm.replay_vjp.launches == launches


def test_replay_vjp_refuses_planes_or_lights_of_another_shape():
    """The shapes are checked on every device: a light table with a padding
    row (the scenes keep one where they have no light) is refused."""
    recs, mats, em, ls = synthetic_records(8, 2, 3, 0, 2, 2, seed=3)
    tables = [mats[f] for f in dm.DIFF_FIELDS]
    g = _grad_out(8, 1)
    with pytest.raises(ValueError, match="light_spec"):
        dm.replay_vjp(recs.permute(0, 2, 1), g, *tables, em, torch.zeros((1, 3)), 0, 2)
    with pytest.raises(ValueError, match="planes"):
        dm.replay_vjp(recs.permute(0, 2, 1), g, *tables, em, ls, 0, 1)


def test_replay_vjp_refuses_a_device_without_a_kernel():
    recs, mats, em, ls = synthetic_records(8, 2, 3, 0, 1, 2, seed=3)
    meta = [t.to("meta") for t in (recs.permute(0, 2, 1), _grad_out(8, 1))]
    with pytest.raises(ValueError, match="no kernel for device"):
        dm.replay_vjp(*meta, *(mats[f].to("meta") for f in dm.DIFF_FIELDS), em.to("meta"),
                      ls.to("meta"), 0, 1)
