"""The port's wavefront `trace` (cpupathtrace_tpu_torch/integrator/wavefront.py)
against the JAX `trace`, per ray, on the same jax.random draws (handed to
the port as a RecordedDraws), in both forms: the forward while loop and the
fixed-length differentiable form. Also the film's dispatch to it
(PTX_NO_MEGAKERNEL=1) and its K5 routing.

Bounds. Without emitter NEE ("_no_em": the scene with
emissive_sample_count 0) the two agree on every ray to float32 rounding
(rtol 1e-4, atol 1e-6; measured max 6.6e-5 absolute at depth 6). With
emitter NEE the shadow ray toward a sample on the emitter triangle meets
that triangle at t = dist - eps, its own t_max, and whether it counts as
occluded is decided by the last bit (ROADMAP Queue 3); XLA:CPU's FMAs
move that bit, so a share of rays differs (each of the K = 2 emitter
samples of each of the 4 vertices is such a coin; about 10% of rays
differ after one bounce) while the mean radiance agrees within 1% (the
share bounds below sit under the measured values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.core.config import RenderOptions as JOptions
from cpupathtrace_tpu.core.rays import Rays as JRays
from cpupathtrace_tpu.integrator.wavefront import trace as jtrace
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import wavefront
from cpupathtrace_tpu_torch.integrator.rng import RecordedDraws
from tests.torch_util import build_scene, jax_trace_draws, make_rays

DEPTH = 4
N = 2048
# (scene, differentiable) -> share of rays within (rtol 1e-4, atol 1e-6);
# measured in the comments.
CASES = {
    ("inward_box", False): 0.40,  # 0.442
    ("inward_box", True): 0.40,  # 0.442
    ("specular_point_light", False): 0.45,  # 0.512
    ("specular_point_light_no_em", True): 1.0,  # 1.0
    ("inward_box_no_em", False): 1.0,  # 1.0
}


def _run_both(name, differentiable, depth=DEPTH):
    js, ps = build_scene(name, "jax"), build_scene(name, "port")
    o, d = make_rays("sphere_dirs", N, seed=3)
    key = jax.random.PRNGKey(5)
    ref, coll_ref = jtrace(js, JRays(jnp.asarray(o), jnp.asarray(d)),
                           JOptions(8, 8, 1, 1, max_depth=depth), key, differentiable)
    draws = RecordedDraws(jax_trace_draws(key, N, ps.emissive_sample_count, depth))
    ours, coll = wavefront.trace(ps, Rays(torch.from_numpy(o), torch.from_numpy(d)),
                                 RenderOptions(8, 8, 1, 1, max_depth=depth), draws,
                                 differentiable)
    return np.asarray(ref), np.asarray(coll_ref), ours.detach().numpy(), coll.numpy(), draws


@pytest.mark.parametrize("name,differentiable", sorted(CASES))
def test_trace_matches_jax_per_ray(name, differentiable):
    ref, coll_ref, ours, coll, draws = _run_both(name, differentiable)
    np.testing.assert_array_equal(coll, coll_ref)
    close = np.isclose(ours, ref, rtol=1e-4, atol=1e-6).all(axis=1).mean()
    assert close >= CASES[(name, differentiable)], close
    a, b = float(ours[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= 0.01 * b, (a, b)
    if differentiable:
        assert draws.pos == len(draws.arrays)  # every bounce of the scan ran


def test_forward_stops_when_every_ray_is_dead():
    """The while form leaves the loop once no ray is alive: an open scene
    where every ray misses draws one bounce only."""
    from cpupathtrace_tpu_torch.scene.geometry import make_plane
    from cpupathtrace_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    b.add_triangles(make_plane((-1, -1, 5), (1, 1, 5)))
    scene = b.build(device="cpu")
    o = torch.zeros((16, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(16, 1)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state()
    spec, coll = wavefront.trace(scene, Rays(o, d), RenderOptions(4, 4, max_depth=8), gen)
    assert not coll.any() and (spec == 0).all()
    gen2 = torch.Generator().manual_seed(0)
    torch.rand(16, generator=gen2)
    torch.rand((16, 3), generator=gen2)
    assert torch.equal(gen.get_state(), gen2.get_state()) and not torch.equal(state, gen.get_state())


def test_differentiable_trace_carries_material_gradients():
    """The graph reaches mat_diffuse and mat_emission; the masked-lane
    denominators are guarded, so the gradient is finite even where dead
    lanes carry a zero divisor."""
    import dataclasses

    scene = build_scene("inward_box", "port")
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in ("mat_diffuse", "mat_emission")}
    o, d = make_rays("sphere_dirs", 512, seed=4)
    spec, _ = wavefront.trace(dataclasses.replace(scene, **leaves),
                              Rays(torch.from_numpy(o), torch.from_numpy(d)),
                              RenderOptions(8, 8, max_depth=8), torch.Generator().manual_seed(1),
                              differentiable=True)
    spec[:, :3].mean().backward()
    for f, v in leaves.items():
        assert torch.isfinite(v.grad).all() and (v.grad.abs() > 0).any(), f


def test_render_dispatches_to_the_wavefront(monkeypatch):
    """PTX_NO_MEGAKERNEL=1: render() takes the wavefront (the JAX package's
    switch, film.py:74-86), whose intersections take K5's plain version on
    the CPU; unset, the megakernel's twin runs. Both estimate the same
    image: means within 5% at 8x8 @ 64 spp."""
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.models import golden
    from cpupathtrace_tpu_torch.ops import intersect

    scene = golden.inward_box_scene(device="cpu")
    cam = golden.box_camera(device="cpu")
    opts = pt.RenderOptions(8, 8, 64, 64, max_depth=12)
    monkeypatch.setenv("PTX_NO_MEGAKERNEL", "1")
    twin0, plain0 = mk.trace_megakernel_reference.calls, intersect.dense_intersect_reference.calls
    img = pt.render(scene, cam, opts, seed=1)
    assert mk.trace_megakernel_reference.calls == twin0
    assert intersect.dense_intersect_reference.calls > plain0
    monkeypatch.delenv("PTX_NO_MEGAKERNEL")
    ref = pt.render(scene, cam, opts, seed=1)
    assert mk.trace_megakernel_reference.calls > twin0
    assert (img[..., 3] == 1.0).all() and np.isfinite(img).all()
    a, b = float(img[..., :3].mean()), float(ref[..., :3].mean())
    assert abs(a - b) <= 0.05 * b, (a, b)
