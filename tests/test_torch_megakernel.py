"""The dense megakernel's torch twin against the JAX megakernel, per ray,
on one 8192-ray block, and the wrapper's routing.

The JAX side runs in Pallas interpret mode (~35 s of compile per case on
the CPU), so tier-1 compares with its committed outputs
(tests/fixtures/torch_megakernel.npz, regenerated by
tests/fixtures/make_torch_megakernel_fixtures.py) and the live comparison
is marked slow. The CUDA kernel is held against the twin on the card by
tests/test_torch_cuda.py and chip_smoke.py.

Bounds, per case:
  * `collected` exactly equal on every ray;
  * the mean radiance within 0.5%;
  * per ray, the spectrum within (rtol, atol) on at least `frac` of rays.
Why `frac` is below 1 where emitter triangles are sampled: the shadow ray
of emitter NEE starts eps along its direction and is tested against the
emitter's own triangle with t_lim = dist - eps, which is exactly where it
meets that triangle, so whether it counts as occluded is decided by the
last bit of the arithmetic. XLA:CPU fuses a*b+c into FMAs (it always
allows FMA contraction) and the twin does not, so a few per cent of those
coin flips land differently. Without emitter NEE ("specular_no_em") and
without emitter triangles ("sphere") the agreement is exact.
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import megakernel
from tests.torch_util import (
    CPU,
    MEGAKERNEL_CASES,
    build_scene,
    jax_megakernel,
    make_rays,
    port_megakernel,
)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures", "torch_megakernel.npz")

# case -> (rtol, atol, frac); measured fractions in the comments.
BOUNDS = {
    "box": (1e-3, 1e-5, 0.95),  # 0.960
    "specular": (0.1, 1e-5, 0.99),  # 0.994; 0.686 at rtol 1e-3
    "specular_no_em": (1e-4, 1e-6, 0.999),  # 1.000
    "sphere": (1e-4, 1e-6, 0.999),  # 1.000
}


def _check(ours, ref, case):
    rtol, atol, frac = BOUNDS[case]
    np.testing.assert_array_equal(ours[:, 3], ref[:, 3])
    a, b = float(ours[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= 0.005 * abs(b), (case, a, b)
    close = np.isclose(ours, ref, rtol=rtol, atol=atol).all(axis=1).mean()
    assert close >= frac, (case, close)


@pytest.mark.parametrize("case", sorted(MEGAKERNEL_CASES))
def test_twin_matches_jax_kernel_outputs(case):
    ref = np.load(FIXTURES)[case]
    _check(port_megakernel(case), ref, case)


@pytest.mark.slow
@pytest.mark.parametrize("case", sorted(MEGAKERNEL_CASES))
def test_twin_matches_live_jax_kernel(case):
    _check(port_megakernel(case), jax_megakernel(case), case)


def _box_rays(n=1024):
    o, d = make_rays("sphere_dirs", n=n, seed=3)
    return Rays(torch.from_numpy(o), torch.from_numpy(d))


def test_twin_deterministic_and_seeded():
    scene = build_scene("bench_box", "port")
    rays = _box_rays()
    opts = RenderOptions(8, 8, 1, 1, max_depth=6)
    ref = megakernel.trace_megakernel_reference
    a, ca = ref(scene, rays, opts, 7)
    b, _ = ref(scene, rays, opts, 7)
    c, _ = ref(scene, rays, opts, torch.tensor([8], dtype=torch.int32))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert a.shape == (1024, 4) and ca.dtype == torch.bool
    assert torch.isfinite(a).all() and bool(ca.all())  # closed box


def test_wrapper_routes_cpu_to_twin_and_counts():
    scene = build_scene("bench_box", "port")
    calls = megakernel.trace_megakernel_reference.calls
    launches = megakernel.trace_megakernel.launches
    spec, coll = megakernel.trace_megakernel(
        scene, _box_rays(256), RenderOptions(8, 8, 1, 1, max_depth=3), 1
    )
    assert megakernel.trace_megakernel_reference.calls == calls + 1
    assert megakernel.trace_megakernel.launches == launches
    assert spec.shape == (256, 4) and coll.shape == (256,)


def test_wrapper_raises_without_a_kernel_for_the_device():
    scene = build_scene("bench_box", "port")
    rays = Rays(torch.zeros((8, 3), device="meta"), torch.zeros((8, 3), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        megakernel.trace_megakernel(scene, rays, RenderOptions(8, 8, 1, 1), 1)


def test_supported_limits():
    from cpupathtrace_tpu_torch.scene.scene import SceneBuilder

    assert megakernel.megakernel_supported(build_scene("demo", "port"))
    b = SceneBuilder()
    for i in range(megakernel.MAX_SPH + 1):
        b.add_sphere((float(i), 0.0, 0.0), 0.1)
    assert not megakernel.megakernel_supported(b.build(device=CPU))

