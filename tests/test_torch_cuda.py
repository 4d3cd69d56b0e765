"""The port's CUDA kernel on the card: held against its plain-torch twin,
and the main path shown to go through it. Every test carries the `cuda`
marker and skips without a card. This file imports only the port (no jax,
no test helpers), so it also runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _require_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (runs on the H100)")


def _scene(name):
    import dataclasses

    from cpupathtrace_tpu_torch.models import golden, scenes

    if name == "box":
        return scenes.bench_box_scene(device="cuda")
    if name == "sphere":
        return golden.sphere_point_light_scene(device="cuda")
    scene = golden.specular_box_scene(point_light=True, device="cuda")
    if name == "specular_no_em":
        scene = dataclasses.replace(scene, emissive_sample_count=0)
    return scene


def _rays(forward, n=8192, seed=0):
    from cpupathtrace_tpu_torch.core.rays import Rays

    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    if forward:
        d[:, 2] = np.abs(d[:, 2]) + 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(torch.zeros((n, 3), device="cuda"),
                torch.tensor(d, dtype=torch.float32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,depth", [("box", 3), ("box", 40), ("specular", 40), ("specular_no_em", 40),
                   ("sphere", 40)],
)
def test_kernel_matches_twin(name, depth):
    """chip_smoke.py's bounds: the kernel does the twin's float32 operations
    in the same order (--fmad=false) and measured bit-equal on an H100."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _scene(name)
    rays = _rays(forward=name == "sphere")
    opts = RenderOptions(8, 8, 1, 1, max_depth=depth)
    launches = mk.trace_megakernel.launches
    ours, coll = mk.trace_megakernel(scene, rays, opts, 1234)
    torch.cuda.synchronize()
    assert mk.trace_megakernel.launches == launches + 1
    twin, _ = mk.trace_megakernel_reference(scene, rays, opts, 1234)
    ours, twin = ours.cpu().numpy(), twin.cpu().numpy()
    np.testing.assert_array_equal(ours[:, 3], twin[:, 3])
    assert np.isclose(ours, twin, rtol=1e-5, atol=1e-7).all(axis=1).mean() >= 0.999
    assert coll.dtype == torch.bool and coll.device.type == "cuda"


@pytest.mark.cuda
def test_render_goes_through_the_kernel():
    _require_cuda()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.models import scenes

    mk.trace_megakernel.launches = 0
    mk.trace_megakernel_reference.calls = 0
    img = pt.render(scenes.bench_box_scene(), scenes.bench_camera(),
                    pt.RenderOptions(32, 32, 64, 64, max_depth=40), seed=0,
                    device="cuda")
    assert mk.trace_megakernel.launches > 0
    assert mk.trace_megakernel_reference.calls == 0
    assert np.isfinite(img).all() and (img[..., 3] == 1.0).all()


@pytest.mark.cuda
def test_wrapper_checks_its_inputs():
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _scene("box")
    bad = Rays(torch.zeros((8, 3), device="cuda", dtype=torch.float64),
               torch.zeros((8, 3), device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError):
        mk.trace_megakernel(scene, bad, RenderOptions(8, 8, 1, 1), 1)
    strided = torch.zeros((8, 6), device="cuda")[:, ::2]
    with pytest.raises(ValueError):
        mk.trace_megakernel(scene, Rays(strided, strided), RenderOptions(8, 8, 1, 1), 1)
