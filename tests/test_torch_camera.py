"""The port's camera (cpupathtrace_tpu_torch/camera/camera.py) against the
JAX camera: with the JAX draws injected as `uniforms`, shoot_rays gives
the same rays to 1e-6 for no aperture, circular, hexagonal and thin lens."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.camera import camera as jcam
from cpupathtrace_tpu_torch.camera import camera as tcam
from tests.torch_util import CPU

CAMERAS = {
    "pinhole": dict(origin=(0, 0, -3), look_at=(0, 0, 0), up=(0, 1, 0),
                    focal_length=1.0, height=1.0, aspect_ratio=-1.0),
    "circular": dict(origin=(0.0, 0.0, -3.0), look_at=(0.0, 0.0, 0.0),
                     up=(0.0, 1.0, 0.0), aspect_ratio=-1.0,
                     aperture_width=0.05, aperture_height=0.05,
                     aperture=jcam.APERTURE_CIRCULAR),
    "thin_lens": dict(origin=(0.0, 0.0, -3.0), look_at=(0.0, 0.0, 0.0),
                      up=(0.0, 1.0, 0.0), aspect_ratio=-1.0,
                      aperture_width=0.05, aperture_height=0.05,
                      aperture=jcam.APERTURE_CIRCULAR, focal_plane_dist=3.5),
    "hexagonal": dict(origin=(0, 0, 0), look_at=(0, 0, 0.9), up=(0, 1, 0),
                      aperture_width=0.12, aperture_height=0.12,
                      aperture=jcam.APERTURE_HEXAGONAL,
                      hex_horizontal_ratio=0.6, focal_plane_dist=1.5),
}


def _jax_draws(key, n, aperture):
    """The draws JAX shoot_rays makes from `key` (camera.py:101-144)."""
    k_jit, k_ap = jax.random.split(key)
    u = {"jitter": np.asarray(
        jax.random.uniform(k_jit, (n, 2), minval=-0.5, maxval=0.5))}
    if aperture == jcam.APERTURE_CIRCULAR:
        u["aperture"] = np.asarray(jax.random.uniform(k_ap, (n, 2)))
    elif aperture == jcam.APERTURE_HEXAGONAL:
        k_xy, k_flip = jax.random.split(k_ap)
        u["hex"] = np.asarray(jax.random.uniform(k_xy, (n, jcam._HEX_ROUNDS, 2)))
        u["flips"] = np.asarray(jax.random.bernoulli(k_flip, 0.5, (n, 2)))
    return {k: torch.from_numpy(np.array(v)) for k, v in u.items()}


def test_make_camera_matches_jax():
    for kw in CAMERAS.values():
        a = jcam.make_camera(**kw)
        b = tcam.make_camera(**kw, device=CPU)
        for f in ("origin", "forward", "up", "right"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)))
        for f in ("aperture_width_half", "aperture_height_half",
                  "hex_horizontal_ratio", "focal_plane_dist"):
            assert getattr(b, f) == float(getattr(a, f)), f
        assert b.aperture == a.aperture


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_shoot_rays_matches_jax(name):
    kw = CAMERAS[name]
    rng = np.random.default_rng(3)
    n = 4096
    x = rng.uniform(-1, 1, n).astype(np.float32)
    y = rng.uniform(-1, 1, n).astype(np.float32)
    key = jax.random.PRNGKey(11)
    cam_j = jcam.make_camera(**kw)
    rays_j = jcam.shoot_rays(cam_j, jnp.asarray(x), jnp.asarray(y), 1 / 32, 1 / 24, key)
    cam_t = tcam.make_camera(**kw, device=CPU)
    rays_t = tcam.shoot_rays(
        cam_t, torch.from_numpy(x), torch.from_numpy(y), 1 / 32, 1 / 24,
        uniforms=_jax_draws(key, n, cam_j.aperture),
    )
    np.testing.assert_allclose(
        rays_t.origin.numpy(), np.asarray(rays_j.origin), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        rays_t.direction.numpy(), np.asarray(rays_j.direction), rtol=0, atol=1e-6)


def test_shoot_rays_draws_from_generator():
    cam = tcam.make_camera(**CAMERAS["hexagonal"], device=CPU)
    x = torch.linspace(-1, 1, 512)
    g1 = torch.Generator().manual_seed(4)
    g2 = torch.Generator().manual_seed(4)
    a = tcam.shoot_rays(cam, x, x, 0.01, 0.01, g1)
    b = tcam.shoot_rays(cam, x, x, 0.01, 0.01, g2)
    assert torch.equal(a.direction, b.direction)
    assert torch.allclose(a.direction.norm(dim=1), torch.ones(512), atol=1e-6)
    c = tcam.shoot_rays(cam, x, x, 0.01, 0.01, g1)
    assert not torch.equal(a.direction, c.direction)
