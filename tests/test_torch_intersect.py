"""The wavefront's building blocks in the port against the JAX package, on
the same numpy inputs: the primitive tests, the dense query K5's plain
version (against the jnp `dense_intersect` and against the Pallas kernel
`_dense_pallas_call` in interpret mode), `scene_intersect`'s qualifiers,
surface normals and sampling, the BSDFs, light sampling, the colour
helpers and the PTX_DEBUG checks. The CUDA kernel K5 is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.bsdf import bsdf as jbsdf
from cpupathtrace_tpu.ops import intersect as jis
from cpupathtrace_tpu.ops import surface as jsurf
from cpupathtrace_tpu.ops.pallas_intersect import dense_intersect_pallas
from cpupathtrace_tpu.scene import lights as jlights
from cpupathtrace_tpu.utils import color as jcolor
from cpupathtrace_tpu_torch.bsdf import bsdf as tbsdf
from cpupathtrace_tpu_torch.core import debug
from cpupathtrace_tpu_torch.ops import intersect as tis
from cpupathtrace_tpu_torch.ops import surface as tsurf
from cpupathtrace_tpu_torch.scene import lights as tlights
from cpupathtrace_tpu_torch.utils import color as tcolor
from tests.torch_util import build_scene, dragon_scene, pallas_interpret

SCENES = ["bench_box", "specular", "sphere_point_light"]


def _rays(n, seed, inside=True):
    """Rays in the box: origins uniform in [-0.9, 0.9]^3 (or the origin),
    uniform directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32) if inside else np.zeros((n, 3), np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("name", SCENES)
def test_dense_plain_matches_jnp_dense_intersect(name):
    """K5's plain version against the jnp version: prim equal on every ray
    and t within rtol 1e-5 where both hit. The two compute the same
    Moller-Trumbore and near-root tests; XLA:CPU fuses some products into
    FMAs, which moves t by a few ulp (measured at most 1.2e-6 relative;
    the sphere's near root amplifies the last bit) and never flipped a hit
    or prim on these 8192 rays."""
    o, d = _rays(8192, 1)
    tj, pj = jis.dense_intersect(build_scene(name, "jax"), jnp.asarray(o), jnp.asarray(d))
    tt, pt = tis.dense_intersect(build_scene(name, "port"), _t(o), _t(d))
    tj, pj = np.asarray(tj), np.asarray(pj)
    np.testing.assert_array_equal(pt.numpy(), pj)
    hit = pj >= 0
    assert hit.sum() > 500
    np.testing.assert_allclose(tt.numpy()[hit], tj[hit], rtol=1e-5, atol=0)
    assert (tt.numpy()[~hit] == -1.0).all()


@pytest.mark.parametrize("name", ["bench_box", "specular"])
def test_dense_plain_matches_the_pallas_kernel(name):
    """Against `_dense_pallas_call` in interpret mode (the TPU kernel's own
    arithmetic, ~2 s per scene): prim equal on every ray, t within rtol
    1e-5 (measured at most 4.6e-6 relative, on 6 of 8192 rays: FMA-fused
    rounding in the interpreted kernel amplified by the sphere's near
    root)."""
    o, d = _rays(8192, 2, inside=False)
    with pallas_interpret():
        tj, pj = dense_intersect_pallas(build_scene(name, "jax"), jnp.asarray(o), jnp.asarray(d))
    tt, pt = tis.dense_intersect(build_scene(name, "port"), _t(o), _t(d))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-5, atol=0)


def test_dense_plain_tie_goes_to_the_lowest_row():
    """Two copies of one triangle: the first row wins (argmin's first
    index), as in the kernel, where a row wins only by strict
    improvement."""
    from cpupathtrace_tpu_torch.scene.geometry import make_plane
    from cpupathtrace_tpu_torch.scene.scene import SceneBuilder

    b = SceneBuilder()
    b.add_triangles(make_plane((-1, -1, 1), (1, 1, 1)))
    b.add_triangles(make_plane((-1, -1, 1), (1, 1, 1)))
    scene = b.build(device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.1, 0.1, 1.0], [-0.1, 0.2, 1.0], [0.3, -0.2, 1.0], [0.0, 0.0, -1.0]])
    d = d / d.norm(dim=1, keepdim=True)
    t, p = tis.dense_intersect(scene, o, d)
    assert (p[:3] < 2).all() and p[3] == -1 and t[3] == -1.0


def test_scene_intersect_t_max_and_routing():
    """t_max turns hits at t >= t_max into misses (ops/intersect.py:
    502-505); CPU rays take the plain version and launch nothing; a
    device without a kernel raises; a binned scene takes the binned
    wavefront (its plain version on the CPU) and raises nothing."""
    scene = build_scene("bench_box", "port")
    o, d = _rays(512, 3)
    o, d = _t(o), _t(d)
    t, p = tis.scene_intersect(scene, o, d)
    lim = t.clone()
    lim[::2] = lim[::2] * 0.5
    launches = tis.dense_intersect.launches
    calls = tis.dense_intersect_reference.calls
    tm, pm = tis.scene_intersect(scene, o, d, t_max=lim, any_hit=True)
    assert tis.dense_intersect.launches == launches
    assert tis.dense_intersect_reference.calls == calls + 1
    assert (pm[::2] == -1).all() and (tm[::2] == -1.0).all()
    assert (pm[1::2] == -1).all()  # t >= t_max at equality
    with pytest.raises(ValueError, match="no kernel"):
        tis.dense_intersect(scene, o.to("meta"), d.to("meta"))
    from cpupathtrace_tpu_torch.accel import traverse

    calls = traverse.candidates_reference.calls
    tb, pb = tis.scene_intersect(dragon_scene("port"), o, d)
    assert traverse.candidates_reference.calls > calls and (pb >= 0).all()


def test_primitive_tests_match_jax():
    """intersect_triangles / _spheres / _aabb / intersect_prim against the
    JAX functions on random broadcasts (rtol 1e-5: FMA fusion in XLA)."""
    rng = np.random.default_rng(4)
    o = rng.normal(size=(256, 1, 3)).astype(np.float32)
    d = rng.normal(size=(256, 1, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v = rng.normal(size=(3, 1, 16, 3)).astype(np.float32) * 2
    cull = rng.uniform(size=(1, 16)) < 0.5
    a = jis.intersect_triangles(o, d, v[0], v[1], v[2], cull)
    b = tis.intersect_triangles(_t(o), _t(d), _t(v[0]), _t(v[1]), _t(v[2]), _t(cull))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    c = rng.normal(size=(1, 16, 3)).astype(np.float32)
    r = rng.uniform(0.1, 1.0, (1, 16)).astype(np.float32)
    a = jis.intersect_spheres(o, d, c, r)
    b = tis.intersect_spheres(_t(o), _t(d), _t(c), _t(r))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    lo, hi = np.minimum(v[0], v[1]), np.maximum(v[0], v[1])
    a = jis.intersect_aabb(o, d, lo, hi)
    b = tis.intersect_aabb(_t(o), _t(d), _t(lo), _t(hi))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    js, ps = build_scene("specular", "jax"), build_scene("specular", "port")
    prim = rng.integers(0, ps.n_prims, 256)
    a = jis.intersect_prim(js, jnp.asarray(prim), o[:, 0], d[:, 0])
    b = tis.intersect_prim(ps, _t(prim), _t(o[:, 0]), _t(d[:, 0]))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)


def test_surface_queries_match_jax():
    js, ps = build_scene("specular", "jax"), build_scene("specular", "port")
    rng = np.random.default_rng(5)
    prim = rng.integers(0, ps.n_prims, 512)
    pos = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    a = jsurf.surface_normal(js, jnp.asarray(prim), jnp.asarray(pos))
    b = tsurf.surface_normal(ps, _t(prim), _t(pos))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-5)
    u1, u2 = rng.uniform(size=(2, 512)).astype(np.float32)
    ja = jsurf.sample_prim_surface(js, jnp.asarray(prim), jnp.asarray(u1), jnp.asarray(u2))
    tb = tsurf.sample_prim_surface(ps, _t(prim), _t(u1), _t(u2))
    for x, y in zip(ja, tb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-5)


def test_bsdf_matches_jax():
    """gather_material, propagate and eval_spectrum (both flavours) on all
    three BSDFs of the specular scene, same uniforms."""
    js, ps = build_scene("specular", "jax"), build_scene("specular", "port")
    rng = np.random.default_rng(6)
    n = 1024
    prim = rng.integers(0, ps.n_prims, n)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d, nrm = d.astype(np.float32), nrm.astype(np.float32)
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    u = rng.uniform(size=(n, 3)).astype(np.float32)
    jm = jbsdf.gather_material(js, jnp.asarray(prim))
    tm = tbsdf.gather_material(ps, _t(prim))
    for x, y in zip(jm, tm):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    ja = jbsdf.propagate(jm, jnp.asarray(d), jnp.asarray(pos), jnp.asarray(nrm), 1e-3, jnp.asarray(u))
    tb = tbsdf.propagate(tm, _t(d), _t(pos), _t(nrm), 1e-3, _t(u))
    for x, y in zip(ja, tb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4, atol=1e-5)
    spec = rng.uniform(size=(n, 4)).astype(np.float32)
    nd = tb[1]
    for synthetic in (False, True):
        ja = jbsdf.eval_spectrum(jm, jnp.asarray(d), jnp.asarray(nd.numpy()), jnp.asarray(nrm),
                                 jnp.asarray(spec), synthetic)
        tb = tbsdf.eval_spectrum(tm, _t(d), nd, _t(nrm), _t(spec), synthetic)
        for x, y in zip(ja, tb):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["bench_box", "specular_point_light"])
def test_sample_lights_matches_jax(name):
    """The light batch from the same uniforms: the JAX function draws
    uniform(key, (R, K, 3)); the port takes those uniforms. CDF rows by
    searchsorted(left) + clip, equal to jnp.searchsorted."""
    js, ps = build_scene(name, "jax"), build_scene(name, "port")
    rng = np.random.default_rng(7)
    pos = rng.uniform(-0.9, 0.9, (256, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    ja = jlights.sample_lights(js, jnp.asarray(pos), key)
    u = np.asarray(jax.random.uniform(key, (256, ps.emissive_sample_count, 3)))
    tb = tlights.sample_lights(ps, _t(pos), _t(u))
    assert tlights.num_light_samples(ps) == jlights.num_light_samples(js)
    for x, y in zip(ja, tb):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5, atol=1e-6)


def test_color_helpers_match_jax():
    c = np.random.default_rng(8).uniform(size=(64, 4)).astype(np.float32)
    for f in ("rgb_mean", "brightness", "brightness_heuristic"):
        np.testing.assert_allclose(getattr(tcolor, f)(_t(c)).numpy(),
                                   np.asarray(getattr(jcolor, f)(jnp.asarray(c))), rtol=1e-6)
    np.testing.assert_array_equal(tcolor.rgba(0.1, 0.2, 0.3, device="cpu").numpy(),
                                  np.asarray(jcolor.rgba(0.1, 0.2, 0.3)))


def test_debug_checks(monkeypatch):
    """No-ops without PTX_DEBUG; with PTX_DEBUG=1 the first failed check
    raises AssertionError (NaN fails the non-negative check)."""
    bad = torch.tensor([1.0, float("nan")])
    debug.check_non_negative(bad, "x")
    debug.check_finite(bad, "x")
    monkeypatch.setenv("PTX_DEBUG", "1")
    with pytest.raises(AssertionError, match="assertNonNegative"):
        debug.check_non_negative(bad, "x")
    with pytest.raises(AssertionError, match="assertFinite"):
        debug.check_finite(bad, "x")
    with pytest.raises(AssertionError, match="assertNormalized"):
        debug.check_normalized(torch.tensor([[1.0, 1.0, 0.0]]), "d")
    debug.check_normalized(torch.tensor([[0.0, 0.6, 0.8]]), "d")
