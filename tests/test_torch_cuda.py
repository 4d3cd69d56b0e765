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


# ---------------------------------------------------------------------------
# Binned scenes: the bounce kernel K2 and the cluster query K4.
# ---------------------------------------------------------------------------


def _dragon(tris=20000):
    from cpupathtrace_tpu_torch.models import scenes

    return scenes.bench_dragon_scene(dragon_tris=tris, device="cuda")


def _query_rays(n=8192, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.95, 0.95, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32, device="cuda"),
            torch.tensor(d, dtype=torch.float32, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_query_matches_plain(any_hit):
    """K4 against the plain traversal on the same rays: chip_smoke.py's
    bounds (hit mask and prim on >= 99.9% of rays, t within rtol 1e-6
    where both hit); they do the same float32 pair test per record."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    scene = _dragon()
    o, d = _query_rays()
    lim = torch.rand(o.shape[0], device="cuda") * 1.5 + 0.05 if any_hit else None
    launches = kt.cluster_intersect.launches
    t, p = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit)
    torch.cuda.synchronize()
    assert kt.cluster_intersect.launches == launches + 1
    tp, pp = kt.cluster_intersect_reference(scene, o, d, lim, any_hit=any_hit)
    assert ((p >= 0) == (pp >= 0)).float().mean() >= 0.999
    assert (p == pp).float().mean() >= 0.999
    both = (p >= 0) & (pp >= 0)
    assert int(both.sum()) > 100
    assert torch.allclose(t[both], tp[both], rtol=1e-6, atol=0.0)


def _camera_state(scene, n=16384, seed=77):
    from cpupathtrace_tpu_torch.camera.camera import shoot_rays
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import scenes

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.rand(n, generator=gen, device="cuda") * 2.0 - 1.0
    y = torch.rand(n, generator=gen, device="cuda") * 2.0 - 1.0
    r = shoot_rays(scenes.bench_camera(device="cuda"), x, y, 1 / 128, 1 / 128, gen)
    return sw.initial_state(r.origin, r.direction, seed)


@pytest.mark.cuda
def test_bounce_matches_twin_per_plane():
    """K2 against its twin from the same state at depths 0 and 5: every one
    of the 18 planes equal on >= 99.9% of rays (measured bit-equal on an
    H100: the same body, --fmad=false)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _dragon()
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    tables = mk.pack_tables(scene)
    st = _camera_state(scene)
    for depth in (0, 5):
        k, t = st.clone(), st.clone()
        sw.bounce(scene, k, torch.tensor([77, depth], dtype=torch.int32, device="cuda"),
                  opts, tables)
        sw.bounce_reference(scene, t, depth, opts, tables)
        same = (k.view(torch.int32) == t.view(torch.int32)).float().mean(1)
        assert (same >= 0.999).all(), (depth, same.tolist())
        st = k


@pytest.mark.cuda
def test_bounce_kernel_sorted_equals_unsorted():
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _dragon()
    st = _camera_state(scene)
    rays = Rays(st[1:4].t().contiguous(), st[4:7].t().contiguous())
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    a, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5)
    b, _ = sw.trace_megakernel_sorted(scene, rays, opts, 5, sort=False)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_binned_render_goes_through_the_bounce_kernel():
    _require_cuda()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import scenes

    scene = _dragon()
    sw.bounce.launches = 0
    sw.bounce_reference.calls = 0
    img = pt.render(scene, scenes.bench_camera(), pt.RenderOptions(32, 32, 16, 16, max_depth=40),
                    seed=0, device="cuda")
    assert sw.bounce.launches > 0 and sw.bounce_reference.calls == 0
    assert np.isfinite(img).all() and (img[..., 3] == 1.0).all()


@pytest.mark.cuda
def test_bounce_and_query_wrappers_check_their_inputs():
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _dragon(6000)
    sd = torch.zeros(2, dtype=torch.int32, device="cuda")
    opts = RenderOptions(8, 8, 1, 1)
    with pytest.raises(ValueError):
        sw.bounce(scene, torch.zeros((17, 64), device="cuda"), sd, opts)
    with pytest.raises(ValueError):
        sw.bounce(scene, torch.zeros((18, 64), device="cuda", dtype=torch.float64), sd, opts)
    with pytest.raises(ValueError):
        sw.bounce(scene, torch.zeros((18, 64), device="cuda"), sd.long(), opts)
    o = torch.zeros((8, 3), device="cuda")
    with pytest.raises(ValueError):
        kt.cluster_intersect(scene, o.double(), o.double())
    with pytest.raises(ValueError):
        kt.cluster_intersect(scene, torch.zeros((8, 6), device="cuda")[:, ::2], o)


# ---------------------------------------------------------------------------
# The gradient path: the dense query K5, K2's record form, gradients.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "specular", "sphere"])
def test_dense_query_matches_plain(name):
    """K5 against its plain version: prim, hit and t equal on every ray
    (the same tests in the same order, --fmad=false)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.ops import intersect as oi

    scene = _scene(name)
    o, d = _query_rays(16384, seed=3)
    launches = oi.dense_intersect.launches
    t, p = oi.dense_intersect(scene, o, d)
    torch.cuda.synchronize()
    assert oi.dense_intersect.launches == launches + 1
    tp, pp = oi.dense_intersect_reference(scene, o, d)
    assert torch.equal(p, pp) and torch.equal(t, tp)
    assert int((p >= 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "dragon"])
def test_bounce_records_match_twin(name):
    """K2's record form against its twin from the same state at depths 0
    and 5: the 18 planes and the record planes of live rays bit-equal, and
    the recording forward bit-equal to the plain kernel."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _scene("box") if name == "box" else _dragon()
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    tables = mk.pack_tables(scene)
    st = _camera_state(scene)
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    for depth in (0, 5):
        k, t, plain = st.clone(), st.clone(), st.clone()
        rk = torch.empty((nd, st.shape[1]), device="cuda")
        rt = torch.empty_like(rk)
        sd = torch.tensor([77, depth], dtype=torch.int32, device="cuda")
        sw.bounce(scene, k, sd, opts, tables, records=rk)
        sw.bounce(scene, plain, sd, opts, tables)
        sw.bounce_reference(scene, t, depth, opts, tables, records=rt)
        live = st[17] > 0.5
        assert torch.equal(k.view(torch.int32), t.view(torch.int32)), depth
        assert torch.equal(k.view(torch.int32), plain.view(torch.int32)), depth
        assert torch.equal(rk[:, live].view(torch.int32), rt[:, live].view(torch.int32)), depth
        assert (rk[0, ~live] == -1).all() and (rk[1:, ~live] == 0).all()
        st = k


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["1", "0"])
def test_gradient_matches_finite_difference_on_the_card(route, monkeypatch):
    """Both routes (PTX_DIFF_MEGAKERNEL=1: K2 records + replay; 0: the
    wavefront + K5) against a central difference at 16x16 @ 8 spp,
    max_depth 4: test_diff.py:66's rtol 0.05, atol 1e-4."""
    _require_cuda()
    from cpupathtrace_tpu_torch import diff
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import golden
    from cpupathtrace_tpu_torch.ops import intersect as oi

    monkeypatch.setenv("PTX_DIFF_MEGAKERNEL", route)
    scene, cam = golden.inward_box_scene(device="cuda"), golden.box_camera(device="cuda")
    opts = RenderOptions(16, 16, 8, 8, max_depth=4)
    target = diff.render_image_diff(scene, cam, opts, 99, 8).detach()
    params = diff.get_material_params(scene)
    k2, k5 = sw.bounce.record_launches, oi.dense_intersect.launches
    _, g = diff.loss_and_grad(params, scene, cam, opts, target, 0, 8)
    if route == "1":
        assert sw.bounce.record_launches > k2
    else:
        assert oi.dense_intersect.launches > k5
    for field, idx in (("mat_diffuse", (1, 0)), ("mat_emission", (2, 1))):
        fd = diff.finite_difference_grad(params, scene, cam, opts, target, 0, 8, field, idx,
                                         eps=2e-3)
        np.testing.assert_allclose(float(g[field][idx]), fd, rtol=0.05, atol=1e-4)


# ---------------------------------------------------------------------------
# The binned wavefront: the candidate scan K6, the cluster-major intersect
# K7, and K8's entry point through K7's kernel.
# ---------------------------------------------------------------------------


def _first_round(scene, o, d, m=4):
    """K6's ray planes of a first round, and K6's output."""
    from cpupathtrace_tpu_torch.accel import traverse as tt

    t0, _ = tt._dense_part(scene, o, d, tt.binned_tables(scene))
    ninf = torch.full_like(t0, float("-inf"))
    rays = tt.pack_rays(o, d, t0, ninf, ninf)
    return rays, tt.candidates(scene.trv_bounds, rays, m)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_binned_kernels_match_plain(m):
    """K6 and K7 equal to their plain versions bit for bit (chip_smoke.py
    phase 16's bound): the same float32 operations in the same order."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    scene = _dragon()
    o, d = _query_rays()
    k6, k7 = tt.candidates.launches, tt.isect.launches
    rays, (ids, ent) = _first_round(scene, o, d, m)
    torch.cuda.synchronize()
    ip, ep = tt.candidates_reference(scene.trv_bounds, rays, m)
    assert torch.equal(ids, ip) and torch.equal(ent.view(torch.int32), ep.view(torch.int32))
    pairs, offs, _ = tt.bin_pairs(rays, ids, scene.trv_bounds.shape[0], m)
    t, p = tt.isect(scene.trv_blocks, pairs, offs)
    torch.cuda.synchronize()
    tp, pp = tt.isect_reference(scene.trv_blocks, pairs, offs)
    assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert int((p >= 0).sum()) > 100
    assert tt.candidates.launches == k6 + 1 and tt.isect.launches == k7 + 1


@pytest.mark.cuda
def test_binned_intersect_matches_its_oracle_on_the_card():
    """The pipeline (K6, K7, K5) against the dense part + sweep oracle:
    prim on every ray; any-hit occlusion on every live ray."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    scene = _dragon()
    o, d = _query_rays(seed=3)
    t, p = tt.binned_intersect(scene, o, d)
    tr, pr = tt.binned_intersect_ref(scene, o, d)
    assert torch.equal(p, pr) and torch.equal(t, tr)
    lim = torch.rand(o.shape[0], device="cuda") * 1.5 + 0.05
    live = torch.rand(o.shape[0], device="cuda") < 0.5
    ta, pa = tt.binned_intersect(scene, o, d, t_max=lim, live=live, any_hit=True)
    _, par = tt.binned_intersect_ref(scene, o, d, t_max=lim)
    assert torch.equal((pa >= 0)[live], (par >= 0)[live])


@pytest.mark.cuda
def test_cluster_major_stage_matches_plain():
    """K8's compute stage (K7's kernel on the binned pairs) against its
    plain version, slot for slot."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm, traverse as tt

    scene = _dragon()
    o, d = _query_rays(seed=4)
    blocks = cm.cluster_blocks(scene)
    ids, _ = binned.generate_candidates(scene, o, d, 4)
    launches = tt.isect.launches
    t, p = cm.test_candidates(blocks, o, d, ids)
    torch.cuda.synchronize()
    assert tt.isect.launches == launches + 1
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
def test_binned_wavefront_render_goes_through_k6_k7(monkeypatch):
    """render() of a binned scene with PTX_NO_MEGAKERNEL=1 launches K6, K7
    and K5 and no plain version."""
    _require_cuda()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.accel import traverse as tt
    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.ops import intersect as oi

    monkeypatch.setenv("PTX_NO_MEGAKERNEL", "1")
    scene = _dragon()
    before = (tt.candidates.launches, tt.isect.launches, oi.dense_intersect.launches,
              tt.candidates_reference.calls, tt.isect_reference.calls)
    img = pt.render(scene, scenes.bench_camera(), pt.RenderOptions(32, 32, 4, 4, max_depth=8),
                    seed=1, device="cuda")
    after = (tt.candidates.launches, tt.isect.launches, oi.dense_intersect.launches,
             tt.candidates_reference.calls, tt.isect_reference.calls)
    assert all(a > b for a, b in zip(after[:3], before[:3])) and after[3:] == before[3:]
    assert np.isfinite(img).all() and (img[..., 3] == 1.0).all()


@pytest.mark.cuda
def test_isect_streams_clusters_larger_than_a_tile():
    """Clusters of 3,584 triangles (the 7.2M dragon's size class, ~225 KB
    each: more than a block's shared memory) stream through K7's 256-row
    tiles; the pairs of each cluster are masked to its range. Equal to the
    plain version bit for bit."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    rng = np.random.default_rng(8)
    c, l, n = 3, 3584, 1500
    v0 = rng.uniform(-1, 1, (c, l, 3))
    v1 = v0 + rng.normal(scale=0.05, size=(c, l, 3))
    v2 = v0 + rng.normal(scale=0.05, size=(c, l, 3))
    prim = np.arange(c * l).reshape(c, l)
    prim[:, -37:] = -1  # padding rows at the end
    blocks = tt.pack_blocks(v0, v1, v2, rng.random((c, l)) < 0.5, prim)
    blocks = torch.tensor(blocks, device="cuda")
    o = rng.uniform(-1, 1, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.tensor(np.ascontiguousarray(np.concatenate([o.T, d.T])), dtype=torch.float32,
                        device="cuda")
    offs = torch.tensor([0, 400, 1100, 1450], dtype=torch.int32, device="cuda")
    t, p = tt.isect(blocks, rays, offs)
    torch.cuda.synchronize()
    tp, pp = tt.isect_reference(blocks, rays, offs)
    assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert int((p >= 0).sum()) > 50 and bool((p[1450:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("accel", ["sweep", "cluster", "bvh"])
def test_walkers_on_the_card(accel):
    """The torch walkers on CUDA tensors: the same prim as the dense query
    K5 of the same scene on every ray but where two triangles meet the ray
    at the same t (rtol 1e-5: the walkers' and K5's operations differ in
    order), and on > 99% of rays."""
    _require_cuda()
    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.ops import intersect as oi

    scene = scenes.bench_dragon_scene(dragon_tris=2000, accel=accel, device="cuda")
    dense = scenes.bench_dragon_scene(dragon_tris=2000, accel="dense", device="cuda")
    o, d = _query_rays(2048, seed=6)
    t, p = oi.scene_intersect(scene, o, d)
    td, pd = oi.scene_intersect(dense, o, d)
    tie = torch.isclose(t, td, rtol=1e-5, atol=0.0)
    assert bool(tie.all()) and float((p == pd).float().mean()) > 0.99


# ---------------------------------------------------------------------------
# K1's binned while-loop form, the traversal counters, the dispatch flag and
# the microbenchmarks X1, X3, X5.
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_binned_megakernel_matches_twin_with_counters():
    """K1's binned form against its twin on 4096 camera rays of the 20k
    dragon: spectrum and collected bit-equal (the same body, --fmad=false,
    the 8-row seed), and the traversal counters equal column by column."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _dragon()
    st = _camera_state(scene, n=4096)
    rays = Rays(st[1:4].t().contiguous(), st[4:7].t().contiguous())
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    launches = mk.trace_megakernel.launches
    k, kc, kv = mk.trace_megakernel(scene, rays, opts, 321, debug_visits=True)
    plain, _ = mk.trace_megakernel(scene, rays, opts, 321)
    torch.cuda.synchronize()
    assert mk.trace_megakernel.launches == launches + 2
    t, tc, tv = mk.trace_megakernel_reference(scene, rays, opts, 321, debug_visits=True)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32)) and torch.equal(kc, tc)
    assert torch.equal(plain.view(torch.int32), k.view(torch.int32))  # counting changes nothing
    assert torch.equal(kv, tv) and bool((kv > 0).all())


@pytest.mark.cuda
def test_bounce_and_query_counters_match_plain():
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _dragon()
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    tables = mk.pack_tables(scene)
    st = _camera_state(scene, n=4096)
    sw.bounce(scene, st, torch.tensor([77, 0], dtype=torch.int32, device="cuda"), opts, tables)
    k, t = st.clone(), st.clone()
    kv = torch.zeros((4, kt.GEO_VISIT_COLS), dtype=torch.int32, device="cuda")
    tv = torch.zeros_like(kv)
    sd = torch.tensor([77, 1], dtype=torch.int32, device="cuda")
    sw.bounce(scene, k, sd, opts, tables, visits=kv)
    sw.bounce_reference(scene, t, 1, opts, tables, visits=tv)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32))
    assert torch.equal(kv, tv) and int(kv.sum()) > 0
    assert int(kv[:, kt.QUERY_COL].sum()) == int((st[17] > 0.5).sum())
    o, d = _query_rays(4096)
    for any_hit in (False, True):
        lim = torch.rand(4096, device="cuda") * 1.5 + 0.05 if any_hit else None
        *_, vk = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit, debug_visits=True)
        *_, vp = kt.cluster_intersect_reference(scene, o, d, lim, any_hit=any_hit,
                                                debug_visits=True)
        assert vk.shape == (4, kt.WALK_COLS) and torch.equal(vk, vp) and bool((vk > 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("flag,binned,want", [("0", True, "k1"), ("1", False, "k2"),
                                              (None, True, "k2"), (None, False, "k1")])
def test_sorted_wavefront_flag_on_the_card(flag, binned, want, monkeypatch):
    """render() under PTX_SORTED_WAVEFRONT picks the JAX package's tracer:
    counted by the kernels' launch counters, no twin called."""
    _require_cuda()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import scenes

    if flag is None:
        monkeypatch.delenv("PTX_SORTED_WAVEFRONT", raising=False)
    else:
        monkeypatch.setenv("PTX_SORTED_WAVEFRONT", flag)
    scene = _dragon() if binned else scenes.bench_box_scene()
    mk.trace_megakernel.launches = sw.bounce.launches = 0
    mk.trace_megakernel_reference.calls = sw.bounce_reference.calls = 0
    img = pt.render(scene, scenes.bench_camera(), pt.RenderOptions(32, 32, 8, 8, max_depth=40),
                    seed=0, device="cuda")
    ran = {"k1": mk.trace_megakernel.launches, "k2": sw.bounce.launches}
    assert ran[want] > 0 and sum(ran.values()) == ran[want], ran
    assert mk.trace_megakernel_reference.calls == sw.bounce_reference.calls == 0
    assert np.isfinite(img).all() and (img[..., 3] == 1.0).all()


@pytest.mark.cuda
def test_experiment_kernels_match_plain():
    """X1 and X5 equal to their plain versions on the check inputs (X1: the
    output and every ray's least entry; X5: the output and every block's
    staged tables), X3 within rtol 1e-6 (serial, outer: the same float32
    operations) and 1e-5 (matmul: 3xTF32 on the tensor cores against a
    float32 product)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import record_variants as rv
    from cpupathtrace_tpu_torch.experiments import smem_tables as smt
    from cpupathtrace_tpu_torch.experiments import supscan as ss

    for sp in ss.SWEEP_SP:
        x, sup = (torch.from_numpy(a).cuda() for a in ss.check_inputs(sp))
        for rows in ss.SWEEP_ROWS:
            ko, ke = ss.supscan(sup, x, 3, rows, entries=True)
            po, pe = ss.supscan_reference(sup, x, 3, rows, entries=True)
            assert torch.equal(ko, po) and torch.equal(ke, pe)
            acc = (ko.reshape(ss.BLOCKS, 8, 128) - x.reshape(ss.BLOCKS, 16, 128)[:, :8])[:, 0, 0]
            assert bool(torch.isfinite(ke).any()) and 0 < int((acc > 0.5).sum()) < ss.BLOCKS
    tables, rays = rv.inputs()
    rays = torch.from_numpy(rays).cuda()
    for v in rv.VARIANTS:
        table = torch.from_numpy(tables[v]).cuda()
        k = rv.record_variant(v, table, rays, 40)
        p = rv.variant_reference(v, table, rays, 40)
        rtol = 1e-6 if v in ("serial", "outer") else 1e-5
        assert torch.allclose(k, p, rtol=rtol, atol=0.0), v
        assert int((k < 100.0).sum()) >= 10
    for x5, tbl, threads in smt.check_configurations("cuda").values():
        ko, kst = smt.smem_tables(x5, tbl, threads, staged=True)
        po, pst = smt.smem_tables_reference(x5, tbl, threads, staged=True)
        assert torch.equal(ko, po) and torch.equal(kst, pst)


@pytest.mark.cuda
@pytest.mark.parametrize("n_live", [2, 19])
@pytest.mark.parametrize("use_cond", [True, False])
def test_cond_fat_matches_plain(n_live, use_cond):
    """X2 bit-equal to its plain version on the check inputs (the same
    float32 operations, --fmad=false), outputs and per-tile update counts:
    the tiles that take the updates and those that skip them."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import cond_fat as cf

    x = torch.from_numpy(cf.check_inputs()).cuda()
    launches = cf.cond_fat.launches[cf.instance(n_live, use_cond)]
    ko, kc = cf.cond_fat(x, 16, n_live, use_cond, taken=True)
    po, pc = cf.cond_fat_reference(x, 16, n_live, use_cond, taken=True)
    assert cf.cond_fat.launches[cf.instance(n_live, use_cond)] == launches + 1
    assert torch.equal(ko.view(torch.int32), po.view(torch.int32)) and torch.equal(kc, pc)
    np.testing.assert_array_equal(kc.cpu().numpy(), cf.expected_taken(x.cpu(), 16, use_cond))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fma", "tf32", "3xtf32"])
def test_dot_formulations_match_plain(form):
    """X4: fma bit-equal to its plain version in C, R and X; the TF32 forms
    within TOL_REL of sum_k |B A| of their emulation, R and X exactly the
    min and first argmin of the kernel's own C."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import dot_formulations as df

    b, a, e = (torch.from_numpy(v).cuda() for v in df.script_inputs(0))
    c, r, x = df.dot_formulation(form, b, a, e)
    pc, pr, px = df.dot_reference(form, b, a, e)
    assert df.self_check(c, r, x, e)
    if form == "fma":
        assert torch.equal(c, pc) and torch.equal(r, pr) and torch.equal(x, px)
    else:
        assert df.within_tolerance(c, pc, b, a)
    errs = df.script_errors(b, a, e, c, r, x)
    assert errs["matmul_rel_err"] < (1e-3 if form == "tf32" else 1e-6), errs


@pytest.mark.cuda
@pytest.mark.parametrize("staging", ["rows", "bulk"])
@pytest.mark.parametrize("shape", ["k1", "persistent"])
def test_smem_tables_launch_shapes_match_plain(staging, shape):
    """X5 bit-equal to its plain version in every check configuration, at
    K1's launch shape and on the persistent grid, in each staging instance:
    the output and every launched block's staged tables; one launch a call."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import smem_tables as smt

    for name, (x, tbl, threads) in smt.check_configurations("cuda").items():
        blocks = smt.resident_blocks(x, tbl, threads, staging) if shape == "persistent" else None
        launches = smt.smem_tables.launches
        ko, kst = smt.smem_tables(x, tbl, threads, staged=True, blocks=blocks, staging=staging)
        po, pst = smt.smem_tables_reference(x, tbl, threads, staged=True, blocks=blocks)
        assert smt.smem_tables.launches == launches + 1
        assert torch.equal(ko, po) and torch.equal(kst, pst), name
        assert kst.shape[0] == (blocks or smt.k1_blocks(x.numel(), threads))
        assert float((ko != x).float().mean()) > (0.99 if tbl else -1.0), name


@pytest.mark.cuda
@pytest.mark.parametrize("staging", ["rows", "bulk"])
def test_smem_tables_ragged_rays_and_unaligned_tables(staging):
    """A ragged ray count and tables that break the bulk copies' 16-byte
    rule (a span starting 4 bytes past a 16-byte boundary, a strided table
    of 5 of 9 columns) at both launch shapes: bit-equal, every block's
    staged copy too."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import smem_tables as smt

    x, tbl, threads = smt.check_configurations("cuda")["k1_box_tables"]
    rng = np.random.default_rng(3)
    base = torch.tensor(rng.uniform(0.5, 1.5, 300), dtype=torch.float32, device="cuda")
    tables = tbl + [(base[1:1 + 39 * 7].view(39, 7), 7), (base[3:3 + 30 * 9].view(30, 9), 5)]
    for n in (1_000_003, 4096 * 256 + 5):
        xs = x[:n]
        for blocks in (None, smt.resident_blocks(xs, tables, threads, staging)):
            ko, kst = smt.smem_tables(xs, tables, threads, staged=True, blocks=blocks,
                                      staging=staging)
            po, pst = smt.smem_tables_reference(xs, tables, threads, staged=True, blocks=blocks)
            assert torch.equal(ko, po) and torch.equal(kst, pst), (n, blocks)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["fma", "tf32", "3xtf32"])
def test_dot_formulations_ties_match_plain(form):
    """X4 on seed 1 and on the tie inputs (a column's minimum in two rows:
    -0.0 / +0.0 in other warps, equal negatives in other warps and in one
    thread): fma bit-equal to its plain version, the TF32 forms within
    TOL_REL; R and X the min and the first row of the kernel's own C; one
    launch a call."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import dot_formulations as df

    for inputs in (df.script_inputs(1), df.tie_inputs()):
        b, a, e = (torch.from_numpy(v).cuda() for v in inputs)
        launches = df.dot_formulation.launches[form]
        c, r, x = df.dot_formulation(form, b, a, e)
        assert df.dot_formulation.launches[form] == launches + 1
        pc, pr, px = df.dot_reference(form, b, a, e)
        assert df.self_check(c, r, x, e)
        if form == "fma":
            assert torch.equal(c, pc) and torch.equal(r, pr) and torch.equal(x, px)
        else:
            assert df.within_tolerance(c, pc, b, a)
    assert df.ties_hold(r, x, e)
