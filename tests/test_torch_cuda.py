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
def test_box_chunk_makes_no_host_sync():
    """A box chunk through render_chunk (shoot_rays, K1, the sums) waits for
    nothing on the card, so frames enqueued back to back overlap (the
    camera's thin-lens distance once came from the host with a stream
    sync): torch's sync debug mode sees no synchronising call."""
    import warnings

    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator.film import pixel_camera_coords, render_chunk
    from cpupathtrace_tpu_torch.models import scenes

    _require_cuda()
    scene, camera = scenes.bench_box_scene(device="cuda"), scenes.bench_camera(device="cuda")
    opts = RenderOptions(32, 32, 4, 4, max_depth=40)
    xg, yg = np.meshgrid(np.arange(32, dtype=np.float32), np.arange(32, dtype=np.float32))
    x, y = (torch.tensor(v, dtype=torch.float32, device="cuda")
            for v in pixel_camera_coords(opts, xg.ravel(), yg.ravel()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    render_chunk(scene, camera, opts, x, y, gen, 4)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            s, n = render_chunk(scene, camera, opts, x, y, gen, 4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not [w for w in seen if "synchroniz" in str(w.message)], [str(w.message) for w in seen]
    # The closed box covers every pixel of the benchmark camera.
    assert int(n.sum()) == 32 * 32 * 4 and bool(torch.isfinite(s).all())


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
    """K4 against the plain traversal on the same rays: t and prim equal on
    every ray (chip_smoke.py phase 7's bound); they do the same float32
    pair test per record, in the same order."""
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
    assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert int((p >= 0).sum()) > 100


def _query_wave(scene, count=False):
    """The threads of one resident wave of K4 on `scene`."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    per_sm, threads = kt.query_occupancy(kt.query_smem_bytes(scene.krn_sup_bounds.shape[0]),
                                         count)
    return per_sm * threads * torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.cuda
@pytest.mark.parametrize("n", ["1", "31", "half_wave_17", "wave_plus_1", "three_waves",
                               "three_waves_gated"])
def test_cluster_query_refill_writes_every_ray(n):
    """K4 on refilling persistent warps: on counts below, at and past one
    resident wave (17 past a multiple of 32 below it), and past it with
    alternate runs of 4,096 rays inactive (t_lim 0: they end at the root
    gate, whole claims of a warp at once), t starts as NaN and every ray is
    written, equal to the plain version, nearest and any-hit."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    scene = _dragon()
    wave = _query_wave(scene)
    count = {"1": 1, "31": 31, "half_wave_17": (wave // 2) // 32 * 32 + 17,
             "wave_plus_1": wave + 1, "three_waves": 3 * wave,
             "three_waves_gated": 3 * wave}[n]
    o, d = _query_rays(count, seed=9)
    lim = torch.rand(count, device="cuda") * 1.5 + 0.05
    if n.endswith("gated"):
        lim[torch.arange(count, device="cuda") // 4096 % 2 == 0] = 0.0
    for any_hit in (False, True):
        t, p = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit)
        torch.cuda.synchronize()
        tp, pp = kt.cluster_intersect_reference(scene, o, d, lim, any_hit=any_hit)
        assert not bool(torch.isnan(t).any())
        assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_query_warp_steps_within_their_bounds(any_hit):
    """K4's counting instance: the counters equal the plain version's and
    its warp steps (slab and row steps, clusters and active lanes a row
    step) lie within their bounds; the plain instance gives the same
    results."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    scene = _dragon()
    o, d = _query_rays(20000, seed=6)
    lim = torch.rand(20000, device="cuda") * 1.5 + 0.05 if any_hit else None
    steps = torch.zeros(kt.QUERY_STEP_COLS, dtype=torch.int64, device="cuda")
    t, p, v = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit, debug_visits=True,
                                   warp_steps=steps)
    t0, p0 = kt.cluster_intersect(scene, o, d, lim, any_hit=any_hit)
    torch.cuda.synchronize()
    *_, vp = kt.cluster_intersect_reference(scene, o, d, lim, any_hit=any_hit,
                                            debug_visits=True)
    assert torch.equal(v, vp)
    assert torch.equal(p, p0) and torch.equal(t.view(torch.int32), t0.view(torch.int32))
    u = kt.warp_utilisation(v, steps)
    assert u["row_steps"] > 0 and u["clusters_per_row_step"] >= 1.0


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
    """K8's compute stage (its own kernel, csrc/cluster_major.cu, on the
    binned pairs; no K7 launch) against its plain version, slot for slot."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm, traverse as tt

    scene = _dragon()
    o, d = _query_rays(seed=4)
    blocks = cm.cluster_blocks(scene)
    ids, _ = binned.generate_candidates(scene, o, d, 4)
    launches, k7 = cm.test_candidates.launches, tt.isect.launches
    t, p = cm.test_candidates(blocks, o, d, ids)
    torch.cuda.synchronize()
    assert cm.test_candidates.launches == launches + 1 and tt.isect.launches == k7
    tp, pp = cm._test_candidates(blocks, o, d, ids)
    assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [False, True])
def test_cluster_major_every_shape_matches_plain(staged):
    """K8's kernel at every S its block takes and both row sources, on M = 1
    and 4 (most slots empty at M = 4) and on a query whose slots are all
    empty: bit-equal t, equal prim, every slot written (the outputs start
    uninitialised)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm

    scene = _dragon()
    blocks = cm.cluster_blocks(scene)
    o, d = _query_rays(n=3001, seed=6)
    threads = cm.stage_shape(blocks, 1)["threads"]
    for m in (1, 4):
        ids, _ = binned.generate_candidates(scene, o, d, m)
        order, _, offs = binned.bin_offsets(ids, blocks.shape[0])
        tp, pp = cm._test_candidates(blocks, o, d, ids)
        for splits in (1, 2, 4, 8):
            if splits > threads // 32:
                continue
            t, p = cm.stage_run(blocks, o, d, order, offs, m, splits, staged)
            torch.cuda.synchronize()
            assert torch.equal(p, pp), (m, splits)
            assert torch.equal(t.view(torch.int32), tp.view(torch.int32)), (m, splits)
    empty = torch.full((77, 3), -1, dtype=torch.int64, device="cuda")
    order, _, offs = binned.bin_offsets(empty, blocks.shape[0])
    t, p = cm.stage_run(blocks, o[:77].contiguous(), d[:77].contiguous(), order, offs, 3, 1,
                        staged)
    assert bool(torch.isinf(t).all()) and bool((p == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 4])
def test_cluster_major_planted_ties_on_the_card(splits):
    """tests/test_torch_cluster_major.py's planted ties on the card: equal
    t across a range boundary (the earlier group's prim wins) and inside a
    group (the smallest prim), equal to the plain version."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm
    from cpupathtrace_tpu_torch.experiments import cluster_major_sweep as cms

    blocks, o, d, ids, prims = cms.planted_ties("cuda")
    order, _, offs = binned.bin_offsets(ids, blocks.shape[0])
    t, p = cm.stage_run(blocks, o, d, order, offs, ids.shape[1], splits)
    assert p.tolist() == prims and t[0].tolist() == [1.0, 1.0]


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

    for half_cta in (False, True):
        for sp in ss.SWEEP_SP:
            x, sup = (torch.from_numpy(a).cuda() for a in ss.check_inputs(sp, half_cta))
            for rows in ss.SWEEP_ROWS:
                ko, ke = ss.supscan(sup, x, 3, rows, entries=True)
                po, pe = ss.supscan_reference(sup, x, 3, rows, entries=True)
                assert torch.equal(ko, po) and torch.equal(ke, pe)
                acc = (ko.reshape(ss.BLOCKS, 8, 128)
                       - x.reshape(ss.BLOCKS, 16, 128)[:, :8])[:, 0, 0]
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
def test_supscan_cluster_launch():
    """X1 on every check input (the half-CTA ones too), as clusters of 2
    CTAs of one ray a thread, of which all 64 are resident at once."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import supscan as ss

    counting = ss.check_all(ss.supscan)
    assert all(0 < n < ss.BLOCKS for n in counting.values())
    for rows in ss.SWEEP_ROWS:
        for sp in ss.SWEEP_SP:
            lay = ss.layout(rows, sp)
            assert lay["ctas"] == 2 and lay["threads"] == ss.cta_threads(rows)
            assert lay["resident_clusters"] >= ss.BLOCKS


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
@pytest.mark.parametrize("inputs", ["script", "near"])
@pytest.mark.parametrize("variant", ["serial", "outer", "matmul", "matmul_extract"])
def test_record_variant_split_matches_plain_with_counts(variant, inputs):
    """X3 split over the card (`rv.check`: within rtol 1e-6 / 1e-5 of its
    plain version, the near row 0 of the matmul variants within
    `near_bound` of the float64 one, the ray-record counts equal to the
    formula) at the wrapper's grid, with one chunk, and with more chunks
    than record tests (blocks with none)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import record_variants as rv

    tables, rays = rv.inputs() if inputs == "script" else rv.check_inputs()
    rays = torch.from_numpy(rays).cuda()
    table = torch.from_numpy(tables[variant]).cuda()
    launches = rv.record_variant.launches[variant]
    for k_iters, chunks in ((40, None), (33, 1), (3, 40), (0, 5)):
        rv.check(variant, table, rays, k_iters, near=inputs == "near", chunks=chunks)
    assert rv.record_variant.launches[variant] == launches + 4
    blocks, chunks = rv.record_grid(variant, 256)
    assert blocks == rv.grid_blocks(chunks) and blocks > 8 and chunks > 1


@pytest.mark.cuda
def test_record_extraction_moves_only_near_row0():
    """matmul_extract - matmul on the card: nothing on the script's inputs;
    on the near inputs at least 96 row-0 rays, each by the plain versions'
    sum of corrections within `rv.EXTRACT_ULPS`, and none of rows 1-7."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import record_variants as rv

    for near in (False, True):
        tables, rays = rv.check_inputs() if near else rv.inputs()
        ext = rv.extraction(torch.from_numpy(tables["matmul"]).cuda(),
                            torch.from_numpy(rays).cuda(), 256, near=near)
        assert ext["rest_moved"] == 0
        assert ext["row0_moved"] >= rv.MIN_MOVED if near else ext["row0_moved"] == 0
        assert ext["row0_err_ulps"] <= rv.EXTRACT_ULPS or not near


@pytest.mark.cuda
@pytest.mark.parametrize("n_live", [2, 19])
@pytest.mark.parametrize("use_cond", [True, False])
def test_cond_fat_layout(n_live, use_cond):
    """Each X2 instance at its layout: the threads and CTAs a tile of
    `tile_map`'s cover, all 64 tiles resident at once, bit-equal to its
    plain version with the taken counts."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import cond_fat as cf

    lay = cf.layout(n_live, use_cond)
    assert (lay["threads"], lay["ctas"]) in (cf.COND_LAYOUTS if use_cond else cf.SWEEP_LAYOUTS)
    assert lay["resident_tiles"] >= cf.BLOCKS
    cta, thread, _ = cf.tile_map(lay["threads"], lay["ctas"])
    assert cta.max() + 1 == lay["ctas"] and thread.max() + 1 == lay["threads"]
    x = torch.from_numpy(cf.check_inputs()).cuda()
    ko, kc = cf.cond_fat(x, 7, n_live, use_cond, taken=True)
    po, pc = cf.cond_fat_reference(x, 7, n_live, use_cond, taken=True)
    assert torch.equal(ko.view(torch.int32), po.view(torch.int32)) and torch.equal(kc, pc)


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


# ---------------------------------------------------------------------------
# The walk's cp.async ring (K1's binned form and K2): the 200k dragon at 56-
# and 128-row records, ragged ray counts, the ring's early exits, the warp
# steps, and K1's refilling persistent warps.
# ---------------------------------------------------------------------------

_DRAGONS_200K: dict = {}


def _dragon_200k(cluster):
    """The 200k dragon built lean (the megakernel tables alone) with
    PTX_KRN_CLUSTER=cluster, once per module."""
    import os

    from cpupathtrace_tpu_torch.models import scenes

    if cluster not in _DRAGONS_200K:
        old = os.environ.get("PTX_KRN_CLUSTER")
        os.environ["PTX_KRN_CLUSTER"] = str(cluster)
        try:
            scene = scenes.bench_dragon_scene(dragon_tris=200000, lean=True, device="cuda")
        finally:
            os.environ.pop("PTX_KRN_CLUSTER")
            if old is not None:
                os.environ["PTX_KRN_CLUSTER"] = old
        assert scene.krn_records.shape[1] == cluster
        _DRAGONS_200K[cluster] = scene
    return _DRAGONS_200K[cluster]


def _warp_steps():
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    return torch.zeros(kt.WARP_STEP_COLS, dtype=torch.int64, device="cuda")


def _check_k1_binned(scene, n, seed=321, state=None):
    """K1's binned form on `n` camera rays (or the rays of `state`) against
    its twin: spectrum and collected bit-equal, counters equal, no ray left
    unwritten (the output starts as NaN), the warp steps within their
    bounds. Returns the counters."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    st = _camera_state(scene, n=n) if state is None else state
    rays = Rays(st[1:4].t().contiguous(), st[4:7].t().contiguous())
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    steps = _warp_steps()
    k, kc, kv = mk.trace_megakernel(scene, rays, opts, seed, debug_visits=True, warp_steps=steps)
    plain, _ = mk.trace_megakernel(scene, rays, opts, seed)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(k).any()) and not bool(torch.isnan(plain).any())
    t, tc, tv = mk.trace_megakernel_reference(scene, rays, opts, seed, debug_visits=True)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32)) and torch.equal(kc, tc)
    assert torch.equal(plain.view(torch.int32), k.view(torch.int32))
    assert torch.equal(kv, tv)
    util = kt.warp_utilisation(kv, steps.cpu())
    assert util["row_steps"] > 0 and util["slab_steps"] > 0
    return kv


def _check_bounce(scene, n, depths=(0, 1, 2), state=None):
    """K2's plain, counting and record forms on `n` camera rays (or from
    `state`) against the twin, bounce after bounce: the 18 planes and the
    live rays' record planes bit-equal, the counters equal, the warp steps
    within their bounds (none where the walks test nothing: the dragon
    box's camera rays stop at the box before the dragon's root box), and
    counted in some bounce."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    tables = mk.pack_tables(scene)
    st = _camera_state(scene, n=n) if state is None else state
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    rows = -(-n // kt.VISIT_BLOCK)
    row_steps = 0
    for depth in depths:
        sd = torch.tensor([77, depth], dtype=torch.int32, device="cuda")
        k, c, r, t = st.clone(), st.clone(), st.clone(), st.clone()
        kv = torch.zeros((rows, kt.GEO_VISIT_COLS), dtype=torch.int32, device="cuda")
        tv = torch.zeros_like(kv)
        rk = torch.empty((nd, n), device="cuda")
        rt = torch.empty_like(rk)
        steps = _warp_steps()
        sw.bounce(scene, k, sd, opts, tables)
        sw.bounce(scene, c, sd, opts, tables, visits=kv, warp_steps=steps)
        sw.bounce(scene, r, sd, opts, tables, records=rk)
        sw.bounce_reference(scene, t, depth, opts, tables, records=rt, visits=tv)
        live = st[17] > 0.5
        for form in (k, c, r):
            assert torch.equal(form.view(torch.int32), t.view(torch.int32)), depth
        assert torch.equal(rk[:, live].view(torch.int32), rt[:, live].view(torch.int32)), depth
        assert torch.equal(kv, tv), depth
        row_steps += kt.warp_utilisation(kv, steps.cpu())["row_steps"]
        st = k
    assert row_steps > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4096 + 77])
@pytest.mark.parametrize("cluster", [56, 128])
def test_ring_k1_binned_on_the_200k_dragon(cluster, n):
    """K1's binned form (the ring walk on refilling persistent warps) on the
    200k dragon at 56- and 128-row records, a whole and a ragged ray count:
    bit-equal to its twin with equal counters."""
    _require_cuda()
    _check_k1_binned(_dragon_200k(cluster), n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 4096 + 77])
@pytest.mark.parametrize("cluster", [56, 128])
def test_ring_bounce_forms_on_the_200k_dragon(cluster, n):
    """K2's plain, counting and record forms on the 200k dragon at 56- and
    128-row records, a whole and a ragged ray count: planes and counters
    equal to the twin's."""
    _require_cuda()
    _check_bounce(_dragon_200k(cluster), n)


def _shadowed_plate_scene():
    """A binned scene built to end shadow walks early: a white box, an
    opaque plate of 8,192 small triangles between the floor and two point
    lights, so that the shadow rays of floor points stop at an occluding
    row of a cluster (row 0 for some, rows well before the last for most)
    while the rows after it are in flight, and the next shadow walk (the
    second light) or nearest walk (K1's next bounce) of the same thread
    follows in the same launch."""
    from cpupathtrace_tpu_torch.scene.geometry import make_box
    from cpupathtrace_tpu_torch.scene.mesh import mesh_from_arrays
    from cpupathtrace_tpu_torch.scene.scene import SceneBuilder

    m = 64
    g = np.linspace(-0.8, 0.8, m + 1)
    xs, zs = np.meshgrid(g, g, indexing="ij")
    verts = np.stack([xs.ravel(), np.full(xs.size, 0.2), zs.ravel()], axis=1)
    idx = np.arange((m + 1) * (m + 1)).reshape(m + 1, m + 1)
    a, b, c, d = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]
    faces = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                            np.stack([a, c, d], -1).reshape(-1, 3)])
    bld = SceneBuilder()
    white = bld.add_material(diffuse=(0.8, 0.8, 0.8, 1))
    bld.add_triangles(make_box((-1, -1, -1), (1, 1, 1)), white)
    bld.add_triangles(mesh_from_arrays(verts, faces, np.eye(4), cull_backface=False,
                                       smooth=False, as_batch=True), white)
    bld.add_point_light((0.3, 0.8, 0.1), (1.0, 1.0, 1.0, 1.0))
    bld.add_point_light((-0.3, 0.7, -0.2), (0.5, 0.5, 0.5, 1.0))
    scene = bld.build(device="cuda")
    assert scene.has_kernel_records
    return scene


@pytest.mark.cuda
def test_ring_early_exits_leave_no_stale_rows():
    """The ring's early ways out (an any-hit walk stopping at an occluding
    row with later rows in flight, a passing box in the middle of a page)
    followed by more walks of the same thread in the same launch: K1's
    binned form and K2 bit-equal to their twins with equal counters, and
    the counters show the shadow walks stopping early."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    scene = _shadowed_plate_scene()
    kv = _check_k1_binned(scene, 8192)
    _check_bounce(scene, 8192, depths=(0, 1, 2))
    v = kv.long().sum(0)
    rows_per_record = scene.krn_records.shape[1]
    shadow_visits, shadow_rows = int(v[kt.SHADOW_COLS[1]]), int(v[kt.SHADOW_COLS[3]])
    assert shadow_visits > 1000
    assert shadow_rows < 0.8 * shadow_visits * rows_per_record


def _walk_state(o, d, seed=41):
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    return sw.initial_state(torch.tensor(o, dtype=torch.float32, device="cuda"),
                            torch.tensor(d, dtype=torch.float32, device="cuda"), seed)


def _gate_rays(scene, n, seed=5):
    """`n` rays in the box, even lanes aimed into the dragon's root box (the
    glass dragon: specular hits, whose lanes skip the shadow walks), odd
    lanes from above it pointing up and away (they fail the root gate of
    their first nearest walk)."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    root = kt.root_box(scene.krn_hyp_bounds)[0].cpu().numpy().astype(np.float64)
    lo, hi = root[:3], root[3:6]
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.9, 0.9, (n, 3))
    target = lo + rng.uniform(0.3, 0.7, (n, 3)) * (hi - lo)
    d = target - o
    o[1::2, 1] = rng.uniform(hi[1] + 0.05, 0.9, o[1::2].shape[0])
    d[1::2] = rng.normal(size=(o[1::2].shape[0], 3))
    d[1::2, 1] = np.abs(d[1::2, 1]) + 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _floor_rays(n, seed=8):
    """`n` rays from just above the plate scene's floor pointing down: each
    hits the floor at once, and its shadow rays to the two lights cross the
    plate of small triangles."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-0.75, 0.75, n), np.full(n, -0.99), rng.uniform(-0.75, 0.75, n)],
                 axis=1)
    d = np.tile([0.0, -1.0, 0.0], (n, 1))
    return o, d


def _plain_walk_counts(scene, o, d, t_lim=None):
    """Per ray, the plain walk's counters [n, 4] (descends, record visits,
    slab tests, filled rows) and its result: nearest (t, prim) without
    `t_lim`, else the any-hit flags."""
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    cols = [torch.tensor(a[:, j], dtype=torch.float32) for a in (o, d) for j in range(3)]
    tables = kt.kernel_tables(scene.to("cpu"))
    n = o.shape[0]
    vis = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    if t_lim is not None:
        occ = kt.traverse_clusters_anyhit(tables, *cols, torch.tensor(t_lim, dtype=torch.float32),
                                          scene.krn_cull_mode, visits=vis)
        return vis, occ
    miss = torch.full((n,), -1, dtype=torch.int64)
    z = torch.zeros(n)
    t, p, *_ = kt.traverse_clusters(tables, *cols, (torch.full((n,), float("inf")), miss, z, z,
                                                   z, miss), scene.krn_cull_mode,
                                    want_normal_mat=False, visits=vis)
    return vis, (t, p)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_lane", "ragged_33", "root_gate_and_specular",
                                  "first_row_stops"])
def test_stepped_walk_lanes_leave_at_different_turns(case):
    """The stepped walk (csrc/cluster_traverse.cuh `Walk`, one test a step)
    on warps whose lanes leave it at different turns: a warp of one lane
    and a ragged count; every other lane failing the root gate while its
    neighbours walk into the glass dragon (specular hits: those lanes skip
    the shadow walks); shadow walks that stop in the plate of small
    triangles, some at the first filled row they test. K1's binned form and
    K2's plain, counting and record forms bit-equal to their twins with
    equal counters and warp steps within their bounds; K4 exact on t, prim
    and counters on the same walks."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    if case != "first_row_stops":
        scene = _dragon()
        o, d = _gate_rays(scene, {"one_lane": 1, "ragged_33": 33,
                                  "root_gate_and_specular": 4096 + 13}[case])
        vis, (t, p) = _plain_walk_counts(scene, o, d)
        assert not bool(vis[1::2].any())  # odd lanes: the root gate ends the walk
        assert bool((vis[0::2, 2] > 0).all())  # even lanes walk
        if o.shape[0] > 1000:
            assert int((p[0::2] >= 0).sum()) > 1000  # glass hits
        st = _walk_state(o, d)
    else:
        scene = _shadowed_plate_scene()
        o, d = _floor_rays(8192)
        st = _walk_state(o, d)
        # The shadow rays of the floor points below the plate to its first
        # light: some stop at the first filled row they test.
        light = scene.light_pos[0].cpu().numpy().astype(np.float64)
        f = o.copy()
        f[:, 1] = -1.0
        to = light - f
        dist = np.linalg.norm(to, axis=1)
        so, sd = f + 1e-3 * to / dist[:, None], to / dist[:, None]
        vis, occ = _plain_walk_counts(scene, so, sd, dist - 1e-3)
        first = occ & (vis[:, 3] == 1)
        assert int(occ.sum()) > 4000 and int(first.sum()) > 10, (int(occ.sum()), int(first.sum()))
        o, d = so, sd
    n = o.shape[0]
    _check_k1_binned(scene, n, state=st)
    _check_bounce(scene, n, depths=(0, 1, 2), state=st)
    od = [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (o, d)]
    lim = (torch.rand(n, device="cuda") * 1.5 + 0.05 if case != "first_row_stops"
           else torch.tensor(dist - 1e-3, dtype=torch.float32, device="cuda"))
    for any_hit in (False, True):
        tk, pk, vk = kt.cluster_intersect(scene, *od, lim if any_hit else None, any_hit=any_hit,
                                          debug_visits=True)
        tp, pp, vp = kt.cluster_intersect_reference(scene, *od, lim if any_hit else None,
                                                    any_hit=any_hit, debug_visits=True)
        assert torch.equal(pk, pp) and torch.equal(tk.view(torch.int32), tp.view(torch.int32))
        assert torch.equal(vk, vp)


@pytest.mark.cuda
def test_persistent_megakernel_writes_every_ray_once():
    """K1's binned form on more rays than its resident threads hold (so
    lanes refill): every ray's spectrum written (the output starts as NaN),
    two launches bit-equal whatever lane traced which ray, and the first
    rays equal to the twin's on the same indices (each ray seeded from its
    own index)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _dragon()
    n = 3 * torch.cuda.get_device_properties(0).multi_processor_count * 2048 + 5
    st = _camera_state(scene, n=n)
    rays = Rays(st[1:4].t().contiguous(), st[4:7].t().contiguous())
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    a, _ = mk.trace_megakernel(scene, rays, opts, 9)
    b, _ = mk.trace_megakernel(scene, rays, opts, 9)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(a).any())
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    head = Rays(rays.origin[:2048].contiguous(), rays.direction[:2048].contiguous())
    t, _ = mk.trace_megakernel_reference(scene, head, opts, 9)
    assert torch.equal(a[:2048].view(torch.int32), t.view(torch.int32))


def _blocks_with_padding(rng, c, l, pad_rows):
    """Cluster blocks [c, l, 16] whose rows in `pad_rows` (per cluster, a
    boolean [c, l]) are padding (prim -1)."""
    from cpupathtrace_tpu_torch.accel import traverse as tt

    v0 = rng.uniform(-1, 1, (c, l, 3))
    v1 = v0 + rng.normal(scale=0.1, size=(c, l, 3))
    v2 = v0 + rng.normal(scale=0.1, size=(c, l, 3))
    prim = np.arange(c * l).reshape(c, l)
    prim[pad_rows] = -1
    return torch.tensor(tt.pack_blocks(v0, v1, v2, rng.random((c, l)) < 0.5, prim),
                        device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [[0, 300, 1, 0, 257, 64, 31, 513], [5], [0, 0, 1000]])
def test_isect_padding_empty_clusters_and_ragged_counts(counts):
    """K7 bit-equal to its plain version with padding groups in the middle
    and at the tail, a cluster with no filled row, empty clusters and pair
    counts 1 past and below a warp's and an item's pairs."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    rng = np.random.default_rng(len(counts))
    c, l = len(counts), 264
    pad = np.zeros((c, l), bool)
    pad[:, 40:64] = True  # three padding groups in the middle
    pad[:, 200:] = True  # and a tail of eight groups
    pad[:, 13] = True  # a padding row inside a filled group
    if c > 1:
        pad[c // 2] = True  # a cluster with no filled row
    blocks = _blocks_with_padding(rng, c, l, pad)
    n = sum(counts)
    o = rng.uniform(-1, 1, (n, 3))
    dv = rng.normal(size=(n, 3))
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    rays = torch.tensor(np.ascontiguousarray(np.concatenate([o.T, dv.T])), dtype=torch.float32,
                        device="cuda")
    offs = torch.tensor(np.concatenate([[0], np.cumsum(counts)]), dtype=torch.int32,
                        device="cuda")
    t, p = tt.isect(blocks, rays, offs)
    torch.cuda.synchronize()
    tp, pp = tt.isect_reference(blocks, rays, offs)
    assert torch.equal(p, pp) and torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert int((p >= 0).sum()) > 0


@pytest.mark.cuda
def test_isect_ties_in_and_across_groups():
    """K7 on rows that meet a ray at the same t: copies of one triangle in
    one 8-row group (the smallest prim wins) and in a later group (the
    earlier group keeps it), equal to the plain version."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    blocks, rays, offs = _tie_case()
    t, p = tt.isect(torch.tensor(blocks, device="cuda"), torch.tensor(rays, device="cuda"),
                    torch.tensor(offs, device="cuda"))
    torch.cuda.synchronize()
    tp, pp = tt.isect_reference(torch.tensor(blocks), torch.tensor(rays), torch.tensor(offs))
    assert torch.equal(p.cpu(), pp) and torch.equal(t.cpu().view(torch.int32),
                                                    tp.view(torch.int32))
    assert bool((pp >= 0).all())


def _tie_case():
    """One cluster of 24 rows: a triangle copied to rows 3, 5 (prims 50,
    40) and 17 (prim 30), every other row a triangle off the rays' path;
    40 rays down through it."""
    from cpupathtrace_tpu_torch.accel import traverse as tt

    l = 24
    v0 = np.tile([[5.0, 5.0, 5.0]], (1, l, 1))
    v1 = v0 + [0.1, 0.0, 0.0]
    v2 = v0 + [0.0, 0.1, 0.0]
    prim = np.arange(100, 100 + l)[None].copy()
    for row, pr in ((3, 50), (5, 40), (17, 30)):
        v0[0, row], v1[0, row], v2[0, row] = [-1, -1, 0], [3, -1, 0], [-1, 3, 0]
        prim[0, row] = pr
    blocks = tt.pack_blocks(v0, v1, v2, np.zeros((1, l), bool), prim)
    rng = np.random.default_rng(4)
    n = 40
    o = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.ones((n, 1))], 1)
    d = np.tile([[0.0, 0.0, -1.0]], (n, 1))
    rays = np.ascontiguousarray(np.concatenate([o.T, d.T]), dtype=np.float32)
    return blocks, rays, np.array([0, n], dtype=np.int32)


@pytest.mark.cuda
def test_isect_work_item_is_the_one_the_cpu_tests_cut():
    """K7's library reports the pairs a work item it was built with: the
    wrapper's ITEM_PAIRS, which the CPU tests cut work lists with."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    per_sm, threads, item_pairs = tt.isect_occupancy()
    assert item_pairs == tt.ITEM_PAIRS == 128 and threads == 128 and per_sm >= 1


@pytest.mark.cuda
def test_cluster_query_layout_is_the_one_the_cpu_tests_size():
    """K4's library reports its own walk layout (ring depth and block
    size), the one tests/test_torch_query.py sizes K4's blocks at."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    from_lib = kt.walk_layout("cluster_query")
    assert from_lib == kt.WalkLayout(threads=128, depth=2, slot_bytes=80, tier_floats=16384)


@pytest.mark.cuda
def test_walk_layout_is_the_one_the_cpu_tests_size():
    """K1's and K2's libraries report the shared-memory layout they were
    built with (ptx_walk_layout): the one tests/test_torch_walk.py sizes
    the main path's scenes at (its BUILT)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt

    built = kt.WalkLayout(threads=128, depth=3, slot_bytes=80, tier_floats=16384)
    assert kt.walk_layout("megakernel") == kt.walk_layout("bounce") == built


def _dense_wave(scene):
    """The threads of one resident wave of K1's dense form on `scene`."""
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    smem = mk.block_smem_bytes(scene, mk.pack_tables(scene))
    cull = scene.krn_big_cull_mode if scene.dense_pair else -1
    per_sm, threads = mk.occupancy(smem, False, False, cull)
    return torch.cuda.get_device_properties(0).multi_processor_count * per_sm * threads


# The adaptive film's launches at 48x48 @ 16-64 spp (film.py
# adaptive_constants): one stats batch of 4 samples a pixel, and
# ADAPTIVE_FUSE = 4 batches fused into one launch.
_FILM_CHUNKS = {"film_stats": 48 * 48 * 4, "film_fused": 48 * 48 * 4 * 4}


@pytest.mark.cuda
@pytest.mark.parametrize(
    "name,n",
    [(name, n) for name in ("box", "sphere", "specular") for n in ("1", "31", "257", "wave+1")]
    + [("box", "film_stats"), ("box", "film_fused")],
)
def test_dense_refill_is_bit_equal_on_ragged_counts(name, n):
    """K1's dense form on refilling persistent warps, on ray counts that are
    not multiples of 32 or of the block (one ray, a partial warp, a partial
    block, one resident wave and one ray more, so a lane refills) and on
    the adaptive film's launch sizes: every ray written (the output starts
    as NaN) and bit-equal to the twin, each ray seeded by its own index."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _scene(name)
    count = (_dense_wave(scene) + 1 if n == "wave+1" else _FILM_CHUNKS[n] if n in _FILM_CHUNKS
             else int(n))
    rays = _rays(forward=name == "sphere", n=count, seed=count)
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    ours, _ = mk.trace_megakernel(scene, rays, opts, 4321)
    torch.cuda.synchronize()
    assert not bool(torch.isnan(ours).any())
    twin, _ = mk.trace_megakernel_reference(scene, rays, opts, 4321)
    assert torch.equal(ours.view(torch.int32), twin.view(torch.int32))


@pytest.mark.cuda
def test_dense_bounce_steps_within_their_bounds():
    """The dense counting instance on three resident waves and five rays:
    its spectrum bit-equal to the plain instance's, its warp bounce steps
    and ray-bounces within steps <= ray-bounces <= 32 x steps, and at least
    one bounce per ray."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _scene("box")
    n = 3 * _dense_wave(scene) + 5
    rays = _rays(forward=False, n=n, seed=3)
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    steps = torch.zeros(mk.BOUNCE_STEP_COLS, dtype=torch.int64, device="cuda")
    counted, _ = mk.trace_megakernel(scene, rays, opts, 8, bounce_steps=steps)
    plain, _ = mk.trace_megakernel(scene, rays, opts, 8)
    torch.cuda.synchronize()
    assert torch.equal(counted.view(torch.int32), plain.view(torch.int32))
    use = mk.lane_use(steps.cpu())
    assert 0.0 < use <= 1.0 and int(steps[1]) >= n
    with pytest.raises(ValueError, match="dense"):
        mk.trace_megakernel(_dragon(), rays, opts, 8, bounce_steps=steps)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["box", "dragon"])
def test_record_form_writes_every_dead_column_without_a_fill(name):
    """K2's record form on a state where a seeded third of the rays enter
    dead, into NaN-filled record planes (no fill before the launch): no
    column left NaN, every dead column the no-contribution encoding
    (mid -1, all else 0), and every column, live or dead, bit-equal to
    the twin's; the state planes equal and the dead rays' unchanged."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _scene("box") if name == "box" else _dragon()
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    tables = mk.pack_tables(scene)
    st = _camera_state(scene, n=16384 + 77)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    dead = torch.rand(st.shape[1], generator=gen, device="cuda") < 1 / 3
    st[17, dead] = 0.0
    nd = sw.n_diff_records(scene.n_point_lights, scene.emissive_sample_count)
    for depth in (0, 5):
        k, t = st.clone(), st.clone()
        rk = torch.full((nd, st.shape[1]), float("nan"), device="cuda")
        rt = torch.full_like(rk, float("nan"))
        sd = torch.tensor([77, depth], dtype=torch.int32, device="cuda")
        sw.bounce(scene, k, sd, opts, tables, records=rk)
        sw.bounce_reference(scene, t, depth, opts, tables, records=rt)
        torch.cuda.synchronize()
        assert not bool(torch.isnan(rk).any()), depth
        assert (rk[0, dead] == -1).all() and (rk[1:, dead] == 0).all(), depth
        assert torch.equal(rk.view(torch.int32), rt.view(torch.int32)), depth
        assert torch.equal(k.view(torch.int32), t.view(torch.int32)), depth
        assert torch.equal(k[:, dead].view(torch.int32), st[:, dead].view(torch.int32)), depth


# ---------------------------------------------------------------------------
# K6 and K5 as redesigned: the candidate scan on later rounds, larger tables
# and ragged windows (the groups widen where few rays are pending); the
# dense query's staged and L1 instances, ragged and unaligned rays, int64
# prim.
# ---------------------------------------------------------------------------


def _k6_matches_plain(bounds, rays, m):
    """K6 bit-equal to its plain version on one input; the plain ids."""
    from cpupathtrace_tpu_torch.accel import traverse as tt

    ik, ek = tt.candidates(bounds, rays, m)
    torch.cuda.synchronize()
    ip, ep = tt.candidates_reference(bounds, rays, m)
    assert torch.equal(ik, ip) and torch.equal(ek.view(torch.int32), ep.view(torch.int32))
    return ip


def _later_round(rays, ids, ent, m):
    """K6's rays of the next round: the bound past the last valid slot,
    +inf (nothing pending) where no slot was valid."""
    valid = ids[:m] >= 0
    last = valid.sum(0).clamp_min(1) - 1
    later = rays.clone()
    later[7] = torch.where(valid[0], ent.gather(0, last[None])[0], float("inf"))
    later[8] = torch.where(valid[0], ids.gather(0, last[None])[0].float(), float("inf"))
    return later


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4])
def test_candidate_scan_round_two_matches_plain(m):
    """K6 on round 2 of the dragon: the lower bound past round 1's last
    valid slot, rays with nothing pending written empty, windows of few
    pending rays on wider groups; ids equal, entries bit-equal."""
    _require_cuda()
    scene = _dragon()
    o, d = _query_rays(20000, seed=4)
    rays, (ids, ent) = _first_round(scene, o, d, m)
    later = _later_round(rays, ids, ent, m)
    pending = int((later[7] < float("inf")).sum())
    assert 0 < pending < later.shape[1]
    ip = _k6_matches_plain(scene.trv_bounds, later, m)
    assert int((ip[:m] >= 0).sum()) > 0
    third = _later_round(later, ip, _plain_entries(scene.trv_bounds, later, m), m)
    _k6_matches_plain(scene.trv_bounds, third, m)


def _plain_entries(bounds, rays, m):
    from cpupathtrace_tpu_torch.accel import traverse as tt

    return tt.candidates_reference(bounds, rays, m)[1]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 7])
def test_candidate_scan_on_2048_clusters(m):
    """K6 on a synthetic table of 2,048 clusters in the dragon's box (64 KB
    of staged bounds, past the 48 KB default), the dragon's first-round
    rays: bit-equal, overflow rows filled."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import intersect_sweep as isw

    scene = _dragon()
    o, d = _query_rays(12000, seed=5)
    rays, _ = _first_round(scene, o, d, m)
    ip = _k6_matches_plain(isw.synthetic_bounds(scene), rays, m)
    assert int((ip[m] >= 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("c", [37, 4096])
def test_candidate_scan_table_sizes(c):
    """K6 at 37 clusters (not a multiple of the lanes a ray) and at the
    4,096-cluster limit (128 KB of staged bounds), both rounds."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import intersect_sweep as isw

    scene = _dragon()
    o, d = _query_rays(3000, seed=6)
    rays, _ = _first_round(scene, o, d, 4)
    bounds = isw.synthetic_bounds(scene, c=c)
    ip = _k6_matches_plain(bounds, rays, 4)
    _k6_matches_plain(bounds, _later_round(rays, ip, _plain_entries(bounds, rays, 4), 4), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 65, 4097, 150001])
@pytest.mark.parametrize("pending", ["all", "none", "every_17th"])
def test_candidate_scan_ragged_windows(n, pending):
    """Ray counts around K6's windows (256 rays over the lanes a ray: 8 at
    a warp a ray, up to 4,097 rays here; 256 at one lane a ray, 150,001
    rays) with every, no or every 17th ray pending: each ray's slots
    written, bit-equal to the plain version."""
    _require_cuda()
    scene = _dragon()
    o, d = _query_rays(n, seed=7)
    rays, _ = _first_round(scene, o, d, 4)
    rays = rays.clone()
    if pending == "none":
        rays[7] = float("inf")
    elif pending == "every_17th":
        keep = torch.zeros(n, dtype=torch.bool, device="cuda")
        keep[::17] = True
        rays[7] = torch.where(keep, rays[7], float("inf"))
    ip = _k6_matches_plain(scene.trv_bounds, rays, 4)
    if pending == "none":
        assert bool((ip == -1).all())


@pytest.mark.cuda
def test_candidate_scan_refuses_unaligned_bounds():
    """K6 reads the bounds as 16-byte words: a table off a 16-byte
    boundary raises."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import traverse as tt

    flat = torch.zeros(8 * 40 + 1, device="cuda")
    with pytest.raises(ValueError, match="16-byte"):
        tt.candidates(flat[1:].view(40, 8), torch.zeros((tt.RAY_ROWS, 4), device="cuda"), 4)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["staged", "past_the_stage_limit"])
def test_dense_query_big_tables_match_plain(kind):
    """K5 on 1,000 random triangles (94 KB, staged in shared memory) and
    past its stage limit (read through L1): prim (int64), hit and t equal
    on every ray."""
    _require_cuda()
    from cpupathtrace_tpu_torch.experiments import intersect_sweep as isw
    from cpupathtrace_tpu_torch.ops import intersect as oi

    max_stage = oi.dense_occupancy(14, 1)[3]
    rows = 1000 if kind == "staged" else max_stage // (4 * oi.TRI_COLS) + 67
    o, d, tables = isw.big_table(rows=rows, rays=8192)
    assert (oi.dense_occupancy(rows, 3)[2] > 0) == (kind == "staged")
    scene = _scene("box")
    t, p = oi.dense_intersect(scene, o, d, tables, n_tri_rows=rows)
    torch.cuda.synchronize()
    tp, pp = oi.dense_intersect_reference(scene, o, d, tables, n_tri_rows=rows)
    assert p.dtype == torch.int64 and torch.equal(p, pp)
    assert torch.equal(t.view(torch.int32), tp.view(torch.int32))
    assert int((p >= 0).sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 255, 257, 262145])
def test_dense_query_ragged_and_unaligned_rays(n):
    """K5 at counts around its 256-ray blocks and past one wave of blocks,
    and on ray views off a 16-byte boundary: bit-equal, int64 prim, one
    launch a call."""
    _require_cuda()
    from cpupathtrace_tpu_torch.ops import intersect as oi

    scene = _scene("box")
    o, d = _query_rays(n + 1, seed=9)
    for oo, dd in ((o[:n], d[:n]), (o[1:], d[1:])):
        launches = oi.dense_intersect.launches
        t, p = oi.dense_intersect(scene, oo, dd)
        torch.cuda.synchronize()
        assert oi.dense_intersect.launches == launches + 1
        tp, pp = oi.dense_intersect_reference(scene, oo, dd)
        assert p.dtype == torch.int64 and torch.equal(p, pp)
        assert torch.equal(t.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
def test_dense_query_takes_unaligned_tables():
    """K5 reads table rows as scalars: tables off a 16-byte boundary give
    the same prim, hit and t as the plain version."""
    _require_cuda()
    from cpupathtrace_tpu_torch.ops import intersect as oi

    scene = _scene("box")
    tri, sph = oi.dense_tables(scene)
    flat = torch.zeros(tri.numel() + 1, device="cuda")
    flat[1:] = tri.reshape(-1)
    tables = (flat[1:].view(tri.shape), sph)
    o, d = _query_rays(4096, seed=10)
    t, p = oi.dense_intersect(scene, o, d, tables)
    torch.cuda.synchronize()
    tp, pp = oi.dense_intersect_reference(scene, o, d, (tri, sph))
    assert p.dtype == torch.int64 and torch.equal(p, pp)
    assert torch.equal(t.view(torch.int32), tp.view(torch.int32))


@pytest.mark.cuda
def test_scene_cache_pinned_loader_is_bit_equal(tmp_path):
    """load_scene onto the card through its two pinned buffers, with slices
    of 64 KB (the records and most tables span more than two): every field
    bit-equal to the saved scene, on the card; cached_build's hit the
    same."""
    _require_cuda()
    import dataclasses

    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.scene import cache

    scene = scenes.bench_dragon_scene(dragon_tris=20000, accel="binned", device="cpu")
    slice_bytes = 65536
    assert scene.krn_records.numel() * 4 > 2 * slice_bytes
    cache.save_scene(scene, tmp_path / f"k{cache.SUFFIX}")
    back = cache.load_scene(tmp_path / f"k{cache.SUFFIX}", device="cuda", slice_bytes=slice_bytes)
    hit, was_hit = cache.cached_build("k", lambda device: None, tmp_path, device="cuda")
    assert was_hit
    for loaded in (back, hit):
        for f in dataclasses.fields(scene):
            a, b = getattr(scene, f.name), getattr(loaded, f.name)
            if isinstance(a, torch.Tensor):
                assert b.device.type == "cuda" and b.dtype == a.dtype and b.shape == a.shape
                assert torch.equal(b.reshape(-1).view(torch.uint8).cpu(),
                                   a.reshape(-1).view(torch.uint8)), f.name
            else:
                assert a == b, f.name


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [None, "0"])
def test_resume_bit_identical_on_the_dragon(flag, tmp_path, monkeypatch):
    """render_resumable on the 200k dragon through the sorted driver's K2
    (the default) and K1's binned form (PTX_SORTED_WAVEFRONT=0): stopped
    after chunk 2 of 4 and resumed from its file, it equals the
    uninterrupted render bit for bit, and the resume renders 2 chunks."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import checkpoint
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import scenes

    monkeypatch.delenv("PTX_SORTED_WAVEFRONT", raising=False)
    if flag is not None:
        monkeypatch.setenv("PTX_SORTED_WAVEFRONT", flag)
    scene = scenes.bench_dragon_scene(device="cuda")
    cam = scenes.bench_camera(device="cuda")
    opts = RenderOptions(64, 64, 16, 16, epsilon=1e-3, max_depth=40)
    kw = dict(spp=16, spp_chunk=4, seed=3)
    mk.trace_megakernel.launches = sw.bounce.launches = 0
    full = checkpoint.render_resumable(scene, cam, opts, **kw)
    k1, k2 = mk.trace_megakernel.launches, sw.bounce.launches
    assert (k1 == 4 and k2 == 0) if flag == "0" else (k1 == 0 and k2 > 0)

    class Stop(Exception):
        pass

    def stop(done, total):
        if done == 2:
            raise Stop

    ckpt = str(tmp_path / "film.npz")
    with pytest.raises(Stop):
        checkpoint.render_resumable(scene, cam, opts, checkpoint_path=ckpt,
                                    progress_callback=stop, **kw)
    done = []
    resumed = checkpoint.render_resumable(scene, cam, opts, checkpoint_path=ckpt,
                                          progress_callback=lambda c, n: done.append(c), **kw)
    assert done == [3, 4]
    assert np.array_equal(resumed.pixel_sum, full.pixel_sum)
    assert np.array_equal(resumed.sample_count, full.sample_count)
    assert (full.sample_count > 0).all() and np.isfinite(full.pixel_sum).all()


@pytest.mark.cuda
def test_obj_dragon_through_the_bounce_kernel_equals_its_twin(tmp_path, monkeypatch):
    """A dragon loaded from an OBJ file by the C++ parser (forced below its
    1 MB threshold) through the sorted driver's K2: spectrum bit-equal to
    the twin's driver, the collected flags and per-bounce counters equal."""
    _require_cuda()
    from cpupathtrace_tpu_torch import native
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
    from cpupathtrace_tpu_torch.models import scenes
    from cpupathtrace_tpu_torch.scene import mesh

    path = tmp_path / "dragon.obj"
    path.write_text(scenes.standin_dragon_obj(6000))
    monkeypatch.setattr(mesh, "NATIVE_PARSE_MIN_BYTES", 0)
    runs = native.runs["parse_obj"]
    scene = scenes.bench_dragon_scene(dragon_obj=str(path), device="cuda")
    assert native.runs["parse_obj"] == runs + 1 and scene.accel == "binned"
    st = _camera_state(scene, n=4096)
    rays = Rays(st[1:4].t().contiguous(), st[4:7].t().contiguous())
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    launches = sw.bounce.launches
    k, kc, kv = sw.trace_megakernel_sorted(scene, rays, opts, 9, debug_visits=True)
    assert sw.bounce.launches > launches
    t, tc, tv = sw.trace_megakernel_sorted(scene, rays, opts, 9, reference=True,
                                           debug_visits=True)
    assert torch.equal(k.view(torch.int32), t.view(torch.int32))
    assert torch.equal(kc, tc) and torch.equal(kv, tv)


# ---------------------------------------------------------------------------
# The ablation instances of K1 and K2 (PTX_ABLATE / PTX_SKIP_TRAVERSE, read
# at each call from integrator/megakernel.py's attributes) and the
# profiling utilities on the card.
# ---------------------------------------------------------------------------

# Setting -> (_ABLATE, _SKIP_TRAVERSE), as tests/torch_util.py's
# ABLATE_SETTINGS (this file imports no test helper).
_ABLATIONS = {
    "nee": (frozenset({"nee"}), False),
    "bigpair": (frozenset({"bigpair"}), False),
    "prop": (frozenset({"prop"}), False),
    "mat": (frozenset({"mat"}), False),
    "skip": (frozenset(), True),
    "nee_skip": (frozenset({"nee"}), True),
}


def _ablate(monkeypatch, setting):
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    ablate, skip = _ABLATIONS[setting]
    monkeypatch.setattr(mk, "_ABLATE", ablate)
    monkeypatch.setattr(mk, "_SKIP_TRAVERSE", skip)


def _kernel_names(fn):
    """The names of the kernels fn() launches, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["nee", "bigpair", "prop", "mat"])
def test_k1_dense_ablation_instances_bit_equal_to_twin(setting, monkeypatch):
    """K1 dense's ablation instance (plain and counting) on the box's first
    8,192 rays, max_depth 40: bit-equal to the twin under the same setting,
    and different from the default frame (the switch was applied)."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene, rays = _scene("box"), _rays(forward=False)
    opts = RenderOptions(8, 8, 1, 1, max_depth=40)
    base, _ = mk.trace_megakernel(scene, rays, opts, 1234)
    _ablate(monkeypatch, setting)
    steps = torch.zeros(mk.BOUNCE_STEP_COLS, dtype=torch.int64, device="cuda")
    k, kc = mk.trace_megakernel(scene, rays, opts, 1234)
    c, _ = mk.trace_megakernel(scene, rays, opts, 1234, bounce_steps=steps)
    t, tc = mk.trace_megakernel_reference(scene, rays, opts, 1234)
    assert not bool(torch.isnan(k).any())
    assert torch.equal(k.view(torch.int32), t.view(torch.int32)) and torch.equal(kc, tc)
    assert torch.equal(c.view(torch.int32), k.view(torch.int32))
    mk.lane_use(steps.cpu())  # raises unless 0 < steps <= ray-bounces <= 32 x steps
    assert not torch.equal(k, base)
    names = _kernel_names(lambda: mk.trace_megakernel(scene, rays, opts, 1234))
    assert any("megakernel_ablate" in n for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(_ABLATIONS))
def test_k1_binned_ablation_instances_bit_equal_to_twin(setting, monkeypatch):
    """K1 binned's ablation instance (plain and counting) on 4,096 + 77
    camera rays of the 200k dragon: spectrum and counters equal to the twin
    under the same setting; under PTX_SKIP_TRAVERSE only the nearest
    queries count."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.core.rays import Rays
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    scene = _dragon_200k(56)
    st = _camera_state(scene, n=4096 + 77)
    rays = Rays(st[1:4].t().contiguous(), st[4:7].t().contiguous())
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    base, _ = mk.trace_megakernel(scene, rays, opts, 321)
    _ablate(monkeypatch, setting)
    k, kc, kv = mk.trace_megakernel(scene, rays, opts, 321, debug_visits=True,
                                    warp_steps=_warp_steps())
    plain, _ = mk.trace_megakernel(scene, rays, opts, 321)
    t, tc, tv = mk.trace_megakernel_reference(scene, rays, opts, 321, debug_visits=True)
    assert not bool(torch.isnan(k).any())
    assert torch.equal(k.view(torch.int32), t.view(torch.int32)) and torch.equal(kc, tc)
    assert torch.equal(plain.view(torch.int32), k.view(torch.int32)) and torch.equal(kv, tv)
    v = kv.sum(0)
    if _ABLATIONS[setting][1]:
        assert v[kt.QUERY_COL] > 0 and not bool(v[:kt.QUERY_COL].any())
    assert not torch.equal(k, base)


@pytest.mark.cuda
@pytest.mark.parametrize("setting", sorted(_ABLATIONS))
def test_k2_ablation_instances_bit_equal_to_twin(setting, monkeypatch):
    """K2's binned ablation instance (plain and counting) bounce after
    bounce on 4,096 + 77 camera rays of the 200k dragon, and its dense one
    on the box: the 18 planes (the rng plane included) and the counters
    equal to the twin's under the same setting."""
    _require_cuda()
    from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import megakernel as mk
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    _ablate(monkeypatch, setting)
    opts = RenderOptions(8, 8, 1, 1, epsilon=1e-3, max_depth=40)
    for scene in (_dragon_200k(56), _scene("box")):
        binned = scene.has_kernel_records
        tables = mk.pack_tables(scene)
        n = 4096 + 77
        st = _camera_state(scene, n=n)
        rows = -(-n // kt.VISIT_BLOCK)
        for depth in (0, 1, 5):
            sd = torch.tensor([77, depth], dtype=torch.int32, device="cuda")
            k, c, t = st.clone(), st.clone(), st.clone()
            kv = torch.zeros((rows, kt.GEO_VISIT_COLS), dtype=torch.int32, device="cuda")
            tv = torch.zeros_like(kv)
            sw.bounce(scene, k, sd, opts, tables)
            if binned:
                sw.bounce(scene, c, sd, opts, tables, visits=kv, warp_steps=_warp_steps())
                sw.bounce_reference(scene, t, depth, opts, tables, visits=tv)
                assert torch.equal(c.view(torch.int32), k.view(torch.int32)), depth
                assert torch.equal(kv, tv), depth
            else:
                sw.bounce_reference(scene, t, depth, opts, tables)
            assert torch.equal(k.view(torch.int32), t.view(torch.int32)), (depth, binned)
            st = k


@pytest.mark.cuda
@pytest.mark.parametrize("setting", ["nee", "skip"])
def test_k2_record_form_refuses_an_ablation_on_the_card(setting, monkeypatch):
    """K2's record form has no ablation instance: under a switch its wrapper
    raises before any launch."""
    _require_cuda()
    from cpupathtrace_tpu_torch.core.config import RenderOptions
    from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw

    scene = _dragon_200k(56)
    st = _camera_state(scene, n=1024)
    records = torch.empty((sw.n_diff_records(scene.n_point_lights,
                                             scene.emissive_sample_count), 1024), device="cuda")
    sd = torch.tensor([77, 0], dtype=torch.int32, device="cuda")
    _ablate(monkeypatch, setting)
    launches = sw.bounce.launches
    with pytest.raises(ValueError, match="record form"):
        sw.bounce(scene, st, sd, RenderOptions(8, 8, 1, 1), records=records)
    assert sw.bounce.launches == launches


@pytest.mark.cuda
def test_default_path_runs_no_ablation_instance():
    """With no switch set the box frame and the sorted dragon frame launch
    the default instances only (the kernels' names in the profile)."""
    _require_cuda()
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.models import scenes

    opts = pt.RenderOptions(16, 16, 4, 4, max_depth=8)
    cam = scenes.bench_camera(device="cuda")
    for scene, kernel in ((_scene("box"), "megakernel"),
                          (_dragon_200k(56), "bounce_binned_kernel")):
        names = _kernel_names(lambda: pt.render(scene, cam, opts, seed=1, device="cuda"))
        assert any(kernel in n for n in names) and not any("ablate" in n for n in names), names


@pytest.mark.cuda
def test_trace_annotation_under_nvtx_on_the_card(tmp_path):
    """On the card trace_annotation opens an NVTX range beside the profiler
    range, and profile_to writes one trace with the card's kernels and the
    annotation."""
    _require_cuda()
    import json
    import os

    from cpupathtrace_tpu_torch.utils.profiling import RayCounter, profile_to, trace_annotation

    counter = RayCounter(device="cuda").start()
    with profile_to(str(tmp_path)):
        with trace_annotation("budget/test/k1/base"):
            x = torch.ones(1 << 20, device="cuda").cumsum(0)
    counter.stop(1 << 20)
    assert float(x[-1]) == float(1 << 20) and counter.seconds > 0
    files = os.listdir(tmp_path)
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "budget/test/k1/base" for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
