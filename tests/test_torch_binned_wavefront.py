"""The port's binned wavefront (cpupathtrace_tpu_torch/accel/traverse.py)
against the JAX package: the plain versions of the candidate scan K6 and
the cluster-major intersect K7 against the JAX kernels in interpret mode,
the whole pipeline against `binned_intersect_tpu` and `binned_intersect_ref`,
the wavefront `trace` over binned and sweep scenes, and the dispatch.

The JAX kernel outputs, the pipeline's and the jnp wavefront's, are
committed in tests/fixtures/torch_binned.npz
(make_torch_binned_fixtures.py): their interpret-mode and while-loop
compiles take about a minute.

Bounds. The slab tests and the lexicographic insertion of K6 have no
product that XLA:CPU can fuse into an FMA, so its ids and entries are
equal bit for bit. K7's Möller-Trumbore sums are fused by XLA:CPU and not
by torch, so t agrees to a few ulp (rtol 1e-5; measured 3.4e-6 at
t = 0.35) while the prim, which the tie rule picks, is equal on every
pair. The pipeline gives JAX's prim on
every ray; for any-hit queries the hit need not be the nearest, so only
the occlusion is compared. The wavefront traces are per ray as
tests/test_torch_wavefront.py (the emitter self-occlusion race of ROADMAP
Queue 3 applies with emitter NEE).
"""
import os

import jax
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.accel.pallas_traverse import pack_blocks_np, pack_bounds_np
from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.accel import traverse as tt
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.integrator import wavefront
from cpupathtrace_tpu_torch.integrator.rng import RecordedDraws
from cpupathtrace_tpu_torch.ops import intersect as oi
from cpupathtrace_tpu_torch.scene.scene import CLUSTER_FIELDS, STATIC_FIELDS, scene_from_numpy
from tests.torch_util import (
    BINNED_CASES,
    CPU,
    TRACE_CASES,
    TRACE_DEPTH,
    TRACE_RAYS,
    binned_case_inputs,
    binned_dragon,
    binned_rays,
    jax_scene_numpy,
    jax_trace_draws,
    sorted_rays,
    trace_scene,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_binned.npz")
T_RTOL = 1e-5


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as f:
        return dict(f)


@pytest.fixture(scope="module")
def dragon():
    return binned_dragon("port")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# The tables.
# ---------------------------------------------------------------------------


def test_tables_equal_the_tpu_tables_untiled(dragon):
    """trv_blocks is pack_blocks_np's [C, L/64, 8, 128] tile layout with
    the tile permutation undone, trv_bounds is pack_bounds_np, byte for
    byte; the JAX scene carried across untiles to the same tables."""
    ref = binned_dragon("jax")
    blk = [np.asarray(getattr(ref, f)) for f in ("blk_v0", "blk_v1", "blk_v2", "blk_cull",
                                                  "blk_prim")]
    tiled = pack_blocks_np(*blk)
    assert tt.untile_blocks(tiled).tobytes() == dragon.trv_blocks.numpy().tobytes()
    assert tt.pack_blocks(*blk).tobytes() == dragon.trv_blocks.numpy().tobytes()
    assert np.asarray(ref.trv_blocks).tobytes() == tiled.tobytes()
    bounds = pack_bounds_np(np.asarray(ref.blk_lo), np.asarray(ref.blk_hi))
    assert bounds.tobytes() == dragon.trv_bounds.numpy().tobytes()
    carried = scene_from_numpy(*jax_scene_numpy(ref), CPU)
    for f in CLUSTER_FIELDS + ("trv_blocks", "trv_bounds"):
        assert getattr(carried, f).numpy().tobytes() == getattr(dragon, f).numpy().tobytes(), f
    for f in STATIC_FIELDS:
        assert getattr(carried, f) == getattr(dragon, f), f
    assert dragon.trv_blocks.shape == (dragon.trv_bounds.shape[0], 64, tt.BLK_COLS)


# ---------------------------------------------------------------------------
# K6 and K7 against the JAX kernels.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rnd", ["round1", "round2"])
@pytest.mark.parametrize("where", ["outside", "inside"])
@pytest.mark.parametrize("m", [1, 4])
def test_candidate_scan_matches_the_jax_kernel(fixture, dragon, m, where, rnd):
    """K6's plain version on the JAX kernel's inputs: ids equal, entries
    equal bit for bit, in the m kept slots and the overflow row; the JAX
    kernel's unused rows are empty. Round 2 carries a nonzero lower bound
    (entries tie at 0 for rays inside the dragon's boxes)."""
    name = f"cand_{m}_{where}_{rnd}"
    rays = _t(fixture[f"{name}_rays"])
    calls, launches = tt.candidates_reference.calls, tt.candidates.launches
    ids, ent = tt.candidates(dragon.trv_bounds, rays, m)
    assert tt.candidates_reference.calls == calls + 1 and tt.candidates.launches == launches
    ref_ids, ref_ent = fixture[f"{name}_ids"], fixture[f"{name}_ent"]
    np.testing.assert_array_equal(ids.numpy(), ref_ids[: m + 1])
    assert ent.numpy().tobytes() == ref_ent[: m + 1].tobytes()
    assert (ref_ids[m + 1:] == -1).all() and np.isinf(ref_ent[m + 1:]).all()
    assert (ids[0] >= 0).sum() > 10


def test_cluster_major_intersect_matches_the_jax_kernel(fixture, dragon):
    """K7's plain version per pair against `_isect_call` on the same pairs
    (JAX's 128-aligned layout compacted): prim equal on every pair, t to a
    few ulp where both hit."""
    t, p = tt.isect(dragon.trv_blocks, _t(fixture["isect_rays"]), _t(fixture["isect_offs"]))
    ref_t, ref_p = fixture["isect_t"], fixture["isect_prim"]
    np.testing.assert_array_equal(p.numpy(), ref_p)
    hit = ref_p >= 0
    assert hit.sum() > 100
    np.testing.assert_allclose(t.numpy()[hit], ref_t[hit], rtol=T_RTOL, atol=0)
    assert np.isinf(t.numpy()[~hit]).all() and np.isinf(ref_t[~hit]).all()


def test_isect_masks_pairs_to_their_cluster():
    """A pair takes only its own cluster's triangles (no spill into the
    next cluster's range); pairs past the last range stay (inf, -1); the
    tie rule picks the smallest prim of a group's equal-t rows."""
    blocks = torch.zeros((2, 8, tt.BLK_COLS))
    tri = torch.tensor([-1.0, -1.0, 1.0, 2.0, 0.0, 0.0, 0.0, 2.0, 0.0])  # z = 1 plane
    blocks[:, :, :9] = tri
    blocks[0, :, tt.C_PRIM] = torch.tensor([7.0, 3.0, 5.0, -1, -1, -1, -1, -1])
    blocks[1, :, tt.C_PRIM] = -1.0
    blocks[1, 2, tt.C_PRIM] = 9.0
    blocks[1, 2, 2] = 2.0  # cluster 1's triangle at z = 2
    rays = torch.tensor([[0.0, 0, 0, 0, 0, 1]] * 4).t().contiguous()
    t, p = tt.isect(blocks, rays, torch.tensor([0, 1, 3], dtype=torch.int32))
    assert p.tolist() == [3, 9, 9, -1] and t.tolist()[:3] == [1.0, 2.0, 2.0]


# ---------------------------------------------------------------------------
# The pipeline.
# ---------------------------------------------------------------------------


def _pipe(dragon, case):
    o, d, tm, lv, m, batch, any_hit = binned_case_inputs(case)
    return tt.binned_intersect(dragon, _t(o), _t(d), t_max=None if tm is None else _t(tm),
                               live=None if lv is None else _t(lv), any_hit=any_hit, m=m,
                               batch=batch)


@pytest.mark.parametrize("case", sorted(BINNED_CASES))
def test_pipeline_matches_the_jax_pipeline(fixture, dragon, case):
    """binned_intersect with the plain K6 / K7 against binned_intersect_tpu
    (interpret) and binned_intersect_ref of the JAX package: the prim of
    every ray (of every live ray with `live`; the occlusion for any-hit),
    t to a few ulp."""
    o, d, tm, lv, m, batch, any_hit = binned_case_inputs(case)
    t, p = (x.numpy() for x in _pipe(dragon, case))
    jt, jp = fixture[f"pipe_{case}_t"], fixture[f"pipe_{case}_p"]
    rt, rp = fixture[f"ref_{case}_t"], fixture[f"ref_{case}_p"]
    mask = np.ones(t.shape, bool) if lv is None else lv
    if any_hit:
        np.testing.assert_array_equal((p >= 0)[mask], (jp >= 0)[mask])
        np.testing.assert_array_equal((p >= 0)[mask], (rp >= 0)[mask])
        assert ((p < 0) | (t < tm)).all()
        return
    np.testing.assert_array_equal(p[mask], jp[mask])
    np.testing.assert_array_equal(p[mask], rp[mask])
    np.testing.assert_allclose(t[mask], jt[mask], rtol=T_RTOL, atol=0)
    assert (p[mask] >= 0).sum() > 300


@pytest.mark.parametrize("case", ["nearest_m4", "nearest_m1_inside", "anyhit_tmax"])
def test_pipeline_matches_its_oracle(dragon, case):
    """Against the port's own oracle (dense part + sweep): the same
    Möller-Trumbore operations, so t and prim are equal bit for bit."""
    o, d, tm, _, _, _, any_hit = binned_case_inputs(case)
    t, p = _pipe(dragon, case)
    rt, rp = tt.binned_intersect_ref(dragon, _t(o), _t(d), t_max=None if tm is None else _t(tm))
    if any_hit:
        assert torch.equal(p >= 0, rp >= 0)
        return
    assert torch.equal(p, rp) and torch.equal(t, rt)


def test_rounds_batches_and_host_reads(dragon):
    """m = 1 needs several rounds; batch = 1024 over 3072 rays several
    passes; one host read per query for the live count and one per round
    check. The CPU pipeline launches no kernel."""
    o, d = (_t(x) for x in binned_case_inputs("nearest_m1_inside")[:2])
    r0, h0, k0 = tt.binned_intersect.rounds, tt.binned_intersect.host_reads, tt.isect.launches
    tt.binned_intersect(dragon, o, d, m=1)
    rounds = tt.binned_intersect.rounds - r0
    assert rounds >= 4 and tt.binned_intersect.host_reads - h0 == rounds + 2
    assert tt.isect.launches == k0
    o, d = (_t(x) for x in binned_rays(3072, 6, inside=True))
    h0 = tt.binned_intersect.host_reads
    t1, p1 = tt.binned_intersect(dragon, o, d, batch=1024)
    assert tt.binned_intersect.host_reads - h0 >= 1 + 3 * 2  # >= 2 round checks per batch
    t2, p2 = tt.binned_intersect(dragon, o, d, batch=1 << 17)
    assert torch.equal(p1, p2) and torch.equal(t1, t2)


def test_krn_intersect_matches_the_jax_oracle(fixture, dragon):
    """krn_intersect (the dense part + the plain K4 traversal) against the
    JAX package's binned_intersect_ref: the K4 tests are Plücker, not
    Möller-Trumbore, so t differs in the last bits and a prim may differ
    only where two triangles share the winning t (rtol 1e-5)."""
    for case in ("nearest_m4", "anyhit_tmax", "batches"):
        o, d, tm, _, _, _, any_hit = binned_case_inputs(case)
        t, p = (x.numpy() for x in tt.krn_intersect(dragon, _t(o), _t(d), None if tm is None
                                                    else _t(tm), any_hit=any_hit))
        rt, rp = fixture[f"ref_{case}_t"], fixture[f"ref_{case}_p"]
        assert ((p >= 0) == (rp >= 0)).all(), case
        if not any_hit:
            tie = np.isclose(t, rt, rtol=1e-5, atol=0)
            assert ((p == rp) | tie).all() and tie.all() and (p == rp).mean() > 0.99, case


def test_wrappers_refuse_what_they_cannot_run(dragon):
    """Devices without a kernel raise; m outside 1..7 raises; a lean scene
    has no binned tables."""
    rays = torch.zeros((tt.RAY_ROWS, 4))
    with pytest.raises(ValueError, match="no kernel"):
        tt.candidates(dragon.trv_bounds.to("meta"), rays.to("meta"), 4)
    with pytest.raises(ValueError, match="no kernel"):
        tt.isect(dragon.trv_blocks.to("meta"), torch.zeros((6, 4), device="meta"),
                 torch.zeros(dragon.trv_blocks.shape[0] + 1, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="m = 8"):
        tt.candidates(dragon.trv_bounds, rays, 8)
    from cpupathtrace_tpu_torch.models.scenes import bench_dragon_scene

    lean = bench_dragon_scene(dragon_tris=5000, lean=True, device=CPU)
    assert lean.lean and lean.trv_bounds.shape[0] == 1
    with pytest.raises(ValueError, match="lean"):
        tt.binned_intersect(lean, torch.zeros((2, 3)), torch.ones((2, 3)))


# ---------------------------------------------------------------------------
# The dispatch.
# ---------------------------------------------------------------------------


def test_scene_intersect_dispatch(dragon, monkeypatch):
    """Binned scenes: the binned pipeline, or K4's traversal for lean scenes
    and under PTX_WAVEFRONT_KRN=1; sweep, cluster and bvh scenes their
    walkers; nothing raises."""
    o, d = (_t(x) for x in binned_case_inputs("nearest_m4")[:2])
    c0, k0 = tt.candidates_reference.calls, kt.cluster_intersect_reference.calls
    t, p = oi.scene_intersect(dragon, o, d)
    assert tt.candidates_reference.calls > c0 and kt.cluster_intersect_reference.calls == k0
    monkeypatch.setenv("PTX_WAVEFRONT_KRN", "1")
    c0 = tt.candidates_reference.calls
    tk, pk = oi.scene_intersect(dragon, o, d)
    assert tt.candidates_reference.calls == c0 and kt.cluster_intersect_reference.calls > k0
    assert (pk == p).float().mean() > 0.99
    monkeypatch.delenv("PTX_WAVEFRONT_KRN")
    for accel in ("sweep", "cluster", "bvh"):
        ts, ps = oi.scene_intersect(binned_dragon("port", accel), o, d)
        assert torch.equal(ps, p) and torch.allclose(ts, t, rtol=1e-6, atol=0), accel


def test_megakernel_supported_matches_jax(monkeypatch):
    """JAX's rule (pallas_megakernel.py:957-979) under the port's MAX_TRI:
    any scene without traversal tiers goes to the megakernel when its
    triangles fit, whatever its accelerator."""
    from cpupathtrace_tpu.integrator.pallas_megakernel import megakernel_supported as jax_ok
    from cpupathtrace_tpu.models.scenes import bench_box_scene as jbox, bench_dragon_scene as jd
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_dragon_scene

    cases = [(jbox(), bench_box_scene(device=CPU))]
    for tris in (300, 2000, 5000):
        cases.append((jd(dragon_tris=tris), bench_dragon_scene(dragon_tris=tris, device=CPU)))
    cases.append((jd(dragon_tris=300, accel="bvh"),
                  bench_dragon_scene(dragon_tris=300, accel="bvh", device=CPU)))
    monkeypatch.setenv("PTX_KRN_MAX_TRIS", "1000")
    cases.append((jd(dragon_tris=5000), bench_dragon_scene(dragon_tris=5000, device=CPU)))
    got = [(ours.accel, mk.megakernel_supported(ours), bool(jax_ok(ref))) for ref, ours in cases]
    assert [g[1] for g in got] == [g[2] for g in got], got
    assert [g[:2] for g in got] == [("dense", True), ("sweep", True), ("sweep", False),
                                    ("binned", True), ("bvh", True), ("binned", False)], got


def test_render_without_kernel_records_takes_the_wavefront(monkeypatch):
    """A binned scene built under a low PTX_KRN_MAX_TRIS has no kernel
    records: render() sends it to the wavefront by the dispatch alone
    (no switch set), whose binned pipeline runs; the sorted driver does
    not; no Morton pixel order."""
    import cpupathtrace_tpu_torch as pt
    from cpupathtrace_tpu_torch.integrator.film import use_pixel_order
    from cpupathtrace_tpu_torch.models.scenes import bench_camera, bench_dragon_scene

    monkeypatch.setenv("PTX_KRN_MAX_TRIS", "1000")
    scene = bench_dragon_scene(dragon_tris=5000, device=CPU)
    monkeypatch.delenv("PTX_KRN_MAX_TRIS")
    assert scene.accel == "binned" and not scene.has_kernel_records
    assert not use_pixel_order(scene, "cuda")
    assert use_pixel_order(bench_dragon_scene(dragon_tris=5000, device=CPU), "cuda")
    c0, b0 = tt.candidates_reference.calls, sw.bounce_reference.calls
    img = pt.render(scene, bench_camera(device=CPU), pt.RenderOptions(12, 12, 2, 2, max_depth=6),
                    seed=1)
    assert tt.candidates_reference.calls > c0 and sw.bounce_reference.calls == b0
    assert np.isfinite(img).all() and (img[..., 3] == 1.0).all()


def test_giant_scene_auto_coarsens(monkeypatch):
    """Beyond the bounds table the builder grows cluster_size until the cut
    fits, and beyond PTX_KRN_MAX_TRIS it packs no kernel records; the
    scene equals the JAX build under the same limits and intersects as
    its sweep build does (tests/test_traverse.py:168-192, scaled down)."""
    from cpupathtrace_tpu.accel import pallas_traverse
    from cpupathtrace_tpu.models.scenes import bench_dragon_scene as jd
    from cpupathtrace_tpu_torch.models.scenes import bench_dragon_scene

    monkeypatch.setattr(pallas_traverse, "MAX_CLUSTERS", 16)
    monkeypatch.setattr(tt, "MAX_CLUSTERS", 16)
    monkeypatch.setenv("PTX_KRN_MAX_TRIS", "1000")
    scene = bench_dragon_scene(dragon_tris=5000, accel="binned", device=CPU)
    ref = jd(dragon_tris=5000, accel="binned")
    assert scene.trv_bounds.shape[0] <= 16 and scene.cluster_size >= 5000 // 16
    assert scene.cluster_size == ref.cluster_size and scene.krn_cluster_size == 0
    for f in CLUSTER_FIELDS:
        assert getattr(scene, f).numpy().tobytes() == np.asarray(getattr(ref, f)).tobytes(), f
    sweep = bench_dragon_scene(dragon_tris=5000, accel="sweep", device=CPU)
    o, d = (_t(x) for x in binned_case_inputs("nearest_m1_inside")[:2])
    t, p = oi.scene_intersect(scene, o, d)
    ts, ps = oi.scene_intersect(sweep, o, d)
    assert torch.equal(p, ps) and torch.equal(t, ts)


# ---------------------------------------------------------------------------
# The wavefront over binned and sweep scenes.
# ---------------------------------------------------------------------------

# case -> share of rays within (rtol 1e-4, atol 1e-6) of JAX's; without
# emitter NEE every ray, with it the self-occlusion coin (measured values
# in the comments).
TRACE_CLOSE = {"binned": 0.55, "binned_no_em": 1.0, "sweep": 0.55, "sweep_no_em": 1.0}


def _port_trace(case, differentiable=False, scene=None):
    scene = trace_scene(case, "port") if scene is None else scene
    o, d = sorted_rays(TRACE_RAYS)
    draws = RecordedDraws(jax_trace_draws(jax.random.PRNGKey(5), TRACE_RAYS,
                                          scene.emissive_sample_count, TRACE_DEPTH))
    return wavefront.trace(scene, Rays(_t(o), _t(d)), RenderOptions(8, 8, 1, 1,
                           max_depth=TRACE_DEPTH), draws, differentiable)


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_trace_matches_jax_per_ray(fixture, case):
    """The wavefront trace through the binned pipeline (binned) or the sweep
    walker (sweep) against the JAX trace on its own draws."""
    spec, coll = _port_trace(case)
    ref, ref_coll = fixture[f"trace_{case}_spec"], fixture[f"trace_{case}_coll"]
    np.testing.assert_array_equal(coll.numpy(), ref_coll)
    close = np.isclose(spec.numpy(), ref, rtol=1e-4, atol=1e-6).all(axis=1).mean()
    assert close >= TRACE_CLOSE[case], close
    a, b = float(spec[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= 0.01 * b, (a, b)


def test_differentiable_trace_gradients_match_jax(fixture):
    """The differentiable trace on the binned dragon (geometry detached into
    the binned pipeline): finite material gradients equal to jax.grad of
    the JAX trace on the same draws, within 5e-5 of the largest entry
    (float32 reassociation of the sums over rays; measured 1.4e-5)."""
    import dataclasses

    scene = trace_scene("binned_no_em", "port")
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in ("mat_diffuse", "mat_emission")}
    spec, _ = _port_trace("binned_no_em", True, dataclasses.replace(scene, **leaves))
    spec[:, :3].mean().backward()
    scale = max(float(np.abs(fixture[f"grad_{f}"]).max()) for f in leaves)
    assert scale > 0
    for f, v in leaves.items():
        assert torch.isfinite(v.grad).all()
        np.testing.assert_allclose(v.grad.numpy(), fixture[f"grad_{f}"], rtol=0,
                                   atol=5e-5 * scale, err_msg=f)


@pytest.mark.slow
def test_fixture_matches_the_live_jax_kernels(fixture):
    """The committed fixture is what the JAX kernels compute today (K6 in
    interpret mode and the interpret pipeline on one case)."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.accel import pallas_traverse as jpt
    from tests.torch_util import jax_cand_inputs

    scene = binned_dragon("jax")
    live = jax_cand_inputs(scene, True, 4)
    for rnd, (rows, ids, ent) in live.items():
        np.testing.assert_array_equal(ids, fixture[f"cand_4_inside_{rnd}_ids"])
        np.testing.assert_array_equal(ent, fixture[f"cand_4_inside_{rnd}_ent"])
    o, d, *_ = binned_case_inputs("nearest_m4")
    t, p = jpt.binned_intersect_tpu(scene, jnp.asarray(o), jnp.asarray(d), batch=1024,
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(p), fixture["pipe_nearest_m4_p"])
