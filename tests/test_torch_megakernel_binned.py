"""K1's binned while-loop form (cpupathtrace_tpu_torch/integrator/megakernel.py,
csrc/megakernel.cu with kBinned) on the CPU, where its plain-torch twin
stands in for the kernel; the film's PTX_SORTED_WAVEFRONT dispatch; and the
traversal counters (debug_visits) of the plain traversal.

The JAX side (trace_megakernel with n_super > 0 in Pallas interpret mode,
~40 s on the CPU) is committed in tests/fixtures/torch_mega_binned.npz
(make_torch_mega_binned_fixtures.py): 512 rays into the 1200-triangle
dragon of tests/test_megakernel.py:143, max_depth 4. Bounds (measured
values in the comments):
  * `collected` exactly equal on every ray (1.000);
  * the mean radiance within 1.5% (0.50%);
  * per ray, the spectrum within rtol 1e-5 / atol 1e-7 on >= 93% of rays
    (0.945; 0.854 bit-equal). The rays that differ took the other side of
    the emitter-NEE coin flip of tests/test_torch_megakernel.py (XLA:CPU
    fuses products into FMAs, the twin does not): a whole shadow-ray
    contribution, so they stay apart at rtol 0.1 (0.949). With 512 rays a
    few such flips move the mean by half a per cent.
The CUDA kernel is held against the twin, counters included, by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import film
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.integrator import rng as trng
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from tests.torch_util import (
    MEGA_BINNED_DEPTH,
    MEGA_BINNED_RAYS,
    MEGA_BINNED_SEED,
    build_scene,
    dragon_scene,
    jax_megakernel_binned,
    mega_binned_rays,
    query_rays,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_mega_binned.npz")
OPTS = RenderOptions(8, 8, 1, 1, max_depth=MEGA_BINNED_DEPTH)
RTOL, ATOL, FRAC, MEAN_REL = 1e-5, 1e-7, 0.93, 0.015


@pytest.fixture(scope="module")
def scene():
    return dragon_scene("port")


def _rays(o, d):
    return Rays(torch.from_numpy(o), torch.from_numpy(d))


def _twin(scene, **kw):
    return mk.trace_megakernel_reference(scene, _rays(*mega_binned_rays()), OPTS,
                                         MEGA_BINNED_SEED, **kw)


def _check(ours, ref):
    np.testing.assert_array_equal(ours[:, 3], ref[:, 3])
    a, b = float(ours[:, :3].mean()), float(ref[:, :3].mean())
    assert abs(a - b) <= MEAN_REL * abs(b), (a, b)
    close = np.isclose(ours, ref, rtol=RTOL, atol=ATOL).all(axis=1).mean()
    assert close >= FRAC, close


def test_twin_matches_jax_binned_kernel_outputs(scene):
    spec, coll = _twin(scene)
    assert spec.shape == (MEGA_BINNED_RAYS, 4) and coll.dtype == torch.bool
    _check(spec.numpy(), np.load(FIXTURE)["mega_binned"])


@pytest.mark.slow
def test_twin_matches_live_jax_binned_kernel(scene):
    _check(_twin(scene)[0].numpy(), jax_megakernel_binned())


@pytest.mark.parametrize("seed,pid", [(0, 0), (1234, 3), (2**31 - 1, 2147), (-5, 40)])
def test_binned_seed_matches_jax_8_row_blocks(seed, pid):
    """The binned kernel seeds by (pid, row, lane) of an 8 x 128 block:
    _seed_rng(seed + pid * 1000003, (8, 128)) (pallas_megakernel.py:410)."""
    import jax.numpy as jnp

    from cpupathtrace_tpu.integrator.pallas_megakernel import _seed_rng

    rows = trng.BINNED_BLOCK_ROWS
    block = rows * trng.LANES
    s = jnp.int32(seed) + jnp.int32(pid) * jnp.int32(trng.PID_STRIDE)
    ref = np.asarray(_seed_rng(s, (rows, trng.LANES))).reshape(-1)
    idx = torch.arange(pid * block, (pid + 1) * block)
    ours = trng.seed_rng(seed, idx, rows).numpy().astype(np.uint32)
    np.testing.assert_array_equal(ours, ref)
    # The dense blocks are 64 rows: past the first 1024 rays (rows 0-7 of
    # block 0 in both) the two streams differ.
    dense = trng.seed_rng(seed, idx).numpy().astype(np.uint32)
    assert np.array_equal(dense, ref) == (pid == 0)


def test_twin_seeds_binned_scenes_by_8_row_blocks(scene, monkeypatch):
    """The twin hands the 8-row block height to the seed for a binned scene
    and the 64-row one for a dense scene."""
    seen = []
    real = mk.seed_rng

    def spy(seed, idx, rows=trng.BLOCK_ROWS):
        seen.append(rows)
        return real(seed, idx, rows)

    monkeypatch.setattr(mk, "seed_rng", spy)
    rays = _rays(*mega_binned_rays())
    opts = RenderOptions(8, 8, 1, 1, max_depth=1)
    mk.trace_megakernel_reference(scene, rays, opts, 1)
    mk.trace_megakernel_reference(build_scene("bench_box", "port"), rays, opts, 1)
    assert seen == [trng.BINNED_BLOCK_ROWS, trng.BLOCK_ROWS]


# The tracer JAX film.py:98-106 picks: flag -> (box, binned dragon).
DISPATCH = {None: ("k1", "sorted"), "0": ("k1", "k1"), "1": ("sorted", "sorted")}


@pytest.mark.parametrize("flag", [None, "0", "1"])
@pytest.mark.parametrize("which", [0, 1], ids=["box", "binned_dragon"])
def test_sorted_wavefront_flag_picks_the_jax_tracer(flag, which, scene, monkeypatch):
    if flag is None:
        monkeypatch.delenv("PTX_SORTED_WAVEFRONT", raising=False)
    else:
        monkeypatch.setenv("PTX_SORTED_WAVEFRONT", flag)
    monkeypatch.delenv("PTX_NO_MEGAKERNEL", raising=False)
    sc = scene if which else build_scene("bench_box", "port")
    k1, k2 = mk.trace_megakernel_reference.calls, sw.bounce_reference.calls
    o, d = mega_binned_rays()
    spec, _ = film._dispatch_trace(sc, _rays(o[:64], d[:64]),
                                   RenderOptions(8, 8, 1, 1, max_depth=2),
                                   torch.Generator().manual_seed(0))
    ran = ("k1" if mk.trace_megakernel_reference.calls > k1 else "") + (
        "sorted" if sw.bounce_reference.calls > k2 else "")
    assert ran == DISPATCH[flag][which] and spec.shape == (64, 4)


def test_wrapper_takes_binned_scenes_and_counts(scene):
    calls, launches = mk.trace_megakernel_reference.calls, mk.trace_megakernel.launches
    spec, coll, vis = mk.trace_megakernel(scene, _rays(*mega_binned_rays()), OPTS,
                                          MEGA_BINNED_SEED, debug_visits=True)
    assert mk.trace_megakernel_reference.calls == calls + 1
    assert mk.trace_megakernel.launches == launches
    ref, _, vref = _twin(scene, debug_visits=True)
    assert torch.equal(spec, ref) and torch.equal(vis, vref)
    assert vis.shape == (1, kt.GEO_VISIT_COLS) and vis.dtype == torch.int32
    assert bool((vis > 0).all())
    # One nearest query per ray-bounce: at least one per ray, at most max_depth.
    assert MEGA_BINNED_RAYS <= int(vis[0, kt.QUERY_COL]) <= MEGA_BINNED_RAYS * MEGA_BINNED_DEPTH
    # A dense scene has no traversal to count.
    _, _, vbox = mk.trace_megakernel(build_scene("bench_box", "port"),
                                     _rays(*mega_binned_rays()), OPTS, 1, debug_visits=True)
    assert vbox.shape == (1, kt.GEO_VISIT_COLS) and not bool(vbox.any())
    meta = Rays(torch.zeros((8, 3), device="meta"), torch.zeros((8, 3), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        mk.trace_megakernel(scene, meta, OPTS, 1)


def test_counters_per_block_and_per_bounce(scene, monkeypatch):
    """trace_megakernel_reference's counters are per-ray counts summed per
    1024 rays; the sorted twin's are per bounce and per 1024 state
    positions, so the sort moves counts between rows but not between
    bounces."""
    o, d = mega_binned_rays()
    o, d = np.concatenate([o] * 5), np.concatenate([d] * 5)  # 2560 rays, 3 rows
    _, _, vis = mk.trace_megakernel_reference(scene, _rays(o, d), OPTS, 3, debug_visits=True)
    assert vis.shape == (3, kt.GEO_VISIT_COLS) and bool((vis[:2] > 0).all())
    monkeypatch.setattr(sw, "_SORT_MIN_ALIVE", 0)
    _, _, vs = sw.trace_megakernel_sorted(scene, _rays(o, d), OPTS, 3, debug_visits=True)
    _, _, vu = sw.trace_megakernel_sorted(scene, _rays(o, d), OPTS, 3, sort=False,
                                          debug_visits=True)
    assert vs.shape == (MEGA_BINNED_DEPTH, 3, kt.GEO_VISIT_COLS) and bool((vs[0] > 0).any())
    assert torch.equal(vs.sum(1), vu.sum(1)) and not torch.equal(vs, vu)


# ---------------------------------------------------------------------------
# The counters of the plain traversal against brute-force limits per ray.
# ---------------------------------------------------------------------------


def _entries(tables, o, d):
    """Every cluster's and supercluster's slab entry per ray, with no
    hierarchy: [C, n] and [S, n]."""
    _, clb, sup, _, _ = tables
    ox, oy, oz = (torch.from_numpy(o[:, j].copy()) for j in range(3))
    inv = [kt._inv_dir(torch.from_numpy(d[:, j].copy())) for j in range(3)]
    c_ent = kt.pair_slab_entries(clb.reshape(-1, kt.BND_COLS), ox, oy, oz, *inv)
    s_ent = kt.pair_slab_entries(sup.reshape(-1, kt.BND_COLS)[:clb.shape[0]], ox, oy, oz, *inv)
    return c_ent, s_ent


def _cols(o, d):
    return [torch.from_numpy(a[:, j].copy()) for a in (o, d) for j in range(3)]


def test_nearest_counts_within_brute_force_limits(scene):
    """Per ray: at least the clusters (superclusters) entered below the
    ray's final t, which the walk cannot prune, and at most those entered
    below its initial bound."""
    tables = kt.kernel_tables(scene)
    o, d = query_rays(1024, 11)
    n = o.shape[0]
    vis = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    bound = torch.full((n,), float("inf"))
    miss = torch.full((n,), -1, dtype=torch.int64)
    z = torch.zeros(n)
    t, p, *_ = kt.traverse_clusters(tables, *_cols(o, d), (bound, miss, z, z, z, miss),
                                    scene.krn_cull_mode, want_normal_mat=False, visits=vis)
    c_ent, s_ent = _entries(tables, o, d)
    for col, ent in ((1, c_ent), (0, s_ent)):
        lo = (ent < t[None]).sum(0)
        hi = torch.isfinite(ent).sum(0)
        assert bool((vis[:, col] >= lo).all() and (vis[:, col] <= hi).all()), col
    hit = p >= 0
    assert int(hit.sum()) > 100 and bool((vis[hit] > 0).all())
    # Pruning: hits stop the walk short of the clusters behind them.
    assert int(vis[:, 1].sum()) < int(torch.isfinite(c_ent).sum())


def test_anyhit_counts_within_brute_force_limits(scene):
    tables = kt.kernel_tables(scene)
    o, d = query_rays(1024, 12)
    n = o.shape[0]
    lim = torch.from_numpy(np.random.default_rng(12).uniform(0.05, 1.5, n).astype(np.float32))
    vis = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    occ = kt.traverse_clusters_anyhit(tables, *_cols(o, d), lim, scene.krn_cull_mode,
                                      visits=vis)
    c_ent, s_ent = _entries(tables, o, d)
    for col, ent in ((1, c_ent), (0, s_ent)):
        assert bool((vis[:, col] <= (ent < lim[None]).sum(0)).all()), col
    # An occluded ray visited at least its occluder's cluster; an
    # unoccluded one every cluster it entered below t_lim.
    assert int(occ.sum()) > 10 and bool((vis[occ, 1] >= 1).all())
    np.testing.assert_array_equal(vis[~occ, 1].numpy(), (c_ent < lim[None]).sum(0)[~occ].numpy())


def test_rays_that_do_not_query_count_zero(scene):
    """A ray that misses the root box counts nothing, nor does a shadow
    query with t_lim = 0."""
    tables = kt.kernel_tables(scene)
    n = 256
    o, d = query_rays(n, 13)
    away = o.copy()
    away[:, 2] = 50.0  # far behind the box, looking away from it
    dz = np.abs(d)
    vis = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    bound = torch.full((n,), float("inf"))
    miss = torch.full((n,), -1, dtype=torch.int64)
    z = torch.zeros(n)
    kt.traverse_clusters(tables, *_cols(away, dz), (bound, miss, z, z, z, miss),
                         scene.krn_cull_mode, want_normal_mat=False, visits=vis)
    assert not bool(vis.any())
    vis_s = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    occ = kt.traverse_clusters_anyhit(tables, *_cols(o, d), torch.zeros(n),
                                      scene.krn_cull_mode, visits=vis_s)
    assert not bool(occ.any()) and not bool(vis_s.any())


def test_cluster_query_counters_on_the_cpu(scene):
    """cluster_intersect(debug_visits=True) (K4's plain version here):
    [n_blocks, 4] sums of the per-ray counts."""
    o, d = query_rays(1500, 14)
    t, p, vis = kt.cluster_intersect(scene, torch.from_numpy(o), torch.from_numpy(d),
                                     debug_visits=True)
    assert vis.shape == (2, kt.WALK_COLS) and vis.dtype == torch.int32
    per_ray = torch.zeros((1500, kt.WALK_COLS), dtype=torch.int64)
    miss = torch.full((1500,), -1, dtype=torch.int64)
    z = torch.zeros(1500)
    kt.traverse_clusters(kt.kernel_tables(scene), *_cols(o, d),
                         (torch.full((1500,), float("inf")), miss, z, z, z, miss),
                         scene.krn_cull_mode, want_normal_mat=False, visits=per_ray)
    assert torch.equal(vis, kt.block_sums(per_ray))
    t2, p2 = kt.cluster_intersect(scene, torch.from_numpy(o), torch.from_numpy(d))
    assert torch.equal(t, t2) and torch.equal(p, p2)


def _walk(tables, o, d, bound, cull, any_hit):
    """One ray through the tiers as csrc/cluster_traverse.cuh walks them,
    box by box and record by record against its running bound: (descends,
    record visits, slab tests below the root gate, filled rows tested)."""
    rec, clb, sup, hyp, root = tables
    ray = [torch.tensor([float(v)]) for v in (*o, *d)]
    inv = [kt._inv_dir(v) for v in ray[3:]]
    mx = ray[1] * ray[5] - ray[2] * ray[4]
    my = ray[2] * ray[3] - ray[0] * ray[5]
    mz = ray[0] * ray[4] - ray[1] * ray[3]

    def entry(boxes):
        return kt.pair_slab_entries(boxes, *ray[:3], *inv)[:, 0]

    counts = [0, 0, 0, 0]
    bt = torch.tensor(bound)
    if not bool(entry(root)[0] < bt):
        return counts
    n_sup, hp = clb.shape[0], sup.shape[0]
    h_ent, s_ent = entry(hyp[:hp]), entry(sup.reshape(-1, kt.BND_COLS)[:n_sup])
    c_ent = entry(clb.reshape(-1, kt.BND_COLS))
    for h in range(hp):
        counts[2] += 1
        if not bool(h_ent[h] < bt):
            continue
        for s in range(h * kt.GROUP2, min(n_sup, (h + 1) * kt.GROUP2)):
            counts[2] += 1
            if not bool(s_ent[s] < bt):
                continue
            counts[0] += 1
            for c in range(s * kt.GROUP, (s + 1) * kt.GROUP):
                counts[2] += 1
                if not bool(c_ent[c] < bt):
                    continue
                counts[1] += 1
                cols = [rec[c, :, j] for j in range(17)]
                sd, _, _, st, ok = kt.pair_quantities(cols, *ray, mx, my, mz, cull)
                filled = (rec[c, :, kt.C_PRIM] >= 0).long()
                if any_hit:
                    rows = (ok & (st < bt * sd)).nonzero()
                    if rows.numel():
                        counts[3] += int(filled[:int(rows[0]) + 1].sum())
                        return counts
                    counts[3] += int(filled.sum())
                else:
                    counts[3] += int(filled.sum())
                    tv = st / torch.where(ok, sd, 1.0)
                    bt = torch.minimum(bt, torch.where(ok, tv, float("inf")).min())
    return counts


@pytest.fixture(scope="module")
def two_page_scene():
    """A 30,000-triangle dragon: two hyper pages of superclusters."""
    sc = dragon_scene("port", 30000)
    assert kt.kernel_tables(sc)[2].shape[0] == 2
    return sc


@pytest.mark.parametrize("any_hit", [False, True], ids=["nearest", "any_hit"])
@pytest.mark.parametrize("which", ["dragon1200", "two_pages"])
def test_counts_equal_a_walk_box_by_box(scene, two_page_scene, which, any_hit):
    """All four columns of the plain traversal's counters (descends, record
    visits, slab tests, filled rows tested) equal a box-by-box walk of each
    ray in the kernel's order, nearest and any-hit, on one hyper page and
    on two."""
    scene = scene if which == "dragon1200" else two_page_scene
    tables = kt.kernel_tables(scene)
    n = 192
    o, d = query_rays(n, 15)
    lim = np.random.default_rng(15).uniform(0.05, 1.5, n).astype(np.float32)
    vis = torch.zeros((n, kt.WALK_COLS), dtype=torch.int64)
    if any_hit:
        kt.traverse_clusters_anyhit(tables, *_cols(o, d), torch.from_numpy(lim),
                                    scene.krn_cull_mode, visits=vis)
    else:
        miss = torch.full((n,), -1, dtype=torch.int64)
        z = torch.zeros(n)
        kt.traverse_clusters(tables, *_cols(o, d),
                             (torch.full((n,), float("inf")), miss, z, z, z, miss),
                             scene.krn_cull_mode, want_normal_mat=False, visits=vis)
    walk = [_walk(tables, o[i], d[i], float(lim[i]) if any_hit else float("inf"),
                  scene.krn_cull_mode, any_hit) for i in range(n)]
    np.testing.assert_array_equal(vis.numpy(), np.array(walk))
    assert int((vis[:, 1] > 0).sum()) > 20
    if not any_hit:
        assert bool((vis[:, 2] >= kt.GROUP * vis[:, 0]).all())
