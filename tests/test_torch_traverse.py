"""The plain tiered cluster traversal (the K3 / K4 plain version,
cpupathtrace_tpu_torch/accel/kernel_traverse.py) on the CPU:

  * against the float64 oracle at tests/test_kernel_traverse.py's bounds:
    hit masks agree on > 99.5% of rays, t within 1e-4 relative at the
    99th percentile, prim on > 99% of common hits; any-hit > 99.9% outside
    the marginal band |t - t_lim| < 1e-4 * max(t_lim, 1);
  * against the JAX kernel (`cluster_intersect_kernel`, interpret mode),
    whose outputs are committed in tests/fixtures/torch_sorted.npz
    (make_torch_sorted_fixtures.py): nearest, any-hit, inactive lanes and
    mixed cull: hit masks and prims equal on every ray, t within the
    rounding of the pair test (bounds below);
  * the slab helpers against the JAX ones, bit for bit, including rays
    with zero direction components (FLT_MAX inverses) and NaN entries.
"""
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.accel import kernel_traverse as kt
from tests.torch_util import (
    QUERY_CASES,
    dragon_scene,
    jax_cluster_query,
    f64_oracle,
    query_inputs,
    query_rays,
    query_scene,
)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_sorted.npz")


@pytest.fixture(scope="module")
def fixture():
    return np.load(FIXTURE)


@pytest.fixture(scope="module")
def dragon():
    return dragon_scene("port", 2000)


def _query(scene, o, d, lim=None, any_hit=False):
    t, p = kt.cluster_intersect(scene, torch.from_numpy(o), torch.from_numpy(d),
                                None if lim is None else torch.from_numpy(lim), any_hit)
    return t.numpy(), p.numpy()


def _oracle_checks(t_k, p_k, t_o, p_o, min_hits):
    hit_k, hit_o = p_k >= 0, p_o >= 0
    assert (hit_k == hit_o).mean() > 0.995
    both = hit_k & hit_o
    assert both.sum() > min_hits
    rel = np.abs(t_k[both] - t_o[both]) / np.maximum(t_o[both], 1e-9)
    assert np.quantile(rel, 0.99) < 1e-4, rel.max()
    assert (p_k[both] == p_o[both]).mean() > 0.99


def test_nearest_matches_oracle(dragon):
    o, d = query_rays(2048, 1)
    t_k, p_k = _query(dragon, o, d)
    t_o, p_o = f64_oracle(dragon.krn_records.numpy(), o, d, np.full(2048, np.inf))
    _oracle_checks(t_k, p_k, t_o, p_o, 200)


def test_anyhit_matches_oracle(dragon):
    o, d = query_rays(2048, 2)
    lim = np.random.default_rng(102).uniform(0.05, 1.5, 2048).astype(np.float32)
    _, p_k = _query(dragon, o, d, lim, any_hit=True)
    t_o, _ = f64_oracle(dragon.krn_records.numpy(), o, d, lim)
    occ_k, occ_o = p_k >= 0, t_o >= 0
    assert occ_o.sum() > 100
    marginal = occ_o & (np.abs(t_o - lim) < 1e-4 * np.maximum(lim, 1.0))
    assert ((occ_k == occ_o) | marginal).mean() > 0.999


def test_inactive_lanes_skipped(dragon):
    o, d = query_rays(1024, 3)
    t, p = _query(dragon, o, d, np.zeros(1024, np.float32), any_hit=True)
    assert (p < 0).all() and (t == -1.0).all()
    # Nearest with a zero bound: nothing lies below it either.
    t, p = _query(dragon, o, d, np.zeros(1024, np.float32))
    assert (p < 0).all()


def test_mixed_cull_matches_oracle():
    scene = query_scene("mixed_cull", "port")
    assert scene.krn_cull_mode == -1
    o, d = query_rays(1024, 7)
    t_k, p_k = _query(scene, o, d)
    t_o, p_o = f64_oracle(scene.krn_records.numpy(), o, d, np.full(1024, np.inf))
    _oracle_checks(t_k, p_k, t_o, p_o, 150)


@pytest.mark.parametrize("case", list(QUERY_CASES))
def test_matches_jax_kernel_fixture(case, fixture):
    """The JAX kernel's outputs: hit mask and prim equal on every ray (the
    JAX kernel gates whole 128-lane rows by the union of the boxes they
    enter, the port gates each ray; a record passes the same per-triangle
    test either way, so only a tie of equal t across records could
    differ, and none occurs here). t agrees within rounding: the JAX
    interpret run is compiled by XLA for the CPU, whose products and sums
    may round differently. Measured: relative difference at most 1.1e-5
    on the dragon and 2.1e-4 on mixed cull, where the worst rays graze a
    triangle and both packages sit 2.1e-4 from the float64 oracle; the
    99th percentile is below 1e-5. Bounds: q99 < 2e-5, max < 5e-4."""
    _check_against_jax(case, fixture[f"query_{case}_t"], fixture[f"query_{case}_p"])


@pytest.mark.slow
@pytest.mark.parametrize("case", list(QUERY_CASES))
def test_matches_live_jax_kernel(case):
    """As above, against a live interpret-mode run of the JAX kernel."""
    _check_against_jax(case, *jax_cluster_query(case))


def _check_against_jax(case, t_j, p_j):
    name, o, d, lim, any_hit = query_inputs(case)
    t_k, p_k = _query(query_scene(name, "port"), o, d, lim, any_hit)
    np.testing.assert_array_equal(p_k, p_j)
    hit = p_j >= 0
    np.testing.assert_array_equal(t_k[~hit], t_j[~hit])
    if case in ("nearest", "anyhit", "mixed_cull"):
        assert hit.sum() > 100
    if hit.any():
        rel = np.abs(t_k[hit] - t_j[hit]) / np.abs(t_j[hit])
        assert np.quantile(rel, 0.99) < 2e-5 and rel.max() < 5e-4, (rel.max(), np.quantile(rel, 0.99))


def test_chunked_equals_whole(dragon, monkeypatch):
    """The ray and candidate chunking (which bounds memory at the main
    path's 262k x 4128 shape) changes nothing."""
    o, d = query_rays(1024, 4)
    whole = _query(dragon, o, d)
    lim = np.full(1024, 0.7, np.float32)
    whole_any = _query(dragon, o, d, lim, any_hit=True)
    monkeypatch.setattr(kt, "_CHUNK_ELEMS", 5000)
    for a, b in zip(_query(dragon, o, d), whole):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(_query(dragon, o, d, lim, any_hit=True), whole_any):
        np.testing.assert_array_equal(a, b)


def test_nearest_normals_and_materials(dragon):
    """traverse_clusters resolves the winner's shading normal (unit) and
    material, and improves only strictly on the incoming hit."""
    o, d = query_rays(512, 5)
    c = [torch.from_numpy(np.ascontiguousarray(a[:, j])) for a in (o, d) for j in range(3)]
    tables = kt.kernel_tables(dragon)
    inf = torch.full((512,), float("inf"))
    z = torch.zeros(512)
    miss = torch.full((512,), -1, dtype=torch.int64)
    t, p, nx, ny, nz, mid = kt.traverse_clusters(tables, *c, (inf, miss, z, z, z, miss),
                                                 dragon.krn_cull_mode)
    hit = p >= 0
    assert hit.sum() > 50
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)[hit]
    assert torch.allclose(norm, torch.ones_like(norm), atol=1e-5)
    glass = int(dragon.tri_material[p[hit][0]])
    assert (mid[hit] == glass).all()
    # A bound at exactly each winner's t admits nothing (strict improvement).
    t2, p2, *_ = kt.traverse_clusters(tables, *c, (t, p, nx, ny, nz, mid), dragon.krn_cull_mode)
    assert torch.equal(t2, t) and torch.equal(p2, p)


def test_slab_helpers_match_jax():
    import jax.numpy as jnp

    from cpupathtrace_tpu.accel import kernel_traverse as jkt

    rng = np.random.default_rng(11)
    n = 128
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:16, 0] = 0.0  # FLT_MAX inverses
    d[16:24, 1] = -0.0
    d[24:28] = 0.0  # no direction at all: 0 * FLT_MAX and NaN-free gates
    o[28:32, 0] = np.nan
    lo = rng.uniform(-1, 0, (24, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 1, (24, 3)).astype(np.float32)
    bnd = np.zeros((24, 128), np.float32)
    bnd[:, 0:3], bnd[:, 3:6], bnd[:, 6] = lo, hi, (np.arange(24) % 5 != 0)
    inv_j = [np.asarray(jkt._inv_dir(jnp.asarray(d[:, j]))) for j in range(3)]
    inv_p = [kt._inv_dir(torch.from_numpy(np.ascontiguousarray(d[:, j]))).numpy()
             for j in range(3)]
    for a, b in zip(inv_p, inv_j):
        np.testing.assert_array_equal(a, b)
    rays_j = [jnp.asarray(o[None, :, j]) for j in range(3)] + [jnp.asarray(v[None]) for v in inv_j]
    ent_j = np.asarray(jkt.pair_slab_entries(jnp.asarray(bnd), 1, *rays_j))[:, 0]
    rays_p = [torch.from_numpy(np.ascontiguousarray(o[:, j])) for j in range(3)]
    rays_p += [torch.from_numpy(v) for v in inv_p]
    ent_p = kt.pair_slab_entries(torch.from_numpy(bnd[:, :kt.BND_COLS].copy()), *rays_p).numpy()
    np.testing.assert_array_equal(ent_p, ent_j)
    # NaN origins give NaN entries, which no bound admits: they enter nothing.
    assert not (ent_p[:, 28:32] < np.inf).any()


def test_cluster_intersect_refuses_other_devices(dragon):
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        kt.cluster_intersect(dragon, o, o)
