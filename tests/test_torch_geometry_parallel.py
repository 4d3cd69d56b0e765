"""The port's geometry-parallel paths (cpupathtrace_tpu_torch/parallel/
geometry.py and ops/intersect.py `gp_combine`) on gloo ranks on the CPU.

The host-side preparation is held to JAX's byte for byte: the sweep
path's padded cluster tables, and the fast path's per-shard records,
cluster bounds and rebuilt tiers at 1, 2, 3 and 4 shards of the
2,000-triangle stand-in dragon (two superclusters: at 2 shards each
shard's tiers are one page; at 3 and 4 some shards hold padding only).
`gp_combine` equals JAX's `_gp_combine` (shard_map over 4 virtual
devices) on per-shard hits with misses, ties on t and all-miss rays.
Within the port, one world of 4 gloo ranks (tests/torch_util.py
`gp_ranks`) shows JAX's contracts: the gp query at 4 and 2 ranks equals
the unsharded query bit for bit, nearest and any-hit with t_max, on both
paths, and the gp render at 2 ranks equals the one at 1 rank.
"""
import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch.accel.kernel_traverse import compact_kernel_tables
from cpupathtrace_tpu_torch.accel.traverse import krn_intersect
from cpupathtrace_tpu_torch.models.scenes import bench_dragon_scene
from cpupathtrace_tpu_torch.ops.intersect import scene_intersect
from cpupathtrace_tpu_torch.parallel import geometry as pg
from cpupathtrace_tpu_torch.parallel.distributed import spawn_ranks
from cpupathtrace_tpu_torch.scene.scene import KRN_FIELDS
from tests.torch_util import CPU, GP_RAYS, gp_combine_inputs, gp_ranks, gp_rays


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(gp_ranks, 4, "gloo", deadline_s=240, timeout_s=60)


@pytest.fixture(scope="module")
def dragons():
    """(JAX, port) 2,000-triangle dragons: sweep and binned."""
    from cpupathtrace_tpu.models.scenes import bench_dragon_scene as jdragon

    return {a: (jdragon(dragon_tris=2000, accel=a),
                bench_dragon_scene(dragon_tris=2000, accel=a, device=CPU))
            for a in ("sweep", "binned")}


def _bytes(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 7])
def test_sweep_padding_matches_jax(dragons, n):
    from cpupathtrace_tpu.parallel.geometry import shard_scene_geometry as jshard

    jscene, scene = dragons["sweep"]
    js, ts = jshard(jscene, n), pg.shard_scene_geometry(scene, n)
    assert ts.gp_shards == n and ts.accel == "sweep" and ts.blk_lo.shape[0] % n == 0
    for f in pg.SWEEP_SHARD_FIELDS:
        np.testing.assert_array_equal(_bytes(getattr(ts, f).numpy()), _bytes(getattr(js, f)), f)
    c = scene.blk_lo.shape[0]
    assert bool((ts.blk_prim[c:] < 0).all()) and bool(torch.isinf(ts.blk_lo[c:]).all())


def test_sweep_path_refuses_binned_scenes(dragons):
    with pytest.raises(ValueError, match="big-triangle partition"):
        pg.shard_scene_geometry(dragons["binned"][1], 4)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_kernel_shards_match_jax(dragons, n):
    """Per-shard records, cluster bounds and rebuilt tiers, byte for byte
    against JAX's stacked tables in the port's compact layout."""
    from cpupathtrace_tpu.parallel.geometry import shard_scene_kernel_geometry as jshard

    jscene, scene = dragons["binned"]
    js, ts = jshard(jscene, n), pg.shard_scene_kernel_geometry(scene, n)
    assert ts.krn_records.shape[0] == n and ts.gp_shards == n
    for i in range(n):
        want = compact_kernel_tables(*(np.asarray(getattr(js, f))[i] for f in KRN_FIELDS))
        for f, w in zip(KRN_FIELDS, want):
            np.testing.assert_array_equal(_bytes(getattr(ts, f)[i].numpy()), _bytes(w), (i, f))
    with pytest.raises(ValueError, match="already"):
        pg.shard_scene_kernel_geometry(ts, n)


def test_kernel_shards_cover_small_tiers(dragons):
    """The cases K4 must take: a shard whose tiers are one page, and shards
    that hold padding only."""
    scene = dragons["binned"][1]
    assert scene.krn_cl_bounds.shape[0] == 2
    two = pg.shard_scene_kernel_geometry(scene, 2)
    assert two.krn_sup_bounds.shape[1] == 1 and two.krn_cl_bounds.shape[1] == 1
    three = pg.shard_scene_kernel_geometry(scene, 3)
    assert float(three.krn_cl_bounds[2, ..., 6].max()) == 0.0  # no valid cluster
    assert float(three.krn_records[2, ..., 17].max()) == -1.0  # no prim


def test_gp_combine_matches_jax(ranks, cpu_devices):
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from cpupathtrace_tpu.ops.intersect import _gp_combine

    t, p = gp_combine_inputs()
    mesh = Mesh(np.array(cpu_devices[:4]), ("gp",))
    fn = jax.shard_map(lambda t, p: _gp_combine(t, p, "gp"), mesh=mesh,
                       in_specs=(P("gp"), P("gp")), out_specs=(P(), P()), check_vma=False)
    jt, jp = jax.jit(fn)(t.reshape(-1), p.reshape(-1))
    for r in ranks:
        ct, cp = r["combine"]
        np.testing.assert_array_equal(ct, np.asarray(jt))
        np.testing.assert_array_equal(cp, np.asarray(jp).astype(np.int64))
    jp = np.asarray(jp)
    assert (jp[:8] == -1).all() and (jp[8:24] >= 0).all()
    tied = t[:, 8:24] == np.float32(0.05)  # the tie wins: its smallest prim
    assert (tied.sum(0) >= 3).all()
    assert (jp[8:24] == np.where(tied, p[:, 8:24], 2**31 - 1).min(0)).all()


@pytest.mark.parametrize("path", ["sweep", "krn"])
@pytest.mark.parametrize("n", [4, 2])
def test_gp_query_equals_unsharded(ranks, dragons, path, n):
    """Nearest and any-hit (t_max 1.2) over n gloo ranks, bit for bit the
    unsharded query: the sweep's, and `krn_intersect` (K5 + K4)'s."""
    scene = dragons["sweep" if path == "sweep" else "binned"][1]
    o, d = (torch.from_numpy(a) for a in gp_rays())
    lim = torch.full((GP_RAYS,), 1.2)
    query = scene_intersect if path == "sweep" else krn_intersect
    want = [a.numpy() for a in query(scene, o, d) + query(scene, o, d, t_max=lim,
                                                            any_hit=True)]
    for r in ranks[:n]:
        for a, b in zip(r[path, n], want):
            np.testing.assert_array_equal(a, b)
    assert (want[1] >= 0).sum() > 100 and 0 < (want[3] >= 0).sum() < GP_RAYS


@pytest.mark.parametrize("path", ["sweep", "krn"])
def test_gp_render_shard_invariant(ranks, path):
    """The wavefront render at 2 gp ranks equals the one at 1 rank bit for
    bit (every rank draws the same stream)."""
    one = ranks[0][path, "img", 1]
    for r in ranks[:2]:
        np.testing.assert_array_equal(r[path, "img", 2], one)
    assert one.shape == (12, 12, 4) and one[..., 3].mean() == 1.0
    assert one[..., :3].mean() > 0.005
