"""The port's full scene build and its sweep, cluster and bvh walkers
against the JAX package, and the bin-by-cluster entry points
(accel/binned.py, accel/cluster_major.py, K8's counterpart).

Builds: every array byte for byte, for the sweep, cluster, bvh and binned
accelerators (the per-primitive BVH only for accel="bvh", the one that
reads it). Walkers: on the same rays the prim of every ray is equal and t
agrees to XLA:CPU's FMA rounding (rtol 1e-5). K8's entry point against the
JAX bin-by-cluster intersector: the first of equal-t rows wins there and
the group rule of the kernels here, so a prim may differ only where two
triangles share the winning t; the JAX kernel itself (interpret mode) is
the slow test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpupathtrace_tpu.accel import binned as jbinned
from cpupathtrace_tpu.accel.cluster import build_cluster_bvh as jax_cluster
from cpupathtrace_tpu.ops import intersect as jis
from cpupathtrace_tpu_torch.accel import binned, cluster_major as cm, traverse as tt
from cpupathtrace_tpu_torch.accel.cluster import build_cluster_bvh
from cpupathtrace_tpu_torch.ops import intersect as tis
from cpupathtrace_tpu_torch.scene.scene import (
    ARRAY_FIELDS,
    BVH_FIELDS,
    CLUSTER_FIELDS,
    KRN_FIELDS,
    STATIC_FIELDS,
)
from tests.torch_util import CPU, binned_dragon, binned_rays

T_RTOL = 1e-5


def _soup(pkg, accel, n=300, seed=11, cluster_size=32, spheres=1):
    """tests/test_binned.py's scene: random triangles and a sphere (or
    `spheres` spheres in a row)."""
    if pkg == "jax":
        from cpupathtrace_tpu.scene.geometry import HostTriangle
        from cpupathtrace_tpu.scene.scene import SceneBuilder
    else:
        from cpupathtrace_tpu_torch.scene.geometry import HostTriangle
        from cpupathtrace_tpu_torch.scene.scene import SceneBuilder
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    tris = []
    for c in rng.uniform(-2, 2, (n, 3)):
        v = c + rng.uniform(-0.3, 0.3, (3, 3))
        tris.append(HostTriangle(v[0], v[1], v[2]))
    b.add_triangles(tris, 0)
    for i in range(spheres):
        b.add_sphere((0.3 * i, 0.0, 0.0), 0.4)
    if pkg == "jax":
        return b.build(accel=accel, cluster_size=cluster_size)
    return b.build(accel=accel, cluster_size=cluster_size, device=CPU)


def _soup_rays(n=512, seed=12):
    """Rays from around the soup toward its middle (the uniform rays of
    tests/test_binned.py hit little)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    d = (rng.uniform(-1.5, 1.5, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _scenes(name, accel):
    if name == "soup":
        return _soup("jax", accel), _soup("port", accel)
    if name == "small":  # 100 triangles and 40 spheres: a sweep scene by the rule
        return (_soup("jax", accel, n=100, spheres=40, cluster_size=None),
                _soup("port", accel, n=100, spheres=40, cluster_size=None))
    return binned_dragon("jax", accel), binned_dragon("port", accel)


def _rays(name):
    return _soup_rays() if name == "soup" else binned_rays(768, 1)


@pytest.mark.parametrize("accel", ["sweep", "cluster", "bvh", "binned", None])
@pytest.mark.parametrize("name", ["dragon", "soup", "small"])
def test_build_matches_jax(name, accel):
    """Every array of the build equal to the JAX SceneBuilder's, byte for
    byte (the per-primitive BVH for accel="bvh"; the traversal tiers of a
    binned scene on the port's kept columns); the static fields equal. A
    scene of at most 128 triangles packs its pair record whatever its
    accelerator (scene.py:719-734), so K1 takes the small sweep scene."""
    if name != "dragon" and accel == "binned":
        accel = "dense"  # no big partition to speak of
    ref, ours = _scenes(name, accel)
    assert ours.accel == ref.accel
    fields = ARRAY_FIELDS + CLUSTER_FIELDS + (BVH_FIELDS if ours.accel == "bvh" else ())
    for f in fields:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f
    for f in STATIC_FIELDS + (("bvh_depth",) if ours.accel == "bvh" else ()):
        assert getattr(ours, f) == getattr(ref, f), f
    used = dict(zip(KRN_FIELDS, (28, 7, 7, 7)))
    for f, k in used.items() if ours.has_kernel_records else ():
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert np.ascontiguousarray(a[..., :k]).tobytes() == np.ascontiguousarray(b[..., :k]).tobytes()
    if ours.accel != "bvh":
        assert ours.bvh_lo.shape == (1, 3) and ours.bvh_depth == 1  # the placeholder
    if name == "small":
        from cpupathtrace_tpu.integrator.pallas_megakernel import megakernel_supported as jax_ok
        from cpupathtrace_tpu_torch.integrator.megakernel import megakernel_supported

        assert ours.dense_pair and megakernel_supported(ours) == bool(jax_ok(ref)) is True


@pytest.mark.parametrize("n,use_native", [(400, False), (2500, None), (2500, False)])
def test_cluster_top_tree_matches_jax(n, use_native):
    """The top tree over clusters (lo, hi, left, right, cluster, depth) of
    the numpy sweeps and the native subtree path."""
    rng = np.random.default_rng(n)
    lo = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0, 0.1, (n, 3)).astype(np.float32)
    ours = build_cluster_bvh(lo, hi, cluster_size=128, use_native=use_native)
    ref = jax_cluster(lo, hi, cluster_size=128, use_native=use_native)
    assert ours.depth == ref.depth and ours.n_clusters == ref.n_clusters
    for f in ("lo", "hi", "left", "right", "cluster"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("accel", ["sweep", "cluster", "bvh"])
@pytest.mark.parametrize("name", ["dragon", "soup"])
def test_walker_matches_jax(name, accel):
    """The torch walker against the JAX one on the same rays."""
    ref, ours = _scenes(name, accel)
    o, d = _rays(name)
    jfn = {"sweep": jis.sweep_intersect, "cluster": jis.cluster_intersect,
           "bvh": jis.bvh_intersect}[accel]
    tfn = {"sweep": tis.sweep_intersect, "cluster": tis.cluster_intersect,
           "bvh": tis.bvh_intersect}[accel]
    jt, jp = (np.asarray(x) for x in jfn(ref, jnp.asarray(o), jnp.asarray(d)))
    t, p = tfn(ours, torch.from_numpy(o), torch.from_numpy(d))
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_allclose(t.numpy(), jt, rtol=T_RTOL, atol=0)
    assert (jp >= 0).sum() > 100 and (jp >= ref.n_tri).any() == (name == "soup")


@pytest.mark.parametrize("accel", ["sweep", "cluster", "bvh"])
def test_walkers_agree_with_the_dense_query_and_honour_t_max(accel):
    """Each walker finds the dense query's nearest hit on every ray; t_max
    turns hits at or beyond it into misses."""
    ours = _soup("port", accel)
    dense = _soup("port", "dense")
    o, d = (torch.from_numpy(x) for x in _soup_rays(seed=13))
    t, p = tis.scene_intersect(ours, o, d)
    td, pd = tis.scene_intersect(dense, o, d)
    assert torch.equal(p, pd) and torch.allclose(t, td, rtol=1e-6, atol=0)
    lim = torch.where(p >= 0, t, 1.0)
    lim[::2] *= 0.5
    tm, pm = tis.scene_intersect(ours, o, d, t_max=lim)
    assert (pm[p >= 0] == -1).all() and (tm[p >= 0] == -1.0).all()


def test_top_k_smallest_matches_lax_top_k():
    """The sweep's and the candidates' selection: ascending, the lower
    index first among equal values (entries tie at 0 for rays inside
    overlapping boxes), as jax.lax.top_k of the negation."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (64, 40)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = np.inf
    neg, idx = jax.lax.top_k(-jnp.asarray(x), 6)
    vals, tidx = tis.top_k_smallest(torch.from_numpy(x), 6)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))


def test_candidates_and_binning_match_jax():
    """generate_candidates and bin_candidates of accel/binned.py."""
    ref, ours = _soup("jax", "sweep"), _soup("port", "sweep")
    o, d = _soup_rays(128)
    jids, jent = jbinned.generate_candidates(ref, jnp.asarray(o), jnp.asarray(d), 6)
    ids, ent = binned.generate_candidates(ours, torch.from_numpy(o), torch.from_numpy(d), 6)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(ent.numpy(), np.asarray(jent))
    c = ours.blk_prim.shape[0]
    order, key, counts = binned.bin_candidates(ids, c)
    jorder, jkey, jcounts = jbinned.bin_candidates(jids, c)
    for a, b in ((order, jorder), (key, jkey), (counts, jcounts)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("max_candidates", [1, 4, 8])
def test_binned_intersect_matches_jax(max_candidates):
    """accel/binned.py's dense-stage intersector, residual round included
    (max_candidates=1 needs it on most rays)."""
    ref, ours = _soup("jax", "sweep"), _soup("port", "sweep")
    o, d = _soup_rays(seed=14)
    jt, jp = (np.asarray(x) for x in jbinned.binned_intersect(
        ref, jnp.asarray(o), jnp.asarray(d), max_candidates=max_candidates))
    t, p = binned.binned_intersect(ours, torch.from_numpy(o), torch.from_numpy(d),
                                   max_candidates=max_candidates)
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_allclose(t.numpy(), jt, rtol=T_RTOL, atol=0)


@pytest.mark.parametrize("name", ["soup", "dragon"])
def test_cluster_major_blocks_match_jax(name):
    """The blocks K8's stage runs on carry JAX's K8 layout
    (pallas_binned.pack_blocks: valid at column 10, prim at 11) byte for
    byte once put in K7's (prim at column 10, -1 where not valid); a
    binned scene that is not lean serves its own trv_blocks."""
    from cpupathtrace_tpu.accel.pallas_binned import pack_blocks as jpack

    ref, ours = _scenes(name, "sweep" if name == "soup" else "binned")
    jb = np.asarray(jpack(ref))
    expect = np.zeros_like(jb)
    expect[..., :10] = jb[..., :10]
    expect[..., tt.C_PRIM] = np.where(jb[..., 10] > 0.5, jb[..., 11], -1.0)
    blocks = cm.cluster_blocks(ours)
    assert blocks.numpy().tobytes() == expect.tobytes()
    assert (blocks is ours.trv_blocks) == (name == "dragon")


@pytest.mark.parametrize("max_candidates", [1, 4])
def test_cluster_major_entry_matches_jax(max_candidates):
    """K8's entry point (its plain compute stage on the CPU) against the
    JAX bin-by-cluster intersector on the same rays: prim equal but on
    exact-t ties, t to XLA's FMA rounding. Its stage equals K7's plain
    version on the binned pairs."""
    ref, ours = _soup("jax", "sweep"), _soup("port", "sweep")
    o, d = _soup_rays(seed=15)
    jt, jp = (np.asarray(x) for x in jbinned.binned_intersect(
        ref, jnp.asarray(o), jnp.asarray(d), max_candidates=max_candidates))
    calls = cm._test_candidates.calls
    t, p = cm.binned_intersect_cluster_major(ours, torch.from_numpy(o), torch.from_numpy(d),
                                             max_candidates)
    assert cm._test_candidates.calls == calls + 1
    tie = np.isclose(t.numpy(), jt, rtol=T_RTOL, atol=0)
    assert tie.all() and ((p.numpy() == jp) | tie).all() and (p.numpy() == jp).mean() > 0.99
    # The stage on the CPU is K7's rule on the binned pairs.
    blocks = cm.cluster_blocks(ours)
    ids, _ = binned.generate_candidates(ours, torch.from_numpy(o), torch.from_numpy(d), 4)
    ts, ps = cm._test_candidates(blocks, torch.from_numpy(o), torch.from_numpy(d), ids)
    order, _, counts = binned.bin_candidates(ids, blocks.shape[0])
    offs = torch.zeros(blocks.shape[0] + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(counts, 0)
    rays = torch.cat([torch.from_numpy(o).t(), torch.from_numpy(d).t()])[:, order // 4]
    tk, pk = tt.isect_reference(blocks, rays.contiguous(), offs)
    assert torch.equal(ts.reshape(-1)[order], tk) and torch.equal(ps.reshape(-1)[order], pk.long())


@pytest.mark.slow
def test_cluster_major_entry_matches_the_jax_kernel():
    """Against binned_intersect_pallas with `_cluster_kernel` in interpret
    mode (as tests/test_pallas_binned.py runs it)."""
    from cpupathtrace_tpu.accel.pallas_binned import binned_intersect_pallas
    from tests.torch_util import pallas_interpret

    ref, ours = _soup("jax", "sweep"), _soup("port", "sweep")
    o, d = _soup_rays(256, seed=16)
    with pallas_interpret():
        jt, jp = (np.asarray(x) for x in binned_intersect_pallas(
            ref, jnp.asarray(o), jnp.asarray(d), max_candidates=4))
    t, p = cm.binned_intersect_cluster_major(ours, torch.from_numpy(o), torch.from_numpy(d), 4)
    np.testing.assert_array_equal(p.numpy(), jp)
    np.testing.assert_allclose(t.numpy(), jt, rtol=T_RTOL, atol=0)
