"""The port's host builders (cpupathtrace_tpu_torch/accel/build.py and
cluster.py) against the JAX package's: the numpy flat BVH, the C++ flat
BVH (csrc/bvh_build.cpp, built with g++ on first use) and the cluster cut,
field by field and exactly (both packages do the same float32 reductions
and comparisons, so the trees are equal node for node)."""
import numpy as np
import pytest

from cpupathtrace_tpu.accel.build import build_bvh as jax_build_bvh
from cpupathtrace_tpu.accel.cluster import build_cluster_bvh as jax_cluster
from cpupathtrace_tpu.native import build_bvh_native as jax_native
from cpupathtrace_tpu_torch import _build
from cpupathtrace_tpu_torch.accel import build as port_build
from cpupathtrace_tpu_torch.accel.build import NATIVE_THRESHOLD, build_bvh, build_bvh_native
from cpupathtrace_tpu_torch.accel.cluster import build_cluster_bvh

BVH_FIELDS = ("lo", "hi", "left", "right", "prim", "depth")


def _boxes(n, seed):
    """Random small boxes [n,3] f32, with repeated minima so the median
    ties and the rebalance are exercised."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    c[: n // 8] = c[n // 8: 2 * (n // 8)]  # duplicate boxes
    half = rng.uniform(0.001, 0.05, (n, 3)).astype(np.float32)
    return c - half, c + half


def _assert_same_tree(ours, ref):
    for f in BVH_FIELDS:
        a, b = getattr(ours, f), getattr(ref, f)
        if f == "depth":
            assert a == b
            continue
        # Internal nodes of the numpy builders keep -1 children on leaves;
        # compare exactly, dtype and all.
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n", [1, 2, 7, 100, 300])
def test_numpy_bvh_matches_jax(n):
    lo, hi = _boxes(n, seed=n)
    _assert_same_tree(build_bvh(lo, hi, use_native=False),
                      jax_build_bvh(lo, hi, use_native=False))


@pytest.mark.parametrize("n", [NATIVE_THRESHOLD, 3000])
def test_native_bvh_matches_numpy_and_jax_native(n):
    """At n >= 512 the C++ build equals the port's numpy build and the JAX
    package's native build (leaves' child slots aside: the C++ leaves carry
    -1 as the numpy ones do)."""
    lo, hi = _boxes(n, seed=11 + n)
    before = dict(build_bvh.runs)
    native = build_bvh(lo, hi)  # n >= NATIVE_THRESHOLD picks the C++ builder
    assert build_bvh.runs["native"] == before["native"] + 1
    assert build_bvh.runs["numpy"] == before["numpy"]
    _assert_same_tree(native, build_bvh(lo, hi, use_native=False))
    ref = jax_native(lo, hi)
    for f, a, b in zip(BVH_FIELDS, (native.lo, native.hi, native.left, native.right,
                                    native.prim, native.depth), ref):
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_threaded_native_bvh_matches_jax_native():
    """From 65,536 primitives the C++ builder splits the top levels and
    builds the subtrees on worker threads; the tree stays the serial one."""
    lo, hi = _boxes(70000, seed=13)
    ours = build_bvh_native(lo, hi, want_subtree_info=True)
    ref = jax_native(lo, hi, want_subtree_info=True)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_native_subtree_info_matches_jax_native():
    lo, hi = _boxes(1500, seed=3)
    ours = build_bvh_native(lo, hi, want_subtree_info=True)
    ref = jax_native(lo, hi, want_subtree_info=True)
    assert len(ours) == len(ref) == 9
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


def test_below_threshold_runs_numpy():
    lo, hi = _boxes(NATIVE_THRESHOLD - 1, seed=5)
    before = dict(build_bvh.runs)
    build_bvh(lo, hi)
    assert build_bvh.runs["numpy"] == before["numpy"] + 1
    assert build_bvh.runs["native"] == before["native"]


@pytest.mark.parametrize("n,use_native", [(400, False), (2500, None), (2500, False)])
def test_cluster_cut_matches_jax(n, use_native):
    """members, c_lo, c_hi at the kernel's cluster size 56, through the
    native subtree path (n >= 512, use_native None) and the numpy sweeps."""
    lo, hi = _boxes(n, seed=n + 1)
    ours = build_cluster_bvh(lo, hi, cluster_size=56, use_native=use_native)
    ref = jax_cluster(lo, hi, cluster_size=56, use_native=use_native)
    assert ours.n_clusters == ref.n_clusters
    for f in ("members", "c_lo", "c_hi"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # Every primitive sits in exactly one cluster.
    m = ours.members[ours.members >= 0]
    np.testing.assert_array_equal(np.sort(m), np.arange(n))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """A C++ build that fails raises; it never falls back to numpy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "GXX_FLAGS", _build.GXX_FLAGS + ("-DPTX_NO_SUCH_FLAG", "--no-such-flag"))
    lo, hi = _boxes(NATIVE_THRESHOLD, seed=9)
    before = dict(build_bvh.runs)
    with pytest.raises(RuntimeError, match="build failed"):
        port_build.build_bvh(lo, hi)
    assert build_bvh.runs["numpy"] == before["numpy"]
