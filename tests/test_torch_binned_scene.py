"""The port's binned scene build against the JAX SceneBuilder: the
big/small partition, the root box, the 56-triangle clustering and its
traversal tiers, byte for byte on the columns the port keeps (records
0-27, bounds 0-6; the port's compact layout drops the TPU's 128-lane
padding and half-record bounds), and the megakernel tables of the binned
branch."""
import numpy as np
import pytest

from cpupathtrace_tpu.integrator.pallas_megakernel import (
    _pack_tables,
    megakernel_supported as jax_supported,
)
from cpupathtrace_tpu_torch.accel.kernel_traverse import BND_COLS, REC_COLS
from cpupathtrace_tpu_torch.integrator.megakernel import megakernel_supported, pack_tables
from cpupathtrace_tpu_torch.scene.scene import (
    ARRAY_FIELDS,
    KRN_FIELDS,
    STATIC_FIELDS,
    scene_from_numpy,
)
from tests.torch_util import CPU, dragon_scene, jax_scene_numpy, mixed_cull_scene

# The port keeps these leading columns of each JAX traversal table.
USED_COLS = dict(zip(KRN_FIELDS, (28, 7, 7, 7)))


def _scene(name, pkg):
    if name == "mixed_cull":
        return mixed_cull_scene(pkg)
    if name.startswith("demo"):
        # The smallest stand-in dragon that makes the demo binned (from
        # 4096 small triangles; the 2000-triangle demo is a sweep scene).
        if pkg == "jax":
            from cpupathtrace_tpu.models.scenes import cornell_demo_scene
        else:
            from cpupathtrace_tpu_torch.models.scenes import cornell_demo_scene
        if pkg == "jax":
            return cornell_demo_scene(dragon_tris=int(name[4:]))
        return cornell_demo_scene(dragon_tris=int(name[4:]), device=CPU)
    return dragon_scene(pkg, int(name[6:]))


@pytest.fixture(scope="module", params=["dragon1200", "dragon2000", "demo6000", "mixed_cull"])
def pair(request):
    return request.param, _scene(request.param, "jax"), _scene(request.param, "port")


def test_binned_build_matches_jax(pair):
    name, ref, ours = pair
    assert ours.accel == ref.accel == "binned"
    for f in ARRAY_FIELDS:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, (f, a.shape, b.shape)
        assert a.tobytes() == b.tobytes(), f
    for f in STATIC_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    assert ours.has_kernel_records and ours.krn_cluster_size == 56


def test_tiers_match_jax_on_used_columns(pair):
    name, ref, ours = pair
    for f, used in USED_COLS.items():
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.shape[:-1] == b.shape[:-1], (f, a.shape, b.shape)
        assert a.shape[-1] == (REC_COLS if f == "krn_records" else BND_COLS)
        assert np.ascontiguousarray(a[..., :used]).tobytes() == \
            np.ascontiguousarray(b[..., :used]).tobytes(), f
        assert not a[..., used:].any(), f  # the port's pad columns are zero


def test_binned_pack_tables_match_jax(pair):
    """The binned branch of _pack_tables: the triangle table holds the big
    partition, the emitters resolve through the full triangle arrays."""
    name, ref, ours = pair
    for what, a, b in zip(("tri", "sph", "mat", "lgt", "em"), pack_tables(ours),
                          _pack_tables(ref)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), what


def test_megakernel_supported_matches_jax(pair):
    name, ref, ours = pair
    assert megakernel_supported(ours) == bool(jax_supported(ref)) is True


def test_scene_from_numpy_carries_a_binned_jax_scene(pair):
    """scene_from_numpy compacts the JAX 128-lane tables: the carried scene
    equals the port's own build in every field."""
    name, ref, ours = pair
    arrays, meta = jax_scene_numpy(ref)
    carried = scene_from_numpy(arrays, meta, CPU)
    for f in ARRAY_FIELDS + KRN_FIELDS:
        a, b = getattr(carried, f).numpy(), getattr(ours, f).numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), f
    for f in STATIC_FIELDS:
        assert getattr(carried, f) == getattr(ours, f), f


def test_dragon_partition_and_cull_modes():
    """The 2000-triangle dragon: the box walls and the two emitters are the
    big partition (emitters forced dense), the glass dragon the clusters."""
    s = dragon_scene("port", 2000)
    assert s.n_big == 14 and s.emissive_in_dense
    assert s.krn_cull_mode == 0 and s.krn_big_cull_mode == -1
    big = s.big_prim[s.big_prim >= 0].numpy()
    assert set(s.emissive_prim[: s.n_emissive].tolist()) <= set(big.tolist())
    rec = s.krn_records.numpy()
    prims = rec[..., 17][rec[..., 17] >= 0].astype(np.int64)
    assert len(np.unique(prims)) == len(prims) == s.n_tri - s.n_big
    lo = s.root_lo.numpy()
    hi = s.root_hi.numpy()
    assert (lo < hi).all() and (hi - lo).max() < 2.0  # inside the 2x2x2 box


def test_lean_build():
    """lean=True is accepted for a binned scene and refused for any other
    accelerator; it packs the megakernel tables of the full build, and
    placeholders for the cluster blocks and the K6/K7 tables."""
    from cpupathtrace_tpu_torch.models.scenes import bench_box_scene, bench_dragon_scene
    from cpupathtrace_tpu_torch.scene.geometry import make_box
    from cpupathtrace_tpu_torch.scene.scene import SceneBuilder

    lean = bench_dragon_scene(dragon_tris=1200, accel="binned", lean=True, device=CPU)
    full = dragon_scene("port", 1200)
    for f in ARRAY_FIELDS + KRN_FIELDS:
        assert getattr(lean, f).numpy().tobytes() == getattr(full, f).numpy().tobytes(), f
    assert lean.lean and lean.blk_prim.shape == (1, 1) and lean.trv_bounds.shape[0] == 1
    assert not full.lean and full.trv_bounds.shape[0] == full.blk_prim.shape[0] > 1
    assert megakernel_supported(bench_box_scene(device=CPU))
    with pytest.raises(ValueError, match="lean"):
        SceneBuilder().add_triangles(make_box((-1, -1, -1), (1, 1, 1))).build(lean=True, device=CPU)


@pytest.mark.parametrize("smooth,cull,as_batch", [(True, False, True), (False, True, True),
                                                   (True, True, False)])
def test_mesh_from_arrays_matches_jax(smooth, cull, as_batch):
    """The numpy mesh pipeline (transform, face validation, smooth normals)
    gives the JAX package's triangles bit for bit, on the stand-in dragon
    with out-of-range, repeated-vertex and collinear faces added."""
    from cpupathtrace_tpu.scene.mesh import mesh_from_arrays as jax_mesh
    from cpupathtrace_tpu_torch.models.scenes import standin_dragon_arrays
    from cpupathtrace_tpu_torch.scene.mesh import mesh_from_arrays

    verts, faces = standin_dragon_arrays(600)
    n_v = verts.shape[0]
    bad = np.array([[0, 1, n_v], [-1, 2, 3], [4, 4, 5], [0, 1, 1]], np.int64)
    verts = np.concatenate([verts, [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]])
    collinear = np.array([[n_v, n_v + 1, n_v + 2]], np.int64)
    faces = np.concatenate([faces, bad, collinear])
    transform = np.array([[0.01, 0, 0, 0.1], [0, 0.01, 0, -0.5], [0, 0, 0.02, 0], [0, 0, 0, 1.0]])
    ours = mesh_from_arrays(verts, faces, transform, cull, smooth, as_batch)
    ref = jax_mesh(verts, faces, transform, cull, smooth, as_batch)
    assert len(ours) == len(ref) == faces.shape[0] - 4  # four invalid faces dropped
    if not as_batch:
        for a, b in zip(ours[::97], ref[::97]):
            for f in ("a", "b", "c", "na", "nb", "nc", "cull_backface", "material"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        return
    for f in ("v0", "v1", "v2", "n0", "n1", "n2", "cull", "material"):
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
