"""The port's scene build (cpupathtrace_tpu_torch/scene) against the JAX
SceneBuilder: array for array and byte for byte, for the dense scenes of
the render path; the megakernel tables against JAX `_pack_tables`."""
import numpy as np
import pytest

from cpupathtrace_tpu.integrator.pallas_megakernel import _pack_tables
from cpupathtrace_tpu_torch.integrator.megakernel import (
    megakernel_supported,
    pack_tables,
)
from cpupathtrace_tpu_torch.scene.scene import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    SceneBuilder,
    scene_from_numpy,
)
from tests.torch_util import CPU, build_scene, jax_scene_numpy

SCENES = ["bench_box", "inward_box", "specular", "specular_point_light",
          "demo", "sphere_point_light"]


def _assert_same_bytes(ours: np.ndarray, ref: np.ndarray, what: str):
    assert ours.dtype == ref.dtype and ours.shape == ref.shape, (
        what, ours.dtype, ref.dtype, ours.shape, ref.shape)
    assert ours.tobytes() == ref.tobytes(), what


@pytest.mark.parametrize("name", SCENES)
def test_build_matches_jax(name):
    ref = build_scene(name, "jax")
    ours = build_scene(name, "port")
    for f in ARRAY_FIELDS:
        _assert_same_bytes(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)), f)
    for f in STATIC_FIELDS:
        assert getattr(ours, f) == getattr(ref, f), f
    assert megakernel_supported(ours)


@pytest.mark.parametrize("name", SCENES)
def test_pack_tables_match_jax(name):
    ref = _pack_tables(build_scene(name, "jax"))
    ours = pack_tables(build_scene(name, "port"))
    for what, a, b in zip(("tri", "sph", "mat", "lgt", "em"), ours, ref):
        _assert_same_bytes(a.numpy(), np.asarray(b), what)


@pytest.mark.parametrize("name", ["bench_box", "specular_point_light", "sphere_point_light"])
def test_scene_from_numpy_equals_own_build(name):
    arrays, meta = jax_scene_numpy(build_scene(name, "jax"))
    carried = scene_from_numpy(arrays, meta, CPU)
    ours = build_scene(name, "port")
    for f in ARRAY_FIELDS:
        _assert_same_bytes(getattr(carried, f).numpy(), getattr(ours, f).numpy(), f)
    for f in STATIC_FIELDS:
        assert getattr(carried, f) == getattr(ours, f), f


def test_pair_record_form_and_table_form():
    box = build_scene("bench_box", "port")
    assert box.dense_pair and box.krn_big_pair.shape == (16, 128)
    spheres = build_scene("sphere_point_light", "port")
    assert not spheres.dense_pair and spheres.n_tri == 0


def test_non_dense_scenes_raise():
    """Since the binned wavefront landed, every accelerator builds: the
    129-sphere scene is a bvh scene (no triangles to cluster), an explicit
    sweep / bvh / cluster box builds, the 2000-triangle demo dragon is a
    sweep scene, and scene_from_numpy carries a JAX sweep scene. What still
    raises: an unknown accelerator and a lean build that is not binned. An
    OBJ dragon path that cannot be read warns and is parsed as (empty) OBJ
    text, as in the JAX package."""
    from cpupathtrace_tpu_torch.models.scenes import cornell_demo_scene
    from cpupathtrace_tpu_torch.scene.geometry import make_box

    b = SceneBuilder()
    for i in range(129):
        b.add_sphere((float(i), 0.0, 0.0), 0.1)
    assert b.build(device=CPU).accel == "bvh"
    for accel in ("sweep", "bvh", "cluster"):
        box = SceneBuilder().add_triangles(make_box((-1, -1, -1), (1, 1, 1)))
        assert box.build(accel=accel, device=CPU).accel == accel
    with pytest.raises(ValueError, match="unknown accel"):
        SceneBuilder().add_triangles(make_box((-1, -1, -1), (1, 1, 1))).build(accel="kd", device=CPU)
    with pytest.raises(ValueError, match="lean"):
        SceneBuilder().add_triangles(make_box((-1, -1, -1), (1, 1, 1))).build(
            accel="sweep", lean=True, device=CPU)
    assert cornell_demo_scene(dragon_tris=2000, device=CPU).accel == "sweep"
    with pytest.warns(UserWarning, match="not a readable path"):
        no_dragon = cornell_demo_scene(dragon_obj="dragon.obj", device=CPU)
    assert no_dragon.n_tri == cornell_demo_scene(include_dragon=False, device=CPU).n_tri
    arrays, meta = jax_scene_numpy(build_scene("bench_box", "jax"))
    assert scene_from_numpy(arrays, dict(meta, accel="sweep"), CPU).accel == "sweep"
    with pytest.raises(ValueError, match="unknown accel"):
        scene_from_numpy(arrays, dict(meta, accel="kd"), CPU)


def test_scene_to_device_roundtrip():
    box = build_scene("bench_box", "port")
    assert box.to("cpu") is box
    assert str(box.device) == "cpu"
