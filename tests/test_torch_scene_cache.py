"""The port's scene cache (cpupathtrace_tpu_torch/scene/cache.py) against
the JAX package's (tests/test_scene_cache.py's cases on the 5000-triangle
binned dragon, and its lean form at PTX_KRN_CLUSTER=128): the round trip
bit for bit on every field and equal to the JAX build where the tables
are shared, renders unchanged by it, stale, junk and truncated files
refused, hits and misses, the key's knobs as JAX keys them, and the two
packages' caches kept apart."""
import dataclasses
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu.models.scenes import bench_dragon_scene as jax_dragon
from cpupathtrace_tpu.scene import cache as jcache
from cpupathtrace_tpu_torch import trace
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.integrator import megakernel as mk
from cpupathtrace_tpu_torch.models import scenes
from cpupathtrace_tpu_torch.scene import cache
from cpupathtrace_tpu_torch.scene.scene import (
    ARRAY_FIELDS,
    CLUSTER_FIELDS,
    TENSOR_FIELDS,
)
from tests.torch_util import CPU

DRAGON_TRIS = 5000


@pytest.fixture(scope="module")
def scene():
    # Binned, so the traversal tiers and the K6/K7 tables are filled.
    return scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, accel="binned", device=CPU)


@pytest.fixture(scope="module")
def lean():
    old = os.environ.get("PTX_KRN_CLUSTER")
    os.environ["PTX_KRN_CLUSTER"] = "128"
    try:
        return scenes.bench_dragon_scene(dragon_tris=DRAGON_TRIS, accel="binned", lean=True,
                                         device=CPU)
    finally:
        os.environ.pop("PTX_KRN_CLUSTER")
        if old is not None:
            os.environ["PTX_KRN_CLUSTER"] = old


def _assert_same_scene(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)), \
                f.name
        else:
            assert x == y and type(x) is type(y), f.name


def test_fields_are_the_scenes():
    assert set(cache.ARRAY_FIELDS) == set(TENSOR_FIELDS)
    assert not set(cache.ARRAY_FIELDS) & set(cache.META_FIELDS)


@pytest.mark.parametrize("which", ["full", "lean"])
def test_roundtrip_bit_identical(scene, lean, which, tmp_path):
    s = scene if which == "full" else lean
    assert s.lean == (which == "lean") and s.krn_cluster_size == (56 if which == "full" else 128)
    p = tmp_path / "scene.bin"
    cache.save_scene(s, p)
    _assert_same_scene(cache.load_scene(p, device=CPU), s)


def test_roundtrip_matches_the_jax_build(scene, tmp_path):
    """The reloaded port scene equals the JAX package's build of the same
    dragon on every table the two share, byte for byte."""
    p = tmp_path / "scene.bin"
    cache.save_scene(scene, p)
    back = cache.load_scene(p, device=CPU)
    ref = jax_dragon(dragon_tris=DRAGON_TRIS, accel="binned")
    for f in ARRAY_FIELDS + CLUSTER_FIELDS:
        a, b = getattr(back, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), f


def test_sliced_load_is_bit_identical(scene, tmp_path):
    """Slices far below the tables' sizes (many per table) land in place."""
    p = tmp_path / "scene.bin"
    cache.save_scene(scene, p)
    _assert_same_scene(cache.load_scene(p, device=CPU, slice_bytes=4096 + 4), scene)


def test_roundtrip_renders_identically(scene, tmp_path):
    """tests/test_scene_cache.py:43: the wavefront on the same 256 rays and
    seed gives the same bits on the reloaded scene, and so does K1's binned
    form (its plain version on the CPU)."""
    p = tmp_path / "scene.bin"
    cache.save_scene(scene, p)
    back = cache.load_scene(p, device=CPU)
    n = 256
    rng = np.random.default_rng(3)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -2.9
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = Rays(origin=torch.from_numpy(o), direction=torch.from_numpy(d))
    opts = RenderOptions(16, 16, 4, 4, epsilon=1e-3, max_depth=6)
    for run in (lambda s: trace(s, rays, opts, torch.Generator().manual_seed(11)),
                lambda s: mk.trace_megakernel(s, rays, opts, 11)):
        (s0, c0), (s1, c1) = run(scene), run(back)
        assert torch.equal(s0.view(torch.int32), s1.view(torch.int32))
        assert torch.equal(c0, c1)


def test_stale_and_junk_files_rejected(scene, tmp_path, monkeypatch):
    p = tmp_path / "scene.bin"
    monkeypatch.setattr(cache, "_FORMAT_VERSION", cache._FORMAT_VERSION + 1)
    cache.save_scene(scene, p)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="stale"):
        cache.load_scene(p, device=CPU)
    q = tmp_path / "junk.bin"
    q.write_bytes(b"definitely not a scene")
    with pytest.raises(ValueError, match="not a scene cache"):
        cache.load_scene(q, device=CPU)
    q.write_bytes(cache._MAGIC + b"\x05\x00\x00\x00\x00\x00\x00\x00[1,2]")
    with pytest.raises(ValueError, match="corrupt"):
        cache.load_scene(q, device=CPU)


def test_truncated_file_rejected(scene, tmp_path):
    p = tmp_path / "scene.bin"
    cache.save_scene(scene, p)
    data = p.read_bytes()
    p.write_bytes(data[: len(data) - 100])
    with pytest.raises(ValueError, match="truncated"):
        cache.load_scene(p, device=CPU)


def test_cached_build_hits_and_misses(scene, tmp_path):
    """tests/test_scene_cache.py:90: a miss builds (on the host) and saves,
    a hit loads; a corrupt file is a miss and is rebuilt."""
    calls = []

    def build(device):
        calls.append(device)
        return scene

    key = cache.build_cache_key("unit", DRAGON_TRIS, "binned")
    s1, hit1 = cache.cached_build(key, build, tmp_path, device=CPU)
    s2, hit2 = cache.cached_build(key, build, tmp_path, device=CPU)
    assert (hit1, hit2) == (False, True) and calls == ["cpu"]
    assert set(cache.cached_build.seconds) == {"load"}
    _assert_same_scene(s2, s1)
    (tmp_path / f"{key}{cache.SUFFIX}").write_bytes(b"garbage")
    s3, hit3 = cache.cached_build(key, build, tmp_path, device=CPU)
    assert hit3 is False and len(calls) == 2
    assert set(cache.cached_build.seconds) == {"build", "save", "move"}
    _assert_same_scene(s3, scene)
    _assert_same_scene(cache.load_scene(tmp_path / f"{key}{cache.SUFFIX}", device=CPU), scene)


ENV_CHANGES = [
    ("PTX_KRN_CLUSTER", "128"),
    ("PTX_KRN_MAX_TRIS", "9000000"),
    ("PTX_KRN_SAH", "0"),
    ("PTX_KRN_CLB_VMEM_MB", "64"),
    ("PTX_KRN_BLOCK_ROWS", "16"),
    ("PTX_SORTED_WAVEFRONT", "0"),
]


@pytest.mark.parametrize("var,value", ENV_CHANGES)
def test_cache_key_knobs_follow_jax(monkeypatch, var, value):
    """tests/test_scene_cache.py:124: the key changes with the parts; a
    knob changes the port's key exactly when it changes JAX's: every
    PTX_KRN_* variable but the two residency knobs, nothing else."""
    for k in [k for k in os.environ if k.startswith("PTX_")]:
        monkeypatch.delenv(k)
    k0, j0 = cache.build_cache_key("mesh.obj", 100), jcache.build_cache_key("mesh.obj", 100)
    assert k0 == cache.build_cache_key("mesh.obj", 100)
    assert k0 != cache.build_cache_key("mesh.obj", 101)
    monkeypatch.setenv(var, value)
    keyed = var.startswith("PTX_KRN_") and var not in cache.RESIDENCY_KNOBS
    assert (cache.build_cache_key("mesh.obj", 100) != k0) == keyed
    assert (jcache.build_cache_key("mesh.obj", 100) != j0) == keyed
    assert cache.build_cache_key("mesh.obj", 100, env_knobs=False) == \
        cache.build_cache_key("mesh.obj", 100, env_knobs=False)


def test_the_two_caches_stay_apart(scene, tmp_path):
    """Neither package reads the other's file; for the same parts the keys
    and the file names differ, so the port's cached_build in a directory
    shared with JAX leaves JAX's file alone."""
    jax_scene = jax_dragon(dragon_tris=1200, accel="binned")
    jkey = jcache.build_cache_key("shared", 1200)
    jcache.cached_build(jkey, lambda: jax_scene, tmp_path)
    jfile = tmp_path / f"{jkey}.ptxs"
    before = jfile.read_bytes()
    with pytest.raises(ValueError, match="not a scene cache"):
        cache.load_scene(jfile, device=CPU)
    key = cache.build_cache_key("shared", 1200)
    assert key != jkey
    port_scene = scenes.bench_dragon_scene(dragon_tris=1200, device=CPU)
    _, hit = cache.cached_build(key, lambda device: port_scene, tmp_path, device=CPU)
    assert hit is False and jfile.read_bytes() == before
    with pytest.raises(ValueError, match="not a scene cache"):
        jcache.load_scene(tmp_path / f"{key}{cache.SUFFIX}")
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [f"{jkey}.ptxs", f"{key}{cache.SUFFIX}"])


def test_dragon_full_scene_sets_its_knobs_around_the_build(tmp_path, monkeypatch):
    """renderSceneDragonBoxFull's helper at 5000 triangles: the lean binned
    build at 128-triangle records through the cache, the knobs set for the
    call only and keyed; the second call is a hit."""
    for k in scenes.DRAGON_FULL_KNOBS:
        monkeypatch.delenv(k, raising=False)
    s, hit = scenes.dragon_full_scene(tmp_path, dragon_tris=DRAGON_TRIS, device=CPU)
    assert not hit and s.lean and s.accel == "binned" and s.krn_cluster_size == 128
    assert not any(k in os.environ for k in scenes.DRAGON_FULL_KNOBS)
    for k, v in scenes.DRAGON_FULL_KNOBS.items():
        monkeypatch.setenv(k, v)
    key = cache.build_cache_key("dragonfull", DRAGON_TRIS, "binned", "lean")
    for k in scenes.DRAGON_FULL_KNOBS:
        monkeypatch.delenv(k)
    assert [p.name for p in tmp_path.iterdir()] == [f"{key}{cache.SUFFIX}"]
    back, hit = scenes.dragon_full_scene(tmp_path, dragon_tris=DRAGON_TRIS, device=CPU)
    assert hit
    _assert_same_scene(back, s)
    monkeypatch.setenv("PTX_KRN_CLUSTER", "64")  # a value already set wins, as in bench.py
    s64, hit = scenes.dragon_full_scene(tmp_path, dragon_tris=DRAGON_TRIS, device=CPU)
    assert not hit and s64.krn_cluster_size == 64 and os.environ["PTX_KRN_CLUSTER"] == "64"
