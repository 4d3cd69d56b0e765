"""The upstream demo scene on the port's normal path (models/scenes.py):
`cornell_full_scene` builds it lean binned through the scene cache, its
knobs set for the call only (tests/test_torch_binned_scene.py holds that
build against the JAX package's); and the film's candidate selection opens
its span and adds to its counter once a tile, only with `allow_bias`."""
import contextlib
import os

import numpy as np
import pytest
import torch

from cpupathtrace_tpu_torch import render
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.models import scenes
from cpupathtrace_tpu_torch.scene import cache
from cpupathtrace_tpu_torch.utils import profiling as tp
from tests.torch_util import CPU

DRAGON_TRIS = 6000


def _same_scene(a, b):
    for f in cache.ARRAY_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in cache.META_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


@contextlib.contextmanager
def _knobs(values):
    """DRAGON_FULL_KNOBS set to `values` (None: unset) inside, restored
    after."""
    saved = {k: os.environ.get(k) for k in scenes.DRAGON_FULL_KNOBS}
    try:
        for k in scenes.DRAGON_FULL_KNOBS:
            if values.get(k) is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = values[k]
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    d = tmp_path_factory.mktemp("cornell_cache")
    with _knobs({}):
        s, hit = scenes.cornell_full_scene(d, dragon_tris=DRAGON_TRIS, device=CPU)
        knobs_after = [k for k in scenes.DRAGON_FULL_KNOBS if k in os.environ]
    return d, s, hit, knobs_after


def test_cornell_full_scene_builds_lean_binned_with_its_sphere(full):
    from cpupathtrace_tpu_torch.integrator.megakernel import megakernel_supported

    _, s, hit, knobs_after = full
    assert not hit and not knobs_after
    assert s.lean and s.accel == "binned" and s.has_kernel_records
    assert s.krn_cluster_size == 128 and s.n_sph == 1 and s.emissive_in_dense
    assert 0 < s.n_big <= 128 and s.num_materials == 8
    assert megakernel_supported(s)


def test_cornell_full_scene_second_call_is_a_cache_hit(full):
    d, s, _, _ = full
    with _knobs(scenes.DRAGON_FULL_KNOBS):
        key = cache.build_cache_key("cornellfull", DRAGON_TRIS, "binned", "lean")
    assert [p.name for p in d.iterdir()] == [f"{key}{cache.SUFFIX}"]
    with _knobs({}):
        back, hit = scenes.cornell_full_scene(d, dragon_tris=DRAGON_TRIS, device=CPU)
    assert hit
    _same_scene(back, s)


def test_cornell_full_scene_is_the_lean_demo_scene(full):
    _, s, _, _ = full
    with _knobs(scenes.DRAGON_FULL_KNOBS):
        direct = scenes.cornell_demo_scene(dragon_tris=DRAGON_TRIS, accel="binned", lean=True,
                                           device=CPU)
    _same_scene(direct, s)


def _frame_spans(scene, allow_bias):
    opts = RenderOptions(16, 16, 4, 16, allow_bias=allow_bias, max_depth=4)
    before = tp.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        render(scene, scenes.cornell_demo_camera(16, 16, device=CPU), opts, seed=7)
    after = tp.counters()
    names = [e.name for e in prof.events()]
    return names, after["film.candidate_selects"] - before["film.candidate_selects"]


@pytest.mark.parametrize("allow_bias", [True, False])
def test_the_candidate_selection_opens_its_span_once_a_tile(full, allow_bias):
    """A 16x16 frame is one tile: one selection with allow_bias, none
    without."""
    _, s, _, _ = full
    names, selects = _frame_spans(s, allow_bias)
    assert selects == names.count("film.candidate") == (1 if allow_bias else 0)
    assert names.count("film.tile") == 1


def test_a_frame_of_several_tiles_selects_once_a_tile():
    scene = scenes.bench_box_scene(device=CPU)
    opts = RenderOptions(8, 8, 4, 16, allow_bias=True, max_depth=3)
    before = tp.counters()["film.candidate_selects"]
    render(scene, scenes.bench_camera(device=CPU), opts, seed=2, rays_per_launch=8 * 2)
    assert tp.counters()["film.candidate_selects"] - before == 4
