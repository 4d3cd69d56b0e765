"""The port's spans and counters (cpupathtrace_tpu_torch/utils/profiling.py):
under a CPU torch.profiler session a frame and a gradient pass emit the
span tree of each layer boundary, nested as the calls nest; with no session
a span is a shared no-op that calls neither record_function nor NVTX; and
`counters()` takes the drivers' counts, the live rays among them equal to
counts summed from the twin's own state.
"""
import pytest
import torch

from cpupathtrace_tpu_torch import render
from cpupathtrace_tpu_torch.core.config import RenderOptions
from cpupathtrace_tpu_torch.core.rays import Rays
from cpupathtrace_tpu_torch.diff.render import get_material_params, loss_and_grad
from cpupathtrace_tpu_torch.integrator import diff_megakernel as dm
from cpupathtrace_tpu_torch.integrator import sorted_wavefront as sw
from cpupathtrace_tpu_torch.models import scenes
from cpupathtrace_tpu_torch.utils import profiling as tp
from tests.torch_util import CPU, dragon_scene, sorted_rays

LAYERS = ("film", "camera", "k1", "sorted", "diff")

# (span, the innermost span around it) of a frame, by tracer.
FRAME_TREE = {
    "k1": {"film.tile": "film.render", "film.chunk": "film.tile", "camera.shoot": "film.chunk",
           "k1.trace": "film.chunk", "film.fold": "film.tile",
           "film.image_read": "film.render"},
    "sorted": {"film.tile": "film.render", "film.chunk": "film.tile",
               "camera.shoot": "film.chunk", "sorted.trace": "film.chunk",
               "sorted.bounce": "sorted.trace", "sorted.live_read": "sorted.trace",
               "sorted.sort": "sorted.trace", "sorted.unpermute": "sorted.trace",
               "film.fold": "film.tile", "film.image_read": "film.render"},
}
GRAD_TREE = {"film.chunk": "diff.loss_and_grad", "camera.shoot": "film.chunk",
             "diff.record": "film.chunk", "diff.live_read": "diff.record",
             "diff.preprocess": "film.chunk", "diff.grad": "diff.loss_and_grad",
             "diff.backward": "diff.grad"}


def _is_span(name):
    return name.split(".")[0] in LAYERS and "." in name


def _spans(fn):
    """[(span, innermost enclosing span or None)] of the program's spans
    that `fn` emits under a CPU profiler session, in order."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for e in prof.events():
        if _is_span(e.name):
            p = e.cpu_parent
            while p is not None and not _is_span(p.name):
                p = p.cpu_parent
            out.append((e.name, None if p is None else p.name))
    return out


def _tree_holds(spans, tree, root):
    roots = [n for n, p in spans if p is None]
    assert roots == [root], roots
    assert {n for n, _ in spans} == set(tree) | {root}, spans
    for name, parent in spans:
        assert parent == tree.get(name, None), (name, parent)


@pytest.mark.parametrize("tracer", ["k1", "sorted"])
def test_a_frame_emits_the_span_tree(tracer, monkeypatch):
    if tracer == "k1":
        scene = scenes.bench_box_scene(device=CPU)
    else:
        scene = dragon_scene("port")
        monkeypatch.setattr(sw, "_SORT_MIN_ALIVE", 0)  # sort after every bounce
    opts = RenderOptions(4, 4, 8, 8, max_depth=3)
    spans = _spans(lambda: render(scene, scenes.bench_camera(device=CPU), opts, seed=5))
    _tree_holds(spans, FRAME_TREE[tracer], "film.render")
    names = [n for n, _ in spans]
    assert names.count("film.fold") == 1  # 8 spp: 4 stats batches of 2 in one launch
    if tracer == "sorted":
        assert names.count("sorted.bounce") == names.count("sorted.live_read") >= 2


def test_a_gradient_pass_emits_the_gradient_spans():
    scene = scenes.bench_box_scene(device=CPU)
    opts = RenderOptions(4, 4, 2, 2, max_depth=3)
    spans = _spans(lambda: loss_and_grad(get_material_params(scene), scene,
                                         scenes.bench_camera(device=CPU), opts,
                                         torch.zeros(16, 4), 3, 2))
    _tree_holds(spans, GRAD_TREE, "diff.loss_and_grad")


def test_an_adaptive_frame_counts_its_folds_and_flag_reads():
    """16 launches of 4 stats batches; the all-frozen flag is read from the
    min count on, each read in its own span."""
    scene = scenes.bench_box_scene(device=CPU)
    opts = RenderOptions(2, 2, 4, 64, max_depth=2)
    before = tp.counters()
    spans = _spans(lambda: render(scene, scenes.bench_camera(device=CPU), opts, seed=1))
    after = tp.counters()
    names = [n for n, _ in spans]
    reads = after["film.flag_reads"] - before["film.flag_reads"]
    assert reads == names.count("film.flag_read") >= 1
    assert ("film.flag_read", "film.tile") in spans
    batches = after["film.stats_batches"] - before["film.stats_batches"]
    assert batches == 4 * names.count("film.fold")


@pytest.mark.parametrize("recording", [False, True])
def test_a_span_records_only_in_a_session(recording, monkeypatch):
    calls = {"record_function": 0, "nvtx": 0}
    real = torch.profiler.record_function

    def counted_rf(name):
        calls["record_function"] += 1
        return real(name)

    class CountedRange:
        def __init__(self, name):
            calls["nvtx"] += 1

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", counted_rf)
    monkeypatch.setattr(torch.cuda.nvtx, "range", CountedRange)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    if recording:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tp.trace_annotation("film.fold"):
                torch.ones(4).sum()
        assert calls == {"record_function": 1, "nvtx": 1}
    else:
        with tp.trace_annotation("film.fold"):
            torch.ones(4).sum()
        assert calls == {"record_function": 0, "nvtx": 0}
        assert tp.trace_annotation("a.b") is tp.trace_annotation("c.d")


def test_entering_a_profile_sets_the_module_flag():
    """The flag trace_annotation reads: a torch that renames it fails here
    instead of dropping every span."""
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert flag() is True
    assert flag() is False


def _alive_counts(scene, o, d, opts, seed):
    """The rays alive entering each bounce, from the twin's own state
    (unsorted: sorting moves no ray's result)."""
    st = sw.initial_state(o, d, seed)
    n, depth, counts = o.shape[0], 0, []
    while depth < opts.max_depth and n > 0:
        counts.append(n)
        sw.bounce_reference(scene, st, depth, opts)
        n = int((st[17] > 0.5).sum())
        depth += 1
    return counts


@pytest.mark.parametrize("driver", ["sorted", "diff"])
def test_counters_of_a_trace_match_the_twins_live_rays(driver):
    scene = dragon_scene("port")
    o, d = (torch.from_numpy(x) for x in sorted_rays(256))
    opts = RenderOptions(16, 16, 1, 1, max_depth=6)
    counts = _alive_counts(scene, o, d, opts, 21)
    attr = sw.trace_megakernel_sorted if driver == "sorted" else dm.trace_megakernel_diff
    reads = attr.host_reads
    before = tp.counters()
    attr(scene, Rays(o, d), opts, 21)
    delta = {k: v - before[k] for k, v in tp.counters().items()}
    assert delta[f"{driver}.host_reads"] == attr.host_reads - reads == len(counts)
    assert delta[f"{driver}.live_rays"] == sum(counts) and len(counts) >= 2
    # The twin launches nothing and no other driver ran.
    assert {k: v for k, v in delta.items() if v} == {f"{driver}.host_reads": len(counts),
                                                     f"{driver}.live_rays": sum(counts)}
