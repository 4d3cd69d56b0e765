"""portbench/spans.py on synthetic Chrome traces: device events go to the
innermost program span around their launch or copy call, matched by
correlation id, on the launching thread or else the calling thread; idle
gaps to the span open on the calling thread at their middle; and the
helper's own profile leaves the entry's outputs as the window left them."""
from __future__ import annotations

import pytest
import torch

from portbench import run, spans
from portbench.run import _load
from portbench.tests.cells import REPO

CALLER, OTHER, STREAM = 11, 12, 7


def host(cat, name, ts, dur, tid=CALLER, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 100, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def span(name, ts, dur, tid=CALLER):
    return host("user_annotation", name, ts, dur, tid)


def device(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": STREAM,
            "args": {"correlation": corr}}


def launch(ts, corr, tid=CALLER, name="cudaLaunchKernel", cat="cuda_runtime"):
    return host(cat, name, ts, 1, tid, corr)


def step(ts=0, dur=100):
    return span("portbench.step", ts, dur)


def attribution(events, steps=1, counters=None):
    return spans.Attribution(events, steps, counters or {})


def test_nested_spans_take_their_innermost():
    a = attribution([
        step(), span("film.render", 1, 98), span("film.tile", 2, 88), span("film.fold", 10, 20),
        launch(12, 1), device("fold_kernel", 15, 10, 1),
        launch(40, 2), device("tile_kernel", 41, 20, 2),
        launch(95, 3), device("render_kernel", 95.5, 1, 3),
    ])
    assert a.device_s["film.fold"] == pytest.approx(10e-6)
    assert a.device_s["film.tile"] == pytest.approx(20e-6)
    assert a.device_s["film.render"] == pytest.approx(1e-6)
    assert None not in a.device_s and a.names == {"film.render", "film.tile", "film.fold"}


def test_a_launch_on_a_thread_with_no_span_falls_back_to_the_caller():
    """Autograd's device thread launches the loss's backward with no span
    open there; the caller waits inside diff.grad."""
    a = attribution([
        step(), span("diff.loss_and_grad", 1, 98), span("diff.grad", 50, 40),
        span("diff.backward", 60, 10, tid=OTHER),
        launch(55, 1, tid=OTHER), device("loss_backward", 56, 3, 1),
        launch(62, 2, tid=OTHER), device("replay_vjp", 63, 5, 2),
    ])
    assert a.device_s["diff.grad"] == pytest.approx(3e-6)
    assert a.device_s["diff.backward"] == pytest.approx(5e-6)


def test_a_driver_launch_counts_and_an_unmatched_event_goes_to_no_span():
    a = attribution([
        step(), span("sorted.trace", 1, 98), span("sorted.bounce", 10, 5),
        launch(11, 1, name="cuLaunchKernel", cat="cuda_driver"), device("bounce_binned", 12, 30, 1),
        device("orphan", 50, 4, 99),
    ])
    assert a.device_s["sorted.bounce"] == pytest.approx(30e-6)
    assert a.device_s[None] == pytest.approx(4e-6)
    assert a.summary()["unspanned_device_pct"] == pytest.approx(100 * 4 / 34)


def test_gaps_under_a_span_and_under_none():
    """Busy [20, 30] and [40, 50] in the window [0, 100]: the gaps' middles
    10, 35 and 75 lie in sorted.live_read, sorted.trace and no span."""
    a = attribution([
        step(), span("film.render", 0.5, 60), span("sorted.trace", 1, 59),
        span("sorted.live_read", 5, 10),
        launch(16, 1), device("k", 20, 10, 1), launch(31, 2), device("k", 40, 10, 2),
    ], steps=2)
    assert a.idle_s["sorted.live_read"] == pytest.approx(20e-6)
    assert a.idle_s["sorted.trace"] == pytest.approx(10e-6)
    assert a.idle_s[None] == pytest.approx(50e-6)
    assert a.idle_ms("sorted") == pytest.approx(30e-3 / 2)
    assert a.idle_ms("film") == 0.0 and a.idle_ms("diff") is None
    assert a.summary()["idle_pct"] == pytest.approx(80.0)


@pytest.mark.parametrize("read_end, after", [(40, 1), (34, 0)])
def test_a_copy_goes_to_its_read_span_and_is_checked_against_its_end(read_end, after):
    a = attribution([
        step(), span("sorted.trace", 1, 98), span("sorted.live_read", 30, read_end - 30),
        launch(31, 5, name="cudaMemcpyAsync"),
        device("Memcpy DtoH (Device -> Pageable)", 33, 2, 5, cat="gpu_memcpy"),
        launch(60, 6, name="cudaMemsetAsync"), device("Memset (Device)", 61, 1, 6,
                                                       cat="gpu_memset"),
    ])
    assert a.device_s["sorted.live_read"] == pytest.approx(2e-6)
    assert a.device_s["sorted.trace"] == pytest.approx(1e-6)
    assert a.reads["sorted.live_read"] == [1, after, max(0.0, 35 - read_end)]


def test_a_program_without_spans_reads_nothing():
    a = attribution([step(), launch(1, 1), device("k", 2, 5, 1)])
    assert a.device_ms("film.fold") is None and a.idle_ms("film", "camera") is None
    assert a.device_s[None] == pytest.approx(5e-6)


NEW = ["film.fold_ms_per_frame", "film.idle_ms_per_frame", "sorted.sort_ms_per_frame",
       "sorted.idle_ms_per_frame", "sorted.bounce_ns_per_live_ray",
       "diff.backward_ms_per_pass", "diff.idle_ms_per_pass"]
TRACE = [
    step(), span("film.render", 1, 98), span("film.fold", 2, 10), span("sorted.trace", 20, 70),
    span("sorted.sort", 30, 10), span("sorted.bounce", 50, 10), span("diff.backward", 70, 5),
    launch(3, 1), device("k", 3, 4, 1), launch(31, 2), device("k", 32, 6, 2),
    launch(51, 3), device("k", 52, 8, 3), launch(71, 4), device("k", 80, 2, 4),
]
# Over 2 steps: fold 4 us, sort 6, bounce 8 over 400 live rays, backward 2.
EXPECTED = {"film.fold_ms_per_frame": 2e-3, "sorted.sort_ms_per_frame": 3e-3,
            "sorted.bounce_ns_per_live_ray": 8e3 / 400, "diff.backward_ms_per_pass": 1e-3}


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_reads_its_span_or_nothing(name):
    reader = _load(REPO / "portbench" / "metrics" / f"{name}.py", f"test_spans_{name}")
    r = run.Run(None, 0.0)
    assert reader.read(r) is None  # not counted (a run with no trace)
    r.counted[name] = attribution(TRACE, steps=2, counters={"sorted.live_rays": 400})
    value = reader.read(r)
    if name in EXPECTED:
        assert value == pytest.approx(EXPECTED[name])
    else:
        a = r.counted[name]
        layers = {"film.idle_ms_per_frame": ("film", "camera"),
                  "sorted.idle_ms_per_frame": ("sorted",),
                  "diff.idle_ms_per_pass": ("diff",)}[name]
        want = sum(v for k, v in a.idle_s.items() if k and k.split(".")[0] in layers) / 2 * 1e3
        assert value == pytest.approx(want) and value > 0
    r.counted[name] = attribution([step(), launch(1, 1), device("k", 2, 5, 1)], 2,
                                  {"sorted.live_rays": 400})
    assert reader.read(r) is None  # the parent: no spans


class FakeEntry:
    """Steps that append to `outputs` and launch a span, as an entry does."""

    def __init__(self):
        self.tr = {"trace_warm_steps": 2, "trace_steps": 3}
        self.device = torch.device("cpu")
        self.outputs = ["a", "b"]
        self.indices = []

    def step(self, i):
        from cpupathtrace_tpu_torch.utils.profiling import trace_annotation

        with trace_annotation("film.render"):
            self.outputs.append(torch.ones(8).cumsum(0))
        self.indices.append(i)


def test_the_helper_keeps_the_outputs_and_runs_once():
    e = FakeEntry()
    outputs = e.outputs
    r = run.Run(e, 0.0)
    a = spans.measure(r)
    assert e.outputs is outputs and e.outputs == ["a", "b"]
    assert e.indices == [5, 6, 7] and a.steps == 3 and "film.render" in a.names
    assert a.counters and not any(a.counters.values())
    assert spans.measure(r) is a and e.indices == [5, 6, 7]
