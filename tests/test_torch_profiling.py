"""The port's profiling utilities (cpupathtrace_tpu_torch/utils/profiling.py)
against the JAX package's (cpupathtrace_tpu/utils/profiling.py) on the CPU:
the progress bar byte for byte, the ray counter on the same clock, and the
trace annotation and profile in a torch.profiler trace (JAX's go to
jax.profiler, whose traces this does not compare). NVTX ranges need the
card: tests/test_torch_cuda.py checks them there.
"""
import io
import json
import os
import time

import pytest
import torch

import cpupathtrace_tpu
import cpupathtrace_tpu_torch
from cpupathtrace_tpu.utils import profiling as jp
from cpupathtrace_tpu_torch.utils import profiling as tp


@pytest.mark.parametrize("width", [50, 7, 1])
@pytest.mark.parametrize("total", [0, 1, 13, 64])
def test_progress_printer_byte_for_byte(width, total):
    outs = []
    for mod in (jp, tp):
        stream = io.StringIO()
        cb = mod.progress_printer(stream, width)
        for done in list(range(total + 1)) + [total + 2]:
            cb(done, total)
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] and outs[1].count("\r") == total + 2


def test_progress_printer_default_width_is_jax_s():
    outs = []
    for mod in (jp, tp):
        stream = io.StringIO()
        mod.progress_printer(stream)(3, 3)
        outs.append(stream.getvalue())
    assert outs[0] == outs[1] == "\r[" + "#" * 50 + "] 3/3\n"


class _Clock:
    """A perf_counter both packages read: 0.25 s a call, then a jump."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.25
        return self.t


@pytest.mark.parametrize("stops", [[1000], [4096, 16384, 7], [0, 3]])
def test_ray_counter_matches_jax_on_the_same_clock(stops, monkeypatch):
    counters = {}
    for name, mod in (("jax", jp), ("port", tp)):
        monkeypatch.setattr(time, "perf_counter", _Clock())
        c = mod.RayCounter()
        for n in stops:
            assert c.start() is c and c.stop(n) is c
        counters[name] = c
    ref, ours = counters["jax"], counters["port"]
    assert (ours.samples, ours.seconds) == (ref.samples, ref.seconds) == (sum(stops),
                                                                         0.25 * len(stops))
    assert ours.mrays_per_s == ref.mrays_per_s
    assert ours.report() == ref.report() and ours.report("k1") == ref.report("k1")
    assert tp.RayCounter().mrays_per_s == jp.RayCounter().mrays_per_s == 0.0


def test_ray_counter_stop_without_start_raises_as_jax():
    for mod in (jp, tp):
        with pytest.raises(RuntimeError, match="stop without start"):
            mod.RayCounter().stop(1)


def test_ray_counter_synchronises_only_a_cuda_device(monkeypatch):
    """`device` is the port's one addition: a CUDA device is synchronised
    at start and stop (here recorded in place of the card), a CPU one or
    none is not."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: calls.append(d))
    tp.RayCounter(device="cpu").start().stop(5)
    tp.RayCounter().start().stop(5)
    assert calls == []
    tp.RayCounter(device="cuda:0").start().stop(5)
    assert calls == ["cuda:0", "cuda:0"]


def test_trace_annotation_names_appear_in_a_profile():
    names = ["budget/box/k1/base", "budget/dragon_200k/k2/nee"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for name in names:
            with tp.trace_annotation(name):
                torch.ones(64).cumsum(0)
    seen = {e.key for e in prof.key_averages()}
    assert set(names) <= seen, seen


def test_profile_to_writes_one_trace_with_the_ranges(tmp_path):
    logdir = tmp_path / "trace"
    with tp.profile_to(str(logdir)):
        with tp.trace_annotation("budget/box/k1/mat"):
            torch.arange(1000.0).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json"), files
    with open(logdir / files[0]) as f:
        trace = json.load(f)
    assert any(e.get("name") == "budget/box/k1/mat" for e in trace["traceEvents"])


def test_profile_to_stops_when_the_region_raises(tmp_path):
    with pytest.raises(ValueError, match="inside"):
        with tp.profile_to(str(tmp_path)):
            raise ValueError("inside")
    assert len(os.listdir(tmp_path)) == 1
    with tp.profile_to(str(tmp_path / "again")):  # a second profile can start
        torch.ones(3).sum()


def test_names_are_not_exported_by_the_package_as_in_jax():
    for name in ("trace_annotation", "profile_to", "RayCounter", "progress_printer"):
        assert not hasattr(cpupathtrace_tpu, name) and not hasattr(cpupathtrace_tpu_torch, name)
