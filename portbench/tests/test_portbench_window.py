"""The window's arithmetic: a rate over all the work and all the time, a
95th percentile over every step, which a single stall moves."""
from __future__ import annotations

import time

from portbench import run
from portbench.run import _load
from portbench.tests.cells import REPO

METRICS = REPO / "portbench" / "metrics"


class FakeEntry:
    def __init__(self, delays):
        self.delays = delays

    def step(self, i):
        time.sleep(self.delays[min(i, len(self.delays) - 1)])

    def work(self):
        return 1_000_000


def _reader(name):
    return _load(METRICS / f"{name}.py", f"test_metric_{name}")


def test_rate_is_all_work_over_all_time():
    r = run.Run(FakeEntry([0.01, 0.05, 0.01, 0.01]), 1.0)
    run.window(r.entry, 0.065, r)
    assert r.steps >= 2 and max(r.latencies) >= 0.05  # the stalled step counts
    assert abs(r.elapsed - sum(r.latencies)) < 0.005
    rate = _reader("mrays_per_s").read(r)
    assert abs(rate - r.steps / r.elapsed) < 1e-9
    assert abs(_reader("grad_passes_per_s").read(r) - r.steps / r.elapsed) < 1e-9


def test_p95_moves_when_one_frame_stalls():
    r = run.Run(FakeEntry([]), 1.0)
    r.latencies = [0.010] * 20
    before = _reader("frame_ms_p95").read(r)
    r.latencies[7] = 0.100
    after = _reader("frame_ms_p95").read(r)
    assert abs(before - 10.0) < 1e-9
    assert abs(after - (10.0 + 0.05 * 90.0)) < 1e-6
    assert _reader("grad_pass_ms_p95").read(r) == after


def test_setup_seconds_read_as_given():
    assert _reader("setup_s").read(run.Run(FakeEntry([]), 3.25)) == 3.25
