"""film.candidate_ms_per_frame on synthetic Chrome traces: the device time
under the program's `film.candidate` span a step, where the program's
`film.candidate_selects` counter saw selections; nothing without a trace,
without the span (the parent) or without a selection."""
from __future__ import annotations

import pytest

from portbench import run
from portbench.run import _load
from portbench.tests.cells import REPO
from portbench.tests.test_portbench_spans import attribution, device, launch, span, step

NAME = "film.candidate_ms_per_frame"
TRACE = [
    step(), span("film.render", 1, 98), span("film.tile", 2, 90), span("film.fold", 3, 10),
    span("film.candidate", 60, 20),
    launch(4, 1), device("fold", 5, 4, 1), launch(61, 2), device("sort", 62, 6, 2),
    launch(70, 3), device("gather", 71, 3, 3),
]


def _reader():
    return _load(REPO / "portbench" / "metrics" / f"{NAME}.py", "test_candidate_span")


@pytest.mark.parametrize("case", ["selected", "none_selected", "no_span", "untraced"])
def test_the_candidate_metric_reads_its_span_or_nothing(case):
    reader = _reader()
    r = run.Run(None, 0.0)
    if case != "untraced":
        events = TRACE if case != "no_span" else [e for e in TRACE
                                                   if e.get("name") != "film.candidate"]
        selects = 0 if case == "none_selected" else 2
        r.counted[NAME] = attribution(events, steps=2,
                                      counters={"film.candidate_selects": selects})
    value = reader.read(r)
    if case == "selected":
        # 6 + 3 us of device time over 2 steps.
        assert value == pytest.approx(4.5e-3)
    else:
        assert value is None
