"""sorted.sort_ms_per_frame: device milliseconds a frame launches under the
sorted driver's `sorted.sort` span (the sort key, its argsort and the two
gathers after each bounce's host read), in the profile of
portbench/spans.py."""
from portbench import spans

NAME = "sorted.sort_ms_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    return a.device_ms("sorted.sort") if a is not None else None
