"""sorted.idle_ms_per_frame: milliseconds a frame in which the card is idle
while the innermost program span on the calling thread is the sorted
driver's (`sorted.*`: its host reads of the live count, the sort's host
work, the launches), in the profile of portbench/spans.py."""
from portbench import spans

NAME = "sorted.idle_ms_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    return a.idle_ms("sorted") if a is not None else None
