"""film.flag_reads_per_frame: all-frozen flags the film reads back to the
host a frame, each a wait on the card (the program's `film.flag_reads`
counter over the steps profiled by portbench/spans.py)."""
from portbench import spans

NAME = "film.flag_reads_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    n = a.counters.get("film.flag_reads") if a is not None else None
    return n / a.steps if n is not None and a.steps else None
