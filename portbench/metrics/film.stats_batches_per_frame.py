"""film.stats_batches_per_frame: stats batches the film folds a frame (the
program's `film.stats_batches` counter over the steps profiled by
portbench/spans.py). An adaptive frame folds fewer where every pixel
froze before the last launch."""
from portbench import spans

NAME = "film.stats_batches_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    n = a.counters.get("film.stats_batches") if a is not None else None
    return n / a.steps if n is not None and a.steps else None
