"""film.fold_ms_per_frame: device milliseconds a frame launches under the
program's `film.fold` span (`_apply_stats_batches`, the film's stats folds),
in the profile of the cell's steps after the traced window
(portbench/spans.py)."""
from portbench import spans

NAME = "film.fold_ms_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    return a.device_ms("film.fold") if a is not None else None
