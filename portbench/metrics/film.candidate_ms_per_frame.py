"""film.candidate_ms_per_frame: device milliseconds a frame launches under
the program's `film.candidate` span (`_candidate_select`, the biased
candidate selection of a tile), in the profile of the cell's steps after
the traced window (portbench/spans.py); nothing where the program's
`film.candidate_selects` counter saw no selection run."""
from portbench import spans

NAME = "film.candidate_ms_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    if a is None or not a.counters.get("film.candidate_selects"):
        return None
    return a.device_ms("film.candidate")
