"""film.idle_ms_per_frame: milliseconds a frame in which the card is idle
while the innermost program span on the calling thread is the film's or
the camera's (`film.*`, `camera.*`: the host folding, reading flags or the
image, or between launches), in the profile of portbench/spans.py."""
from portbench import spans

NAME = "film.idle_ms_per_frame"


def count(run):
    return spans.measure(run)


def read(run):
    a = run.counted.get(NAME)
    return a.idle_ms("film", "camera") if a is not None else None
