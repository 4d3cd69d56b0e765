"""film.launches_per_frame: kernels a frame launches on the card, counted
in the traced window's device timeline (K1's launches and the film's and
camera's glue alike)."""


def read(run):
    t = run.timeline
    if t is None or not t.steps or not t.kernels():
        return None
    return len(t.kernels()) / t.steps
