"""diff.launches_per_pass: kernels a gradient pass launches on the card,
counted in the traced window's device timeline (K2's record form, the
replay, autograd and the camera alike)."""


def read(run):
    t = run.timeline
    if t is None or not t.steps or not t.kernels():
        return None
    return len(t.kernels()) / t.steps
