"""grad_passes_per_s: gradient passes the window completed over its
seconds. Host clock."""


def read(run):
    return run.steps / run.elapsed
