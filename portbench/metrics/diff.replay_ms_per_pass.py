"""diff.replay_ms_per_pass: device milliseconds a pass spends in kernels
other than K2's record form (`bounce_kernel<CULL, true>`): the replay, its
autograd, the camera and the loss."""

RECORD = r"bounce_kernel<-?\d+,\s*true>"


def read(run):
    t = run.timeline
    if t is None or not t.steps or not t.kernels(RECORD):
        return None
    return t.seconds(t.kernels(RECORD, exclude=True)) / t.steps * 1e3
