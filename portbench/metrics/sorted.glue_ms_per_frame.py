"""sorted.glue_ms_per_frame: device milliseconds a frame spends in kernels
other than K2 (`bounce_binned_kernel`): the sort keys, sorts and gathers of
the sorted driver, the camera and the film."""

K2 = r"bounce_binned_kernel<"


def read(run):
    t = run.timeline
    if t is None or not t.steps or not t.kernels(K2):
        return None
    return t.seconds(t.kernels(K2, exclude=True)) / t.steps * 1e3
