"""sorted.host_syncs_per_frame: copies from the card to the host a frame
waits for (the sorted driver's live count each bounce, the image), counted
as device-to-host copies in the traced window."""


def read(run):
    t = run.timeline
    if t is None or not t.steps or not t.kernels():
        return None
    return sum(1 for kind, name, _, _ in t.device if kind == "memcpy" and "DtoH" in name) / t.steps
