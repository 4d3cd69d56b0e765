"""device.idle_pct.render: share of the traced window of render frames in
which no kernel, copy or fill ran on the card."""


def read(run):
    t = run.timeline
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
