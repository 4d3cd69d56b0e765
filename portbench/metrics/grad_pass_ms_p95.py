"""grad_pass_ms_p95: the 95th percentile (linear interpolation) of the wall
time of every `loss_and_grad` pass of the window, loss and gradients on the
host. Host clock."""
import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
