"""k1_dense_roofline: K1's (dense `megakernel`) share of its roofline in a
frame: the frozen `dense_frame_roofline` at K1's device time a frame, with
the ray-bounces that K1's counting instance counts on the frame's own rays
(frame 0 of the run, every launch it made: an adaptive frame's too), over
the rays K1 traced in those launches."""
from portbench.roofline import dense_frame_roofline

K1 = r"\bmegakernel<"


def count(run):
    """Ray-bounces of frame 0 by K1's counting instance (card only)."""
    import torch
    from cpupathtrace_tpu_torch.integrator import megakernel as mk

    e = run.entry
    if e.device.type != "cuda" or e.scene.has_kernel_records:
        return None
    total = n_rays = 0
    for rays, seed in e.launch_rays(0):
        steps = torch.zeros(2, dtype=torch.int64, device=e.device)
        mk.trace_megakernel(e.scene, rays, e.options, seed, bounce_steps=steps)
        total += int(steps[1])
        n_rays += rays.origin.shape[0]
    return {"ray_bounces": total, "n_prims": int(e.scene.n_prims), "n_rays": n_rays}


def read(run):
    t, c = run.timeline, run.counted.get("k1_dense_roofline")
    if t is None or not c or not t.steps or not t.kernels(K1):
        return None
    k1_s = t.seconds(t.kernels(K1)) / t.steps
    n_rays = c["n_rays"]
    r = dense_frame_roofline(frame_s=k1_s, n_rays=n_rays, n_prims=c["n_prims"],
                             executed_bounces=c["ray_bounces"] / n_rays)
    return 100.0 * max(r["hbm_frac"], r["fp32_frac"])
