"""k2_binned_roofline: K2's (`bounce_binned_kernel`, with the K3 walk
inlined) share of its roofline in a frame: the frozen `frame_bound` of one
`debug_visits` pass of the sorted driver over frame 0's own rays (state
traffic of the live rays, the walks' counted slab tests and filled rows,
the estimator's work), over K2's summed device time a frame."""
from portbench.roofline import frame_bound

K2 = r"bounce_binned_kernel<"


def count(run):
    """The per-bounce traversal counters of frame 0 (card only)."""
    from cpupathtrace_tpu_torch.integrator.sorted_wavefront import trace_megakernel_sorted

    e = run.entry
    if e.device.type != "cuda" or not e.scene.has_kernel_records:
        return None
    vis = []
    for rays, seed in e.launch_rays(0):
        _, _, v = trace_megakernel_sorted(e.scene, rays, e.options, seed, debug_visits=True)
        vis.append((v.cpu(), rays.origin.shape[0]))
    s = e.scene
    return {"vis": vis, "scene": (s.n_point_lights, s.emissive_sample_count, s.n_big, s.n_sph)}


def read(run):
    t, c = run.timeline, run.counted.get("k2_binned_roofline")
    if t is None or not c or not t.steps or not t.kernels(K2):
        return None
    bound_s = sum(frame_bound(v, n, *c["scene"])["bound_s"] for v, n in c["vis"])
    return 100.0 * bound_s / (t.seconds(t.kernels(K2)) / t.steps)
