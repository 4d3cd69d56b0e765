"""k2_record_roofline: K2's record form (`bounce_kernel<CULL, true>`) share
of its roofline in a gradient pass, by bytes: per launch the record planes
of every ray written once (3 + point lights + 2 x emitter draws planes of 4
bytes) and the path state of each live ray read and written once (144
bytes; a dead ray's alive plane, 4), over the record launches' device time
a pass. The live rays entering each depth are the reference's, which traces
the same paths as the checked pass."""
from portbench.roofline import DEAD_STATE_BYTES, LIVE_STATE_BYTES, bound

RECORD = r"bounce_kernel<-?\d+,\s*true>"


def read(run):
    t, e = run.timeline, run.entry
    if t is None or not t.steps or not t.kernels(RECORD) or not e.ref_entering:
        return None
    n = e.width * e.height * e.spp
    planes = 3 + 2 * e.ref_em_k  # the configurations hold no point lights
    nbytes = sum(n * planes * 4 + a * LIVE_STATE_BYTES + (n - a) * DEAD_STATE_BYTES
                 for a in e.ref_entering)
    return 100.0 * bound(nbytes, 0)["bound_s"] / (t.seconds(t.kernels(RECORD)) / t.steps)
