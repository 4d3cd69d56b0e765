"""Roofline arithmetic of one NVIDIA H100, frozen here as the benchmark's
yardstick.

Copied from cpupathtrace_tpu_torch/utils/roofline.py (`bound`,
`traversal_flops`, `ray_bounces`, `frame_bound`, `dense_frame_roofline`,
their constants, and the counter columns of
cpupathtrace_tpu_torch/accel/kernel_traverse.py), so that a later change to
the program cannot move it. `frame_bound` takes the scene's counts as
numbers where the original read them from the scene. A share of the roofline
is the least time the card could take over the time it took, in percent.

Peaks (NVIDIA H100 SXM data sheet, 700 W): 3.35e12 B/s of HBM, 67e12
float32 operations/s outside the tensor cores (the port's kernels build with
--fmad=false and issue no FMA, so about half of it is reachable).
"""
from __future__ import annotations

H100_HBM_BYTES_S = 3.35e12
H100_FP32_FLOPS_S = 67e12
H100_TF32_FLOPS_S = 495e12
MT_FLOPS_PER_PAIR = 64
TEST_FLOPS = MT_FLOPS_PER_PAIR
SLAB_FLOPS = 31
VERTEX_FLOPS = 300
# Path-state bytes a K2 launch reads and writes per live ray (18 planes in,
# 18 out) and per dead one (its alive plane).
LIVE_STATE_BYTES = 144
DEAD_STATE_BYTES = 4
# Columns of the kernels' [..., 9] traversal counters.
GEO_VISIT_COLS = 9
NEAR_COLS = [0, 1, 4, 5]
SHADOW_COLS = [2, 3, 6, 7]
QUERY_COL = 8


def bound(nbytes, flops, tf32_flops=0):
    """The least seconds a call that moves `nbytes` and does `flops` float32
    operations (and `tf32_flops` on the tensor cores) can take, and which
    of the two bounds it."""
    t_b = nbytes / H100_HBM_BYTES_S
    t_f = max(flops / H100_FP32_FLOPS_S, tf32_flops / H100_TF32_FLOPS_S)
    return dict(bound_s=max(t_b, t_f), bound_by="bytes" if t_b >= t_f else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def traversal_flops(visits):
    """Operations of the cluster walks from their counters (rows [..., 9]):
    64 per filled record row tested and 31 per slab test below the root
    gate. Returns (flops, the summed counts)."""
    v = [int(x) for x in visits.reshape(-1, visits.shape[-1]).sum(0).tolist()]
    descends, records, slabs, rows = (v[n] + v[s] for n, s in zip(NEAR_COLS, SHADOW_COLS))
    return rows * TEST_FLOPS + slabs * SLAB_FLOPS, dict(
        descends=descends, record_visits=records, slab_tests=slabs, rows_tested=rows)


def ray_bounces(visits):
    """The nearest queries of a count: one per ray-bounce."""
    return int(visits[..., QUERY_COL].sum())


def vertex_flops(n_point_lights, em_k, n_big, n_sph):
    """The estimator's work per ray-bounce outside the cluster walks: ~300
    operations, and for the nearest and each shadow query the dense part's
    tests and the cluster set's root test."""
    queries = 1 + n_point_lights + em_k
    return VERTEX_FLOPS + queries * (n_big + n_sph) * TEST_FLOPS + queries * SLAB_FLOPS


def frame_bound(vis, n_paths, n_point_lights, em_k, n_big, n_sph):
    """The bound of a sorted frame's K2 launches from its counters
    [max_depth, n_blocks, 9]: per bounce the state traffic of its live rays
    and the walks' and the estimator's work."""
    entering = [a for a in (ray_bounces(v) for v in vis) if a > 0]
    flops, counts = traversal_flops(vis)
    return dict(bounces=len(entering), ray_bounces=sum(entering), counts=counts,
                **bound(sum(a * LIVE_STATE_BYTES + (n_paths - a) * DEAD_STATE_BYTES
                            for a in entering),
                        flops + sum(entering) * vertex_flops(n_point_lights, em_k, n_big, n_sph)))


def dense_frame_roofline(*, frame_s, n_rays, n_prims, executed_bounces):
    """Shares of the peaks a dense-scene frame of `frame_s` seconds reaches:
    ray IO through HBM, and per executed bounce the nearest and one shadow
    pass over every primitive plus ~300 estimator operations."""
    hbm_bytes = n_rays * (6 + 4) * 4
    flops = n_rays * executed_bounces * (2 * n_prims * MT_FLOPS_PER_PAIR + 300)
    hbm_frac = hbm_bytes / frame_s / H100_HBM_BYTES_S
    fp32_frac = flops / frame_s / H100_FP32_FLOPS_S
    return dict(hbm_frac=hbm_frac, fp32_frac=fp32_frac,
                bound="hbm" if hbm_frac > fp32_frac else "fp32")
