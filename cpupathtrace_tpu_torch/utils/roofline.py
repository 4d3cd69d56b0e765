"""Roofline accounting for frames and kernels on one NVIDIA H100 (port of
cpupathtrace_tpu/utils/roofline.py).

The reference reports only items/s (ref: benchmark/main.cpp:30); nothing
states how far a frame sits from the machine's limits. This module turns
the kernels' measured counters into per-frame byte and float32-operation
totals and expresses each as a fraction of the H100's peak, so "speed of
light" claims are checkable numbers: a frame with hbm_frac and fp32_frac
both << 1 is occupancy/latency-bound and has headroom; a frame near 1 on
either axis is at that roof.

Chip constants (NVIDIA H100 SXM data sheet, at its 700 W limit):
  * HBM bandwidth 3.35e12 B/s.
  * float32 peak outside the tensor cores 67e12 op/s (an FMA counts two).
    The kernels are built with --fmad=false and issue no FMA, so only about
    half of it is reachable by them.
  * TF32 on the tensor cores 495e12 op/s.

Keys that named a TPU unit in the JAX package are renamed: `vpu_tflop` is
`fp32_tflop`, `vpu_frac` is `fp32_frac`, and `bound` says "fp32" where it
said "vpu". `hbm_*` keep their names.

Work model (documented, deliberately simple; every constant is visible
here):
  * One ray-triangle test is ~64 float32 operations (TEST_FLOPS, the JAX
    package's MT_FLOPS_PER_PAIR: 2 crosses + 4 dots + the t/u/v arithmetic
    and the pair form's gating); one slab test of a box 31 (SLAB_FLOPS:
    12 subtract / multiply, 10 min / max, the entry's compare and select,
    7 compares); the estimator ~300 per ray-bounce outside its tests
    (VERTEX_FLOPS).
  * JAX's two frame functions keep its model: a record visit moves one
    pair record and pair-tests it against a ray block of the TPU's shape.
  * The port's kernels count their own work (K1's binned form, K2, K4:
    `debug_visits`, [..., 9] or [..., 4] counters): filled record rows
    tested and slab tests below the root gate (`traversal_flops`), and the
    nearest queries, one per ray-bounce (`ray_bounces`). `bound` turns
    bytes and operations into the least time the card could take.
"""
from __future__ import annotations

from ..accel.kernel_traverse import GEO_VISIT_COLS, NEAR_COLS, QUERY_COL, SHADOW_COLS

H100_HBM_BYTES_S = 3.35e12
H100_FP32_FLOPS_S = 67e12
H100_TF32_FLOPS_S = 495e12
MT_FLOPS_PER_PAIR = 64
LANES = 128
TEST_FLOPS = MT_FLOPS_PER_PAIR
SLAB_FLOPS = 31
VERTEX_FLOPS = 300
# Path-state bytes a K2 launch reads and writes per live ray (18 planes in,
# 18 out) and per dead one (its alive plane).
LIVE_STATE_BYTES = 144
DEAD_STATE_BYTES = 4


def binned_frame_roofline(
    *,
    frame_s: float,
    n_rays: int,
    visits_totals,  # (near_sup, near_rec, shadow_sup, shadow_rec)
    executed_bounces: int,
    record_bytes: int,
    record_tris: int,
    block_rows: int,
    n_state: int = 18,
) -> dict:
    """Roofline fractions for one binned (in-kernel cluster traversal)
    frame from its MEASURED visit counters (the JAX package's four
    columns)."""
    near_sup, near_rec, shadow_sup, shadow_rec = (int(v) for v in visits_totals)
    rec_visits = near_rec + shadow_rec

    rec_bytes = rec_visits * record_bytes
    # Path state through the bounce kernel + one sort read/write set per
    # executed bounce (a lower bound on the glue's bytes).
    state_bytes = (
        executed_bounces * n_rays * (n_state + 1) * 4 * 2 * 2
    )
    hbm_bytes = rec_bytes + state_bytes

    pair_flops = rec_visits * record_tris * block_rows * LANES * MT_FLOPS_PER_PAIR
    hbm_frac = hbm_bytes / frame_s / H100_HBM_BYTES_S
    fp32_frac = pair_flops / frame_s / H100_FP32_FLOPS_S
    return {
        "record_visits": rec_visits,
        "supercluster_visits": near_sup + shadow_sup,
        "executed_bounces": executed_bounces,
        "hbm_gb": round(hbm_bytes / 1e9, 2),
        "hbm_gb_records": round(rec_bytes / 1e9, 2),
        "hbm_gb_state_glue": round(state_bytes / 1e9, 2),
        "fp32_tflop": round(pair_flops / 1e12, 3),
        "hbm_frac": round(hbm_frac, 4),
        "fp32_frac": round(fp32_frac, 4),
        "bound": "hbm" if hbm_frac > fp32_frac else "fp32",
    }


def dense_frame_roofline(
    *,
    frame_s: float,
    n_rays: int,
    n_prims: int,
    executed_bounces: float,
    n_state: int = 18,
) -> dict:
    """Roofline fractions for one dense-scene (megakernel) frame. Scene
    tables live in shared memory, so HBM traffic is just ray IO; compute
    is the per-bounce dense intersect of all primitives for the nearest
    AND the NEE shadow pass plus ~300 estimator flops/ray.

    `executed_bounces` is the average number of bounces a ray executes
    (the JAX package's model: ~8 for the closed box's 1024-lane blocks;
    the port's refilling warps run a path's own bounces, which K1's
    counting instance counts)."""
    hbm_bytes = n_rays * (6 + 4) * 4  # rays in, spectrum+coverage out
    flops = n_rays * executed_bounces * (
        2 * n_prims * MT_FLOPS_PER_PAIR + 300
    )
    hbm_frac = hbm_bytes / frame_s / H100_HBM_BYTES_S
    fp32_frac = flops / frame_s / H100_FP32_FLOPS_S
    return {
        "executed_bounces": executed_bounces,
        "hbm_gb": round(hbm_bytes / 1e9, 3),
        "fp32_tflop": round(flops / 1e12, 3),
        "hbm_frac": round(hbm_frac, 4),
        "fp32_frac": round(fp32_frac, 4),
        "bound": "hbm" if hbm_frac > fp32_frac else "fp32",
    }


def bound(nbytes, flops, tf32_flops=0):
    """bound_ms / bound_by of a kernel call that must move `nbytes` and do
    `flops` float32 operations (and `tf32_flops` on the tensor cores, which
    run beside the float32 units): the larger of bytes over HBM's rate and
    operations over their peak."""
    t_b = nbytes / H100_HBM_BYTES_S
    t_f = max(flops / H100_FP32_FLOPS_S, tf32_flops / H100_TF32_FLOPS_S)
    return dict(bound_ms=max(t_b, t_f) * 1e3, bound_by="bytes" if t_b >= t_f else "operations",
                bound_bytes=nbytes, bound_flops=flops, bound_tf32_flops=tf32_flops)


def traversal_flops(visits):
    """Operations of the cluster traversal from its counters (a [..., 9]
    K1 / K2 array or a [..., 4] K4 one): 64 per filled record row tested
    and 31 per slab test below the root gate (hypers, the superclusters of
    entered hypers, the clusters of descends; any-hit walks stop at the
    occluding row and box). Returns (flops, the summed counts)."""
    v = visits.reshape(-1, visits.shape[-1]).sum(0).long().tolist()
    if len(v) == GEO_VISIT_COLS:
        descends, records, slabs, rows = (v[n] + v[s] for n, s in zip(NEAR_COLS, SHADOW_COLS))
    else:
        descends, records, slabs, rows = v
    return rows * TEST_FLOPS + slabs * SLAB_FLOPS, dict(
        descends=descends, record_visits=records, slab_tests=slabs, rows_tested=rows,
        counters=v)


def ray_bounces(visits):
    """The nearest queries of a K1 / K2 count: one per ray-bounce."""
    return int(visits[..., QUERY_COL].sum())


def tests_per_vertex(scene, n_prims):
    """Primitive tests of one ray-bounce of the estimator: the nearest query
    and one shadow query per point light and per emitter draw."""
    return (1 + scene.n_point_lights + scene.emissive_sample_count) * n_prims


def vertex_flops(scene):
    """The estimator's work per ray-bounce outside the cluster walks: ~300
    operations, and for the nearest and each shadow query the dense part's
    tests (big partition and spheres) and the cluster set's root test."""
    queries = tests_per_vertex(scene, 1)
    return (VERTEX_FLOPS + tests_per_vertex(scene, scene.n_big + scene.n_sph) * TEST_FLOPS
            + queries * SLAB_FLOPS)


def frame_bound(vis, n_paths, scene):
    """The bound of a sorted frame's K2 launches from its counters
    [max_depth, n_blocks, 9]: per bounce the state traffic of its live rays
    (144 bytes; 4 for a dead one) and the walk's and estimator's work."""
    entering = [a for a in (ray_bounces(v) for v in vis) if a > 0]
    flops, counts = traversal_flops(vis)
    return dict(bounces=len(entering), ray_bounces=sum(entering), counts=counts,
                **bound(sum(a * LIVE_STATE_BYTES + (n_paths - a) * DEAD_STATE_BYTES
                            for a in entering),
                        flops + sum(entering) * vertex_flops(scene)))
