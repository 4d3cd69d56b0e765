"""The port's roofline (cpupathtrace_tpu_torch/utils/roofline.py) against the
JAX package's (cpupathtrace_tpu/utils/roofline.py) on the same arguments,
and the kernels' bound helpers that moved there from chip_smoke.py against
the numbers the old chip_smoke.py code gave.

JAX's two frame functions keep their work model; only the machine's peaks
differ (TPU v5e: 819 GB/s, ~7.13e12 f32 op/s; H100: 3.35e12 B/s, 67e12
float32 op/s), and the keys naming a TPU unit are renamed (vpu_tflop ->
fp32_tflop, vpu_frac -> fp32_frac, bound "vpu" -> "fp32"). So the byte
and operation totals are equal, and each fraction is JAX's times the ratio
of the two peaks, within the 4-decimal rounding both apply.
"""
import types

import numpy as np
import pytest
import torch

from cpupathtrace_tpu.utils import roofline as jr
from cpupathtrace_tpu_torch.utils import roofline as rl

HBM_RATIO = jr.V5E_HBM_BYTES_S / rl.H100_HBM_BYTES_S
FP32_RATIO = jr.V5E_VPU_FLOPS_S / rl.H100_FP32_FLOPS_S

BINNED_ARGS = [
    dict(frame_s=0.0466, n_rays=262144, visits_totals=(40321, 812345, 30210, 543210),
         executed_bounces=8, record_bytes=56 * 32 * 4, record_tris=56, block_rows=8),
    dict(frame_s=0.0031, n_rays=65536, visits_totals=(1, 2, 3, 4), executed_bounces=3,
         record_bytes=128 * 32 * 4, record_tris=128, block_rows=64, n_state=12),
    dict(frame_s=1.5, n_rays=4194304, visits_totals=(10**6, 5 * 10**6, 10**6, 2 * 10**6),
         executed_bounces=40, record_bytes=4096, record_tris=32, block_rows=8),
]
DENSE_ARGS = [
    dict(frame_s=0.00283, n_rays=4194304, n_prims=14, executed_bounces=8),
    dict(frame_s=0.5, n_rays=1024, n_prims=3, executed_bounces=2.5, n_state=18),
    dict(frame_s=1e-4, n_rays=262144, n_prims=128, executed_bounces=40.0),
]
TOTALS = ("record_visits", "supercluster_visits", "executed_bounces", "hbm_gb",
          "hbm_gb_records", "hbm_gb_state_glue")


def _fractions_match(ours, ref):
    assert ours["fp32_tflop"] == ref["vpu_tflop"]
    # Both round to 4 decimals: JAX's rounded fraction times the ratio is
    # within half a unit of the 4th decimal (times the ratio) of ours.
    for key, ref_key, ratio in (("hbm_frac", "hbm_frac", HBM_RATIO),
                                ("fp32_frac", "vpu_frac", FP32_RATIO)):
        assert abs(ours[key] - ref[ref_key] * ratio) <= 0.5e-4 * (1 + ratio), (key, ours, ref)
    assert ours["bound"] == ("hbm" if ours["hbm_frac"] > ours["fp32_frac"] else "fp32")
    assert "vpu_frac" not in ours and "vpu_tflop" not in ours


@pytest.mark.parametrize("args", BINNED_ARGS, ids=range(len(BINNED_ARGS)))
def test_binned_frame_roofline_matches_jax(args):
    ours, ref = rl.binned_frame_roofline(**args), jr.binned_frame_roofline(**args)
    for key in TOTALS:
        assert ours[key] == ref[key], key
    _fractions_match(ours, ref)
    assert set(ours) == {k.replace("vpu", "fp32") for k in ref}


@pytest.mark.parametrize("args", DENSE_ARGS, ids=range(len(DENSE_ARGS)))
def test_dense_frame_roofline_matches_jax(args):
    ours, ref = rl.dense_frame_roofline(**args), jr.dense_frame_roofline(**args)
    for key in ("executed_bounces", "hbm_gb"):
        assert ours[key] == ref[key], key
    _fractions_match(ours, ref)
    assert set(ours) == {k.replace("vpu", "fp32") for k in ref}


def test_work_model_constants_follow_jax():
    assert rl.MT_FLOPS_PER_PAIR == rl.TEST_FLOPS == jr.MT_FLOPS_PER_PAIR == 64
    assert rl.LANES == jr.LANES
    assert (rl.H100_HBM_BYTES_S, rl.H100_FP32_FLOPS_S, rl.H100_TF32_FLOPS_S) == \
        (3.35e12, 67e12, 495e12)


# A fixed [2, 3, 9] counter array (K1 / K2's columns) and a scene with one
# point light, two emitter draws, 14 big-partition triangles and 3
# spheres. The numbers below are what chip_smoke.py's own helpers gave on
# these inputs before they moved to utils/roofline.py.
VIS = torch.tensor(np.arange(2 * 3 * 9).reshape(2, 3, 9) * 7 + 3, dtype=torch.int32)
SCENE = types.SimpleNamespace(n_point_lights=1, emissive_sample_count=2, n_big=14, n_sph=3)
COUNTS = {"descends": 2010, "record_visits": 2094, "slab_tests": 2346, "rows_tested": 2430,
          "counters": [963, 1005, 1047, 1089, 1131, 1173, 1215, 1257, 1299]}


def test_traversal_flops_as_chip_smoke_gave():
    assert rl.traversal_flops(VIS) == (228246, COUNTS)
    assert rl.traversal_flops(VIS[..., :4]) == (102153, {
        "descends": 963, "record_visits": 1005, "slab_tests": 1047, "rows_tested": 1089,
        "counters": [963, 1005, 1047, 1089]})
    assert rl.ray_bounces(VIS) == 1299


def test_vertex_and_frame_bounds_as_chip_smoke_gave():
    assert rl.vertex_flops(SCENE) == 4776
    assert rl.tests_per_vertex(SCENE, 17) == 68
    assert rl.frame_bound(VIS, 5000, SCENE) == {
        "bounces": 2, "ray_bounces": 1299, "counts": COUNTS,
        "bound_ms": 9.600402985074626e-05, "bound_by": "operations", "bound_bytes": 221860,
        "bound_flops": 6432270, "bound_tf32_flops": 0}


@pytest.mark.parametrize("args,want_ms,by", [
    ((123456789, 987654321, 5e9), 0.0368527728358209, "bytes"),
    ((10**12, 10**9), 298.5074626865671, "bytes"),
    ((1000, 6.7e10), 1.0, "operations"),
    ((1000, 1e9, 4.95e11), 1.0, "operations"),
])
def test_bound_as_chip_smoke_gave(args, want_ms, by):
    b = rl.bound(*args)
    assert b["bound_ms"] == pytest.approx(want_ms, rel=1e-15) and b["bound_by"] == by
    assert (b["bound_bytes"], b["bound_flops"]) == args[:2]
    assert b["bound_tf32_flops"] == (args[2] if len(args) > 2 else 0)


def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_under_test", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_budget_shares_from_the_settings_times():
    """Phase 31's budget: per setting 1 - t(setting) / t(base); NEE, the
    nearest walk and the floor (binned) or the dense tests (dense), from
    the kernel's ms and from its ns per ray-bounce alike."""
    cs = _chip_smoke()
    rows = {s: dict(kernel_ms=t, ns_per_ray_bounce=t / 2) for s, t in
            (("base", 10.0), ("nee", 6.0), ("bigpair", 5.0), ("prop", 9.0), ("mat", 12.0),
             ("skip", 3.0), ("nee_skip", 1.0))}
    b = cs.budget_shares(rows, dense=False)
    for unit in ("frame", "per_ray_bounce"):
        s = b[unit]
        assert s["nee"] == pytest.approx(0.4) and s["nearest_walk"] == pytest.approx(0.5)
        assert s["floor"] == pytest.approx(0.1) and s["removed_by_mat"] == pytest.approx(-0.2)
        assert s["nee"] + s["nearest_walk"] + s["floor"] == pytest.approx(1.0)
    assert b["walks"] == dict(ms=pytest.approx(7.0), nearest_ms=pytest.approx(5.0))
    dense = {k: rows[k] for k in ("base", "nee", "bigpair", "prop", "mat")}
    d = cs.budget_shares(dense, dense=True)
    assert d["frame"]["dense_tests"] == pytest.approx(0.5) and "floor" not in d["frame"]
    assert "walks" not in d


def test_frame_stats_standard_error_is_the_noise_not_the_content():
    """The frame mean's standard error comes from each pixel's variance
    across independent frames: a bright pattern that every frame shows adds
    nothing, noise does, and for pure noise it equals the spread of all
    values over sqrt(frames x pixels)."""
    cs = _chip_smoke()
    rng = np.random.default_rng(3)
    pattern = np.where(np.arange(4096) % 7 == 0, 5.0, 0.01)
    noise = rng.exponential(0.03, (4, 4096))
    mean, se = cs.frame_stats(np.broadcast_to(pattern, (4, 4096)).copy())
    assert mean == pytest.approx(pattern.mean()) and se == 0.0
    _, se_noise = cs.frame_stats(noise)
    _, se_both = cs.frame_stats(noise + pattern)
    assert se_both == pytest.approx(se_noise)
    assert se_noise == pytest.approx(noise.std() / np.sqrt(noise.size), rel=0.05)


def test_parent_comparisons_find_a_changed_instance_and_bound():
    cs = _chip_smoke()
    summary = ("megakernel<-1, 0> | 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
               "loads | Used 79 registers, used 1 barriers, 400 bytes cmem[0] | "
               "megakernel_binned<-1, 1> | 0 bytes stack frame, 20 bytes spill stores, 20 bytes "
               "spill loads | Used 96 registers, used 1 barriers, 400 bytes cmem[0]")
    assert cs.ptxas_registers(summary) == {"megakernel<-1, 0>": (79, 0),
                                           "megakernel_binned<-1, 1>": (96, 20)}
    # Instances that do not walk must equal the parent's; the walking ones
    # (megakernel_binned, ...) are listed beside the parent's instead.
    same = cs.ptxas_against_parent({"megakernel": summary + " | megakernel_ablate<-1, 0> | Used "
                                    "78 registers"}, {"megakernel": summary})
    assert same == {"instances_compared": 1, "differ": {}, "walk_regressed": {}, "walking": {
        "megakernel:megakernel_binned<-1, 1>": dict(parent=(96, 20), ours=(96, 20))}}
    moved = cs.ptxas_against_parent({"megakernel": summary.replace("79 registers", "80 registers")},
                                    {"megakernel": summary})
    assert list(moved["differ"]) == ["megakernel:megakernel<-1, 0>"]
    walked = cs.ptxas_against_parent({"megakernel": summary.replace("96 registers", "94 registers")},
                                     {"megakernel": summary})
    assert walked["differ"] == {} and walked["walk_regressed"] == {} and walked["walking"] == {
        "megakernel:megakernel_binned<-1, 1>": dict(parent=(96, 20), ours=(94, 20))}
    # A walking instance the main path launches (counting flag 0, no
    # ablation) may not spill more than the parent's, nor nothing where the
    # parent has none by its name, nor hold fewer blocks an SM; counting
    # and ablation instances are listed only.
    plain = ("megakernel_binned<-1, 0> | 0 bytes stack frame, 0 bytes spill stores, 0 bytes "
             "spill loads | Used 96 registers | cluster_query_kernel<0> | Used 48 registers")
    spilled = ("megakernel_binned<-1, 0> | 8 bytes stack frame, 4 bytes spill stores, 4 bytes "
               "spill loads | Used 96 registers | megakernel_binned<-1, 1> | 68 bytes spill "
               "stores | Used 96 registers | megakernel_binned_ablate<-1, 0> | 4 bytes spill "
               "stores | Used 96 registers | cluster_query_kernel<0, 1> | 8 bytes spill stores "
               "| Used 47 registers | cluster_query_kernel<1, 1> | 8 bytes spill stores")
    grew = cs.ptxas_against_parent({"k": spilled}, {"k": plain + " | " + summary})
    assert grew["walk_regressed"] == {
        "k:megakernel_binned<-1, 0>": {"spill_stores": dict(ours=4, parent=0)},
        "k:cluster_query_kernel<0, 1>": {"spill_stores": dict(ours=8, parent=0)}}
    occ = {"megakernel_binned<-1, 0>": [5, 128], "cluster_query_kernel<0, 1>": [9, 128]}
    fewer = cs.ptxas_against_parent({"k": plain}, {"k": plain}, {
        **occ, "megakernel_binned<-1, 0>": [4, 128]}, occ)
    assert fewer["walk_regressed"] == {
        "k:megakernel_binned<-1, 0>": {"blocks_per_sm": dict(ours=4, parent=5)}}
    assert cs.ptxas_against_parent({"k": plain}, {"k": plain}, occ, occ)["walk_regressed"] == {}
    # bounce_binned_kernel<CULL, kRec, kCount>: the record form is one the
    # main path launches, the counting form is not.
    assert [cs.walk_plain(i) for i in ("bounce_binned_kernel<1, 1, 0>",
                                       "bounce_binned_kernel<1, 0, 1>",
                                       "bounce_binned_kernel_ablate<1, 0>",
                                       "cluster_query_kernel<0, 1>", "megakernel<-1, 0>")] == [
        True, False, False, True, False]
    ours = {"main_path": {"bound_ms": 0.5, "k": [{"bound_ms": 1.0}]}, "frame_budget": {"bound_ms": 9}}
    parent = {"main_path": {"bound_ms": 0.5, "k": [{"bound_ms": 1.5}]}}
    out = cs.bounds_against_parent(ours, parent, ["main_path"])
    assert out["compared"] == 2 and list(out["differ"]) == ["main_path/k/0"]
