"""The frozen roofline arithmetic against values worked out by hand, and
the device timeline's sums."""
from __future__ import annotations

import torch

from portbench import roofline as rl
from portbench.timeline import STEP_SPAN, Timeline


def test_bound_by_bytes_and_by_operations():
    b = rl.bound(3.35e12, 1.0)
    assert b["bound_s"] == 1.0 and b["bound_by"] == "bytes"
    f = rl.bound(1.0, 67e12 * 2)
    assert f["bound_s"] == 2.0 and f["bound_by"] == "operations"


def test_dense_frame_roofline_by_hand():
    r = rl.dense_frame_roofline(frame_s=1e-3, n_rays=1_000_000, n_prims=14, executed_bounces=3.0)
    # 1e6 rays x 3 bounces x (2 x 14 x 64 + 300) operations; 40 bytes a ray.
    assert abs(r["fp32_frac"] - 6.276e9 / 1e-3 / 67e12) < 1e-12
    assert abs(r["hbm_frac"] - 4e7 / 1e-3 / 3.35e12) < 1e-12
    assert r["bound"] == "fp32"


def test_frame_bound_by_hand():
    vis = torch.zeros((3, 2, 9), dtype=torch.int64)
    vis[0, 0] = torch.tensor([1, 2, 3, 4, 10, 20, 30, 40, 100])
    vis[1, 1] = torch.tensor([0, 0, 0, 0, 1, 2, 3, 4, 50])
    out = rl.frame_bound(vis, 100, 0, 2, 14, 0)
    # rows 20+40+2+4, slabs 10+30+1+3; vertex: 300 + 3 queries x 14 x 64 + 3 x 31.
    flops = 66 * 64 + 44 * 31 + 150 * (300 + 3 * 14 * 64 + 93)
    nbytes = 100 * 144 + 50 * 144 + 50 * 4
    assert out["bounces"] == 2 and out["ray_bounces"] == 150
    assert out["bound_bytes"] == nbytes and out["bound_flops"] == flops
    assert out["bound_s"] == max(nbytes / 3.35e12, flops / 67e12)


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_timeline_busy_idle_and_kernels():
    t = Timeline([
        _ev("user_annotation", STEP_SPAN, 0, 100), _ev("user_annotation", STEP_SPAN, 100, 100),
        _ev("kernel", "void ptx::megakernel<0, false>(p)", 10, 40),
        _ev("kernel", "elementwise", 30, 40), _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
                                                  150, 10),
        _ev("cpu_op", "aten::item", 100, 100), _ev("kernel", "outside", 500, 10),
    ])
    assert t.steps == 2 and abs(t.window_s - 200e-6) < 1e-12
    assert abs(t.busy_s() - 70e-6) < 1e-12  # [10, 70] and [150, 160]
    assert len(t.kernels()) == 2 and len(t.kernels(r"\bmegakernel<")) == 1
    assert abs(t.seconds(t.kernels(r"\bmegakernel<", exclude=True)) - 40e-6) < 1e-12
    gaps = dict(t.idle_gaps())
    assert abs(sum(gaps.values()) - 130e-6) < 1e-12 and "aten::item" in gaps
