"""Debug assertions of the wavefront loop (port of
`cpupathtrace_tpu/core/debug.py`; ref: include/PathTrace/base.h:59-80).

Enabled with PTX_DEBUG=1, the JAX package's switch: each check then reads
its tensor on the host and raises AssertionError on the first failure, as
an assert of the reference's debug build fires. Unset, every helper is a
no-op and costs nothing (no host sync).
"""
from __future__ import annotations

import os

import torch


def enabled() -> bool:
    return os.environ.get("PTX_DEBUG") == "1"


def check_normalized(v: torch.Tensor, name: str) -> None:
    """|length^2 - 1| < 1e-4 on the last axis (ref: base.h:59-62)."""
    if not enabled():
        return
    err = ((v * v).sum(dim=-1) - 1.0).abs()
    if not bool((err < 1e-4).all()):
        raise AssertionError(
            f"assertNormalized failed for {name}: worst |len2-1|={float(err.max())}")


def check_non_negative(x: torch.Tensor, name: str) -> None:
    """All components >= 0; NaN fails through the negated comparison
    (ref: base.h:67-77)."""
    if not enabled():
        return
    if not bool((x >= 0.0).all()):
        raise AssertionError(f"assertNonNegative failed for {name}: min={float(x.min())}")


def check_finite(x: torch.Tensor, name: str) -> None:
    """ref: base.h:79."""
    if not enabled():
        return
    if not bool(torch.isfinite(x).all()):
        raise AssertionError(f"assertFinite failed for {name}")
