"""The JAX package's TPU microbenchmarks (benchmarks/experiments/) as CUDA
microbenchmarks on the card: one module per question, each with its kernel
(csrc/exp_*.cu), a plain-torch version of the same function, and a `main()`
that runs the TPU script's sweep on the card and prints one line per
configuration beside the card's name and power limit:

    python -m cpupathtrace_tpu_torch.experiments.supscan          # X1
    python -m cpupathtrace_tpu_torch.experiments.record_variants  # X3
    python -m cpupathtrace_tpu_torch.experiments.smem_tables      # X5

Each keeps its TPU script's method: the difference between two in-kernel
iteration counts (X1, X3) or the best of 5 launches (X5), timed with CUDA
events. The wrappers launch the kernel for CUDA tensors and take the plain
version for CPU tensors.
"""
from __future__ import annotations

import subprocess

import torch


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("this microbenchmark measures the CUDA card: none is available")


def best_ms(fn, reps: int) -> float:
    """The least of `reps` single-launch times by CUDA events, after one
    warm launch."""
    fn()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best
