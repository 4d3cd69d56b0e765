"""The JAX package's TPU microbenchmarks (benchmarks/experiments/) as CUDA
microbenchmarks on the card: one module per question, each with its kernel
(csrc/exp_*.cu), a plain-torch version of the same function, and a `main()`
that runs the TPU script's sweep on the card and prints one line per
configuration beside the card's name and power limit:

    python -m cpupathtrace_tpu_torch.experiments.supscan           # X1
    python -m cpupathtrace_tpu_torch.experiments.cond_fat          # X2
    python -m cpupathtrace_tpu_torch.experiments.record_variants   # X3
    python -m cpupathtrace_tpu_torch.experiments.dot_formulations  # X4
    python -m cpupathtrace_tpu_torch.experiments.smem_tables       # X5

The sweeps have no TPU script: `dense_sweep` sweeps the block shape of the
dense forms of K1 and K2 (csrc/megakernel.cu, csrc/bounce.cu),
`query_sweep` K4's ring and block and K7's pairs a thread
(csrc/cluster_query.cu, csrc/binned_isect.cu), `intersect_sweep` K6's
lanes a ray and block and K5's block and stage limit (csrc/binned_cand.cu,
csrc/dense_query.cu), and `cluster_major_sweep` K8's row splits, block,
row source and register cap (csrc/cluster_major.cu), each on the card
with `--parent` for a parent commit's kernels in the same call; `supscan`
also sweeps X1's lanes a ray, with `--parent`.

Each keeps its TPU script's method: the difference between two in-kernel
iteration counts (X1, X2, X3) or the best of several launches (X4, X5),
timed with CUDA events. The wrappers launch the kernel for CUDA tensors
and take the plain version for CPU tensors.
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


# Cycles of the spin kernel queued ahead of a timed launch (about 1 ms).
HOST_AHEAD_CYCLES = 2_000_000


def best_ms(fn, reps: int) -> float:
    """The least of `reps` single-launch times by CUDA events, after one
    warm launch. Each timed launch is queued behind a spin kernel
    (torch.cuda._sleep) that keeps the card busy while the host records the
    start event, runs the wrapper and records the end event, so the events
    time the card's work alone and not the wrapper's host time; a rep in
    which the card reached the start event before the host had recorded the
    end event is not counted (the spin doubles and the rep is run again)."""
    fn()
    best = float("inf")
    cycles = HOST_AHEAD_CYCLES
    done = 0
    while done < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        if start.query():
            end.synchronize()
            cycles *= 2
            if cycles > 64 * HOST_AHEAD_CYCLES:
                raise RuntimeError("best_ms: the host never got ahead of the card")
            continue
        end.synchronize()
        best = min(best, start.elapsed_time(end))
        done += 1
    return best
