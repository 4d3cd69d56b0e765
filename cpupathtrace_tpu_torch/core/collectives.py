"""The one collective primitive of the port: a counted `all_reduce`.

The sharded renders (parallel/) and the geometry-parallel combine
(ops/intersect.py) build every collective from this `all_reduce` (SUM,
MIN): the operation that NCCL and gloo on CUDA tensors both provide, so one
code path serves every deployment, and no collective copies a CUDA tensor
to the host. parallel/distributed.py re-exports it with the process setup.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

# Calls, bytes and seconds of the collectives issued through `all_reduce`;
# seconds only while `time_collectives(True)` (each timed
# call first waits for the card, so the time is the collective's own).
_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_TIMED = [False]


def collective_stats(reset: bool = False) -> dict:
    """A copy of the collective counters; `reset` zeroes them after."""
    out = dict(_STATS)
    if reset:
        _STATS.update(calls=0, bytes=0, seconds=0.0)
    return out


def time_collectives(on: bool) -> None:
    """Time every collective (a card sync before each) while `on`."""
    _TIMED[0] = bool(on)


def group_size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce(tensor: torch.Tensor, op: str, group) -> torch.Tensor:
    """In-place all_reduce of `tensor` over `group` with op "sum" or "min";
    a group of one rank is left alone. Returns `tensor`."""
    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN}
    if op not in ops:
        raise ValueError(f"all_reduce: op {op!r} is not one of {sorted(ops)}")
    if group_size(group) == 1:
        return tensor
    timed = _TIMED[0]
    if timed:
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        t0 = time.perf_counter()
    dist.all_reduce(tensor, op=ops[op], group=group)
    if timed:
        if tensor.is_cuda:
            torch.cuda.synchronize(tensor.device)
        _STATS["seconds"] += time.perf_counter() - t0
    _STATS["calls"] += 1
    _STATS["bytes"] += tensor.numel() * tensor.element_size()
    return tensor
