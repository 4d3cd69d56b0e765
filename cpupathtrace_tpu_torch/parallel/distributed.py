"""Process setup and the collectives of the sharded renders.

Port of `cpupathtrace_tpu/parallel/distributed.py` to `torch.distributed`.
Every rank runs the same program; a (dp, sp) mesh (parallel/mesh.py) spans
the ranks of the world. The caller picks the backend:

  * "nccl": one rank per card, the deployment with several cards (also a
    world of one on a single card);
  * "gloo": ranks on the CPU (the tests), and several ranks sharing one
    card, on CUDA tensors (NCCL will not put two ranks on one device).

Nothing here falls back from one backend to the other. The collectives are
built from `all_reduce` (SUM, MIN) alone (`broadcast` is the only other
operation admitted): the operations that NCCL and gloo on CUDA tensors both
provide, so one code path serves every deployment, and no collective copies
a CUDA tensor to the host. The counted `all_reduce` lives in
core/collectives.py (the geometry-parallel combine in ops/ uses it too)
and is re-exported here.
`gather_image` is an all_reduce SUM of a zero-filled full-height buffer
into which each rank writes its rows (adding +0.0 changes no value).

`spawn_ranks` starts a world of processes on this host (the tests, the
scaling harness, chip_smoke.py): they meet through a FileStore in a
temporary directory, so no port is raced for, and the parent joins them
under a deadline and kills what is left, so a failed rank shows as a
failure and never as a hang.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..core.collectives import (  # noqa: F401 - re-exported
    all_reduce, collective_stats, group_size, time_collectives)

# Seconds a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT_S = 300.0
_TIMEOUT = [DEFAULT_TIMEOUT_S]


def _launched() -> bool:
    """True under a launcher that sets the world (torchrun)."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the world of ranks (JAX's :18-38). Under torchrun every
    argument but `backend` comes from the environment (env://); else pass
    `init_method` (e.g. "file:///shared/dir/store" or "tcp://localhost:
    29500"), `world_size` and `rank`. A no-op when the world is already up,
    or for one process without a launcher and no arguments (a mesh then
    makes a world of one, `ensure_world`). `backend` is "nccl" (a rank per
    card) or "gloo" (CPU ranks, or ranks sharing a card); it is never
    chosen here. On a machine with CUDA the rank's current card is its
    LOCAL_RANK (else its rank) modulo the cards."""
    if dist.is_initialized():
        return
    if init_method is None and world_size is None and rank is None and not _launched():
        return
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize: backend must be 'nccl' (a rank per card) or 'gloo' "
                         f"(CPU ranks, or ranks sharing a card), got {backend!r}")
    _TIMEOUT[0] = float(timeout_s)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
        torch.cuda.init()


def ensure_world(device_type: str) -> None:
    """A world of one in this process when none is up and no launcher set
    one (the JAX package's single-process mesh): NCCL for "cuda", gloo for
    "cpu", meeting through an in-process HashStore."""
    if dist.is_initialized():
        return
    if _launched():
        raise RuntimeError("under a launcher: call initialize(backend=...) first")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was asked for but CUDA is not available; "
                               "pass device_type='cpu' to run on the CPU")
        torch.cuda.init()  # the current card is chosen before a mesh is made
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no backend for device type {device_type!r}")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=_TIMEOUT[0]))


def group_timeout_s() -> float:
    """The timeout `initialize` gave the world, which meshes give their
    groups."""
    return _TIMEOUT[0]


def global_render_mesh(sample_axis: int | None = None, device_type: str = "cuda"):
    """A (dp, sp) mesh over every rank of the world."""
    from .mesh import make_render_mesh

    return make_render_mesh(None, sample_axis=sample_axis, device_type=device_type)


def host_local_rows(height: int, rank: int | None = None,
                    world: int | None = None) -> tuple[int, int]:
    """The contiguous row range [lo, hi) rank `rank` of `world` renders
    when the rows are split across ranks (default: this rank of the
    world); the last ranks get fewer rows when `height` does not divide."""
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    rows = -(-height // world)
    lo = min(rank * rows, height)
    return lo, min(lo + rows, height)


def gather_image(local_rows, height: int, group=None):
    """Every rank's row block (from `host_local_rows`) gathered into the
    full image on every rank of `group` (default: the world). Each block
    is padded to the common ceil(height / p) rows, as JAX's, then the
    result is trimmed to `height`: an all_reduce SUM of a zero-filled
    [p * rows, ...] buffer holding this rank's block at its place. A
    tensor comes back on its device; numpy in, numpy out (gloo only)."""
    as_numpy = isinstance(local_rows, np.ndarray)
    local = torch.from_numpy(np.ascontiguousarray(local_rows)) if as_numpy else local_rows
    p = group_size(group)
    if p == 1:
        return local_rows
    rows = -(-height // p)
    i = dist.get_rank(group)
    if local.shape[0] > rows:
        raise ValueError(f"gather_image: {local.shape[0]} rows exceed ceil({height} / {p})")
    buf = torch.zeros((p * rows,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=local.device)
    buf[i * rows:i * rows + local.shape[0]] = local
    out = all_reduce(buf, "sum", group)[:height]
    return out.numpy() if as_numpy else out


# ---------------------------------------------------------------------------
# A world of processes on this host.
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, world, backend, store, out_dir, args, timeout_s, threads):
    torch.set_num_threads(threads)
    try:
        initialize(backend, init_method=f"file://{store}", world_size=world, rank=rank,
                   timeout_s=timeout_s)
        out = {"ok": True, "value": fn(rank, world, *args)}
    except BaseException:  # noqa: BLE001 - reported to the parent
        out = {"ok": False, "error": traceback.format_exc()}
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(out, f)
    os.replace(path + ".tmp", path)
    # Skip the interpreter's teardown: a process group whose peer is gone
    # can block in its destructor.
    os._exit(0)


def spawn_ranks(fn, world: int, backend: str, args=(), deadline_s: float = 600.0,
                timeout_s: float = 60.0, threads: int = 1) -> list:
    """Run `fn(rank, world, *args)` in `world` new processes (the spawn
    method: a parent with CUDA up cannot fork) that first `initialize`
    with `backend` through a FileStore in a temporary directory, their
    collectives timing out after `timeout_s` and torch capped at `threads`
    threads. `fn` and `args` must pickle (a module-level function). Returns
    the ranks' return values in rank order. Raises RuntimeError, after
    killing every process still running, when a rank raised, died or the
    world outlived `deadline_s`."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ptx_ranks_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, backend, store, tmp, tuple(args), timeout_s,
                               threads))
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        for p in procs:
            p.join(max(0.0, end - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        results, errors = [], []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: " + ("still running at the deadline" if r in late
                                                else f"died (exit code {procs[r].exitcode})"))
                results.append(None)
                continue
            with open(path, "rb") as f:
                out = pickle.load(f)
            if not out["ok"]:
                errors.append(f"rank {r} raised:\n{out['error']}")
            results.append(out.get("value"))
        if errors:
            raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, world={world}, "
                               f"{backend}):\n" + "\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(tmp, ignore_errors=True)
