"""Failure detection and elastic recovery for long sharded renders.

Port of `cpupathtrace_tpu/parallel/failover.py`:

  * DETECTION, `ping_mesh`: an all_reduce of one element over each
    dimension of the mesh, issued asynchronously and waited on under a
    deadline. A healthy mesh answers in milliseconds; a peer that is gone
    raises, and one that never joins passes the deadline.
  * RECOVERY, `render_resumable_elastic`: drives the checkpointed sharded
    render (integrator/checkpoint.py) over a list of meshes (e.g. all
    ranks, then the survivors, then one rank). A chunk that fails on this
    rank, or a collective of it that raises or passes its timeout, moves
    this rank on to the next mesh it belongs to, which pings and RESUMES
    from the shared checkpoint: no finished chunk is rendered again.

Every mesh of the list is made up front by every rank (their groups are
created collectively); a rank skips the meshes it is not part of.

Both take gloo meshes only (CPU ranks, or ranks sharing a card) and refuse
a mesh with an NCCL group of more than one rank: under NCCL a peer that is
gone leaves the collective blocked on the card until the group's timeout,
and NCCL's watchdog then tears the process down rather than raising, so
neither a deadline nor a fail-over could be kept. A world of one (no
collective) is accepted under either backend.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from .distributed import group_size
from .mesh import mesh_device


def require_gloo(mesh, what: str) -> None:
    """Raise ValueError when a dimension of `mesh` has a group of more than
    one rank on a backend other than gloo (see the module docstring)."""
    for name in mesh.mesh_dim_names:
        group = mesh.get_group(name)
        if group_size(group) > 1 and dist.get_backend(group) != "gloo":
            raise ValueError(
                f"{what}: mesh dimension {name!r} runs {dist.get_backend(group)}; failover "
                "needs gloo, since under NCCL a lost peer blocks the collective until the "
                "watchdog ends the process instead of raising")


def ping_mesh(mesh, timeout_s: float = 30.0) -> tuple[bool, float]:
    """(ok, seconds) of a health check of `mesh` from this rank (which must
    be in it): ok is False when the all_reduce raised, gave the wrong
    count, or did not complete within `timeout_s` over every dimension.
    A mesh with an NCCL group of several ranks raises ValueError."""
    require_gloo(mesh, "ping_mesh")
    t0 = time.perf_counter()
    end = t0 + timeout_s
    try:
        x = torch.ones(1, device=mesh_device(mesh))
        for name in mesh.mesh_dim_names:
            group = mesh.get_group(name)
            if group_size(group) == 1:
                continue
            work = dist.all_reduce(x, group=group, async_op=True)
            while not work.is_completed():
                if time.perf_counter() > end:
                    return False, time.perf_counter() - t0
                time.sleep(0.001)
            work.wait()
        ok = float(x.item()) == float(mesh.size())
    except Exception:  # noqa: BLE001 - any failure is an unhealthy mesh
        ok = False
    return ok, time.perf_counter() - t0


def render_resumable_elastic(scene, camera, options, spp: int, checkpoint_path: str,
                             meshes: list, seed: int = 0, spp_chunk: int = 64,
                             checkpoint_every: int = 1, progress_callback=None,
                             ping_timeout_s: float = 30.0, on_failover=None):
    """Checkpointed sharded render with mesh-degradation failover: tries
    the meshes of `meshes` this rank belongs to, in order; pings each, then
    runs `render_resumable(..., mesh=m)` from the shared checkpoint. A
    failed ping or chunk calls `on_failover(mesh_index, error)` and moves
    on. Returns the FilmState; raises RuntimeError when no mesh is left,
    and ValueError, before rendering, when a mesh this rank is in has an
    NCCL group of several ranks."""
    from ..integrator.checkpoint import render_resumable

    for mesh in meshes:
        if mesh.get_coordinate() is not None:
            require_gloo(mesh, "render_resumable_elastic")
    last_err: Exception | None = None
    for mi, mesh in enumerate(meshes):
        if mesh.get_coordinate() is None:
            continue
        ok, dt = ping_mesh(mesh, timeout_s=ping_timeout_s)
        if not ok:
            last_err = RuntimeError(f"mesh {mi} failed health ping ({dt:.1f}s)")
            if on_failover is not None:
                on_failover(mi, last_err)
            continue
        try:
            return render_resumable(
                scene, camera, options, spp=spp, seed=seed, spp_chunk=spp_chunk,
                checkpoint_path=checkpoint_path, checkpoint_every=checkpoint_every,
                progress_callback=progress_callback, mesh=mesh)
        except Exception as e:  # noqa: BLE001 - fail over, resume
            last_err = e
            if on_failover is not None:
                on_failover(mi, e)
    raise RuntimeError(
        f"all {len(meshes)} meshes exhausted; last error: {last_err!r}") from last_err
