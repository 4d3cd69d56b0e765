"""Device-mesh construction for sharded rendering.

Port of `cpupathtrace_tpu/parallel/mesh.py`. The JAX package's named
`Mesh` becomes a `torch.distributed.device_mesh.DeviceMesh` over ranks of
the world, with two dimensions:

  * `dp`: data parallel over pixels (each shard a contiguous block of the
    pixel axis);
  * `sp`: sample parallel over samples per pixel (the sample sums are
    all-reduced over `sp`).

A shard's coordinates are `mesh.get_local_rank("dp")` and
`mesh.get_local_rank("sp")`; the psum over sp is an all_reduce on
`mesh.get_group("sp")`. Scene and camera are replicated on every rank.
Every rank of the world builds every mesh (its groups are made
collectively), including meshes it is not part of.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .distributed import all_reduce, ensure_world, group_timeout_s


def mesh_shape(n: int, sample_axis: int | None = None) -> tuple[int, int]:
    """(dp, sp) of a mesh over `n` ranks: `sample_axis` fixes sp; by
    default the largest of 4, 2 that divides n with n // sp >= sp (small
    counts stay pixel-dominant), else 1. ValueError when sp does not
    divide n."""
    if sample_axis is None:
        sample_axis = 1
        for cand in (4, 2):
            if n % cand == 0 and n // cand >= cand:
                sample_axis = cand
                break
    if n % sample_axis != 0:
        raise ValueError(f"device count {n} not divisible by sample_axis {sample_axis}")
    return n // sample_axis, sample_axis


def mesh_ranks(ranks) -> list[int]:
    """The ranks a mesh spans: None, every rank of the world; an int n,
    ranks 0..n-1; else the ranks given."""
    if ranks is None:
        return list(range(dist.get_world_size()))
    if isinstance(ranks, int):
        return list(range(ranks))
    return [int(r) for r in ranks]


def device_mesh(ranks: list[int], shape, names, device_type: str) -> DeviceMesh:
    """A DeviceMesh of `shape` named `names` over the list `ranks`, whose
    groups take the world's collective timeout (new groups otherwise take
    the backend's default of 10-30 minutes)."""
    mesh = DeviceMesh(device_type, torch.tensor(ranks, dtype=torch.int64).reshape(shape),
                      mesh_dim_names=names)
    set_timeout = getattr(dist.distributed_c10d, "_set_pg_timeout", None)
    if set_timeout is not None and mesh.get_coordinate() is not None:
        for name in names:
            set_timeout(datetime.timedelta(seconds=group_timeout_s()), mesh.get_group(name))
    return mesh


def make_render_mesh(ranks=None, sample_axis: int | None = None,
                     device_type: str = "cuda") -> DeviceMesh:
    """A (dp, sp) DeviceMesh over `ranks` (None: every rank of the world;
    an int n: ranks 0..n-1; or a list of ranks) on `device_type`
    ("cuda": the rank's current card; "cpu" for the tests). One process
    without a world gets a world of one (`ensure_world`)."""
    ensure_world(device_type)
    ranks = mesh_ranks(ranks)
    return device_mesh(ranks, mesh_shape(len(ranks), sample_axis), ("dp", "sp"), device_type)


def mesh_dims(mesh: DeviceMesh) -> tuple[int, int]:
    """(dp, sp) of a render mesh."""
    return mesh.size(0), mesh.size(1)


def mesh_coords(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (dp_i, sp_i); ValueError when it is not in the mesh."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh {mesh.mesh.tolist()}")
    return tuple(int(c) for c in coord)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors of `mesh` live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_barrier(mesh: DeviceMesh) -> None:
    """Wait for every rank of the mesh: an all_reduce over each dimension
    in turn (every rank then has heard from every other one)."""
    dev = mesh_device(mesh)
    for name in mesh.mesh_dim_names:
        all_reduce(torch.zeros(1, device=dev), "sum", mesh.get_group(name))
