"""Sharded rendering over a (dp, sp) mesh of ranks.

Port of `cpupathtrace_tpu/parallel/render.py`. The pixel axis is split
over `dp` (each shard a contiguous block, the pixels padded to a multiple
of dp) and the samples per pixel over `sp`. Each shard traces its
samples through `film.render_chunk`, so through `_dispatch_trace` and the
kernels (K1, K2) or their twins, launched sample-major as the JAX sharded
path launches (render.py:227-230). Its sample sums and counts, packed as
one [P/dp, 5] float32 buffer (counts are exact below 2^24), are
all-reduced over `sp` (JAX's psum) and then gathered over `dp` by an
all_reduce SUM of a zero-filled [P, 5] buffer, so every rank returns the
whole chunk.

RNG: shard (dp_i, sp_i) of a launch with seed `key` draws from its own
torch.Generator, on its own device, seeded by `rng.shard_seed(key, dp_i,
sp_i)` (JAX folds the mesh coordinates into the key, :38-40). A render is
therefore a function of (seed, mesh shape) alone: `render_chunk_serial`
renders the same shards one after another in one process (the serial
oracle the tests and chip_smoke.py hold the sharded path to). The sp sums
of two shards are exact in either order; over four the all_reduce's order
of additions may differ from the oracle's in the last bits.

A differentiable chunk keeps, on each rank, the graph of its own samples
only (the value is the all-reduced total): the gradient of a loss of the
whole chunk on one rank is that rank's share, and the shares summed over
the mesh are the gradient (parallel/train.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..camera.camera import Camera
from ..core.config import RenderOptions
from ..integrator.film import (
    adaptive_constants,
    pixel_camera_coords,
    render_chunk,
    render_chunk_batched,
    render_tile,
)
from ..integrator.rng import shard_seed
from ..scene.scene import SceneData
from .distributed import all_reduce
from .mesh import mesh_coords, mesh_device, mesh_dims

# Counts ride the float32 sum buffer: exact below 2^24 samples a pixel.
_MAX_SPP = 1 << 24


def _check(p: int, dp: int, spp: int, sp: int, what: str = "spp"):
    if p % dp != 0:
        raise ValueError(f"pixel count {p} not divisible by dp={dp}")
    if spp % sp != 0:
        if what == "spp":
            raise ValueError(f"spp {spp} not divisible by sp={sp}")
        raise ValueError(
            f"stats batch size {spp} not divisible by sp={sp}; use "
            "make_render_mesh(sample_axis=...) with a divisor of the adaptive stats "
            "batch size")
    if spp >= _MAX_SPP:
        raise ValueError(f"spp {spp} >= 2^24: the counts would not be exact")


def _shard_chunk(scene, camera, options, x_loc, y_loc, seed, spp_local, k_batches,
                 differentiable=False):
    """One shard's (sums, counts): [P, 4], [P] for k_batches None, else
    [K, P, 4], [K, P] (film.render_chunk / render_chunk_batched)."""
    gen = torch.Generator(device=x_loc.device)
    gen.manual_seed(seed)
    if k_batches is None:
        return render_chunk(scene, camera, options, x_loc, y_loc, gen, spp_local,
                            differentiable=differentiable)
    return render_chunk_batched(scene, camera, options, x_loc, y_loc, gen, spp_local,
                                k_batches)


def _sharded(scene, camera, options, mesh, x_cam, y_cam, key, spp_local, k_batches,
             differentiable=False):
    dp, _ = mesh_dims(mesh)
    dp_i, sp_i = mesh_coords(mesh)
    p = x_cam.shape[0]
    pl = p // dp
    rows = slice(dp_i * pl, (dp_i + 1) * pl)
    s, c = _shard_chunk(scene, camera, options, x_cam[rows], y_cam[rows],
                        shard_seed(key, dp_i, sp_i), spp_local, k_batches, differentiable)
    local = torch.cat([s.detach(), c.to(s.dtype)[..., None]], -1)
    all_reduce(local, "sum", mesh.get_group("sp"))
    if dp > 1:
        full = torch.zeros(local.shape[:-2] + (p, 5), dtype=local.dtype, device=local.device)
        full[..., rows, :] = local
        local = all_reduce(full, "sum", mesh.get_group("dp"))
    sums, counts = local[..., :4], local[..., 4].to(torch.int32)
    if differentiable:
        # The value stays the all-reduced total (x + 0.0 == x); the graph
        # is this rank's samples.
        own = torch.zeros_like(sums)
        own[..., rows, :] = s - s.detach()
        sums = sums + own
    return sums, counts


def render_chunk_sharded(scene: SceneData, camera: Camera, options: RenderOptions, mesh,
                         x_cam: torch.Tensor, y_cam: torch.Tensor, key: int, spp: int,
                         differentiable: bool = False):
    """Sharded render of P pixels (padded to a multiple of dp) at `spp`
    samples with int seed `key`; returns (sum [P, 4], collected [P] int32),
    the same on every rank of `mesh`. Tensors on this rank's device."""
    dp, sp = mesh_dims(mesh)
    _check(x_cam.shape[0], dp, spp, sp)
    return _sharded(scene, camera, options, mesh, x_cam, y_cam, key, spp // sp, None,
                    differentiable)


def render_chunk_batched_sharded(scene: SceneData, camera: Camera, options: RenderOptions,
                                 mesh, x_cam: torch.Tensor, y_cam: torch.Tensor, key: int,
                                 spp_batch: int, k_batches: int):
    """The sharded film.render_chunk_batched: `k_batches` stats batches of
    `spp_batch` samples in one launch a shard; returns (sums [K, P, 4],
    counts [K, P]), the same on every rank."""
    dp, sp = mesh_dims(mesh)
    _check(x_cam.shape[0], dp, spp_batch, sp, what="stats")
    return _sharded(scene, camera, options, mesh, x_cam, y_cam, key, spp_batch // sp,
                    k_batches)


def render_chunk_serial(scene: SceneData, camera: Camera, options: RenderOptions, shape,
                        x_cam: torch.Tensor, y_cam: torch.Tensor, key: int, spp: int,
                        k_batches: int | None = None, differentiable: bool = False):
    """The serial oracle of `render_chunk_sharded` (k_batches None) and
    `render_chunk_batched_sharded` (spp the batch size): the shards of a
    (dp, sp) = `shape` mesh rendered one after another in this process,
    with the same generators, their sp sums added in sp order."""
    dp, sp = shape
    _check(x_cam.shape[0], dp, spp, sp)
    pl = x_cam.shape[0] // dp
    sums, counts = [], []
    for dp_i in range(dp):
        rows = slice(dp_i * pl, (dp_i + 1) * pl)
        s_tot = c_tot = None
        for sp_i in range(sp):
            s, c = _shard_chunk(scene, camera, options, x_cam[rows], y_cam[rows],
                                shard_seed(key, dp_i, sp_i), spp // sp, k_batches,
                                differentiable)
            s_tot = s if s_tot is None else s_tot + s
            c_tot = c if c_tot is None else c_tot + c
        sums.append(s_tot)
        counts.append(c_tot)
    axis = 0 if k_batches is None else 1
    return torch.cat(sums, axis), torch.cat(counts, axis)


def pixel_coords(options: RenderOptions, dp: int, device, rows=None):
    """(x_cam, y_cam) [P] float32 of the image's pixels (of `rows`, a
    range, when given) in sample-major order, padded with zeros to a
    multiple of dp, on `device`; and the unpadded count."""
    w, h = options.image_width, options.image_height
    rows = range(h) if rows is None else rows
    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.asarray(rows, dtype=np.float32))
    x, y = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    n = x.size
    pad = (-n) % dp
    if pad:
        x = np.concatenate([x, np.zeros(pad, np.float32)])
        y = np.concatenate([y, np.zeros(pad, np.float32)])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return dev(x), dev(y), n


def _image(s, c, n, h, w):
    """The [h, w, 4] float32 image of the first n pixels' sums and counts,
    normalised on their device (as render_tile does) before the one copy
    to the host; pixels that collected nothing stay zero."""
    s, c = s[:n].detach(), c[:n]
    img = torch.where((c > 0)[:, None], s / c.clamp_min(1).to(s.dtype)[:, None], 0.0)
    return img.reshape(h, w, 4).cpu().numpy()


def render_sharded(scene: SceneData, camera: Camera, options: RenderOptions, mesh,
                   seed: int = 0, spp: int | None = None) -> np.ndarray:
    """Full-frame fixed-spp sharded render (JAX's :143-182); returns the
    [H, W, 4] float32 image on every rank."""
    w, h = options.image_width, options.image_height
    spp = spp if spp is not None else options.max_sample_count
    dev = mesh_device(mesh)
    x, y, n = pixel_coords(options, mesh_dims(mesh)[0], dev)
    s, c = render_chunk_sharded(scene.to(dev), camera.to(dev), options, mesh, x, y, seed, spp)
    return _image(s, c, n, h, w)


def render_serial(scene: SceneData, camera: Camera, options: RenderOptions, shape,
                  seed: int = 0, spp: int | None = None, device=None) -> np.ndarray:
    """The serial oracle of `render_sharded` for a (dp, sp) = `shape` mesh,
    on `device` (default: the scene's)."""
    w, h = options.image_width, options.image_height
    spp = spp if spp is not None else options.max_sample_count
    dev = scene.device if device is None else torch.device(device)
    x, y, n = pixel_coords(options, shape[0], dev)
    s, c = render_chunk_serial(scene.to(dev), camera.to(dev), options, shape, x, y, seed, spp)
    return _image(s, c, n, h, w)


def adaptive_sample_axis(options: RenderOptions, n_devices: int) -> int:
    """The largest valid sp for an adaptive sharded render: it divides the
    rank count, the stats batch size and the final remainder chunk, so
    every sharded launch splits its samples evenly (JAX's :185-205)."""
    stats, _, _ = adaptive_constants(options)
    max_sc = options.max_sample_count
    remainder = max_sc - (max_sc // stats) * stats
    for cand in (4, 2):
        if (n_devices % cand == 0 and n_devices // cand >= cand and stats % cand == 0
                and remainder % cand == 0):
            return cand
    return 1


def draw_launch_seed(generator: torch.Generator) -> int:
    """The int seed of one sharded launch, drawn from a CPU generator that
    every rank holds in the same state (no read from the card)."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator))


def _adaptive(scene, camera, options, dp, sp, seed, progress_callback, rays_per_launch,
              dev, chunk_fns):
    w, h = options.image_width, options.image_height
    if w <= 0 or h <= 0:
        return np.zeros((max(h, 0), max(w, 0), 4), np.float32)
    stats, _, _ = adaptive_constants(options)
    max_sc = options.max_sample_count
    remainder = max_sc - (max_sc // stats) * stats
    if stats % sp != 0 or remainder % sp != 0:
        raise ValueError(
            f"adaptive stats batches ({stats} spp, remainder {remainder}) not divisible by "
            f"the sample-parallel axis sp={sp}; build the mesh with make_render_mesh("
            f"sample_axis={adaptive_sample_axis(options, dp * sp)})")
    scene, camera = scene.to(dev), camera.to(dev)
    rows_per_tile = max(1, min(h, rays_per_launch // max(w * stats, 1)))
    n_tiles = math.ceil(h / rows_per_tile)
    image = np.zeros((h, w, 4), np.float32)
    # The launches' seeds come from one CPU generator, drawn in the same
    # order on every rank (the tiles' flags are the same everywhere).
    gen = torch.Generator()
    gen.manual_seed(int(seed))
    for i in range(n_tiles):
        y0 = i * rows_per_tile
        rows = min(rows_per_tile, h - y0)
        x, y, n = pixel_coords(options, dp, dev, range(y0, y0 + rows))
        tile = render_tile(scene, camera, options, x, y, gen, chunk_fns=chunk_fns(x, y))
        image[y0:y0 + rows] = tile[:n].reshape(rows, w, 4).cpu().numpy()
        if progress_callback is not None:
            progress_callback(i + 1, n_tiles)
    return image


def render_sharded_adaptive(scene: SceneData, camera: Camera, options: RenderOptions, mesh,
                            seed: int = 0, progress_callback=None,
                            rays_per_launch: int = 1 << 20) -> np.ndarray:
    """Full-frame adaptive sharded render (JAX's :208-293): `render()`'s
    min / max-spp stopping rule (film.render_tile, unchanged) over sharded
    launches, its chunk renderers swapped for `render_chunk_sharded` /
    `render_chunk_batched_sharded`; each launch's seed drawn from one CPU
    generator seeded by `seed`. Returns [H, W, 4] on every rank. Launches
    are sample-major (no Morton pixel order)."""
    dp, sp = mesh_dims(mesh)

    def fns(x, y):
        def single(gen, spp):
            return render_chunk_sharded(scene, camera, options, mesh, x, y,
                                        draw_launch_seed(gen), spp)

        def batched(gen, spp_batch, kb):
            return render_chunk_batched_sharded(scene, camera, options, mesh, x, y,
                                                draw_launch_seed(gen), spp_batch, kb)
        return single, batched

    dev = mesh_device(mesh)
    scene, camera = scene.to(dev), camera.to(dev)
    return _adaptive(scene, camera, options, dp, sp, seed, progress_callback,
                     rays_per_launch, dev, fns)


def render_serial_adaptive(scene: SceneData, camera: Camera, options: RenderOptions, shape,
                           seed: int = 0, rays_per_launch: int = 1 << 20,
                           device=None) -> np.ndarray:
    """The serial oracle of `render_sharded_adaptive` for a (dp, sp) =
    `shape` mesh: the same driver with `render_chunk_serial` launches."""
    dev = scene.device if device is None else torch.device(device)
    scene, camera = scene.to(dev), camera.to(dev)

    def fns(x, y):
        def single(gen, spp):
            return render_chunk_serial(scene, camera, options, shape, x, y,
                                       draw_launch_seed(gen), spp)

        def batched(gen, spp_batch, kb):
            return render_chunk_serial(scene, camera, options, shape, x, y,
                                       draw_launch_seed(gen), spp_batch, k_batches=kb)
        return single, batched

    return _adaptive(scene, camera, options, shape[0], shape[1], seed, None, rays_per_launch,
                     dev, fns)
