"""Render checkpoint / resume.

Port of `cpupathtrace_tpu/integrator/checkpoint.py`. A fixed-spp render is
a sequence of spp chunks accumulating (pixel_sum, sample_count) on the
host. Chunk c draws from a torch.Generator of its own, seeded from
(seed, c) alone (`rng.chunk_seed`, the counterpart of JAX's
fold_in(PRNGKey(seed), c)), so a render resumed from its checkpoint is bit
for bit the uninterrupted render on the same device. `render()` keeps its
one generator through every tile; this schedule is the resumable one's
only.

The checkpoint file is the JAX package's: an .npz of `pixel_sum` float64
[P, 4], `sample_count` int64 [P] and a JSON `meta` (format version 3), so a
FilmState saved by either package loads in the other. The fingerprint
hashes each package's own scene tensors, so a resume against the other
package's scene is refused.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import numpy as np
import torch

from ..camera.camera import Camera
from ..core.config import RenderOptions, resolve_device
from ..scene.scene import TENSOR_FIELDS, SceneData
from .film import pixel_camera_coords, render_chunk
from .rng import chunk_seed

_FORMAT_VERSION = 3
# The camera's tensors, in dataclass order.
CAMERA_FIELDS = ("origin", "forward", "up", "right")


def render_fingerprint(scene: SceneData, camera: Camera) -> str:
    """blake2b-16 digest of every tensor of the scene (dataclass order),
    then of the camera's. Stored in the checkpoint so a resume against
    other render inputs is refused instead of blended into the sums. It
    copies every scene tensor to the host (about 1.5 GB on the 7.2M
    dragon)."""
    h = hashlib.blake2b(digest_size=16)
    names = [f.name for f in dataclasses.fields(scene) if f.name in TENSOR_FIELDS]
    for t in [getattr(scene, n) for n in names] + [getattr(camera, n) for n in CAMERA_FIELDS]:
        h.update(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    return h.hexdigest()


@dataclasses.dataclass
class FilmState:
    """Savable accumulation state of a fixed-spp render."""

    pixel_sum: np.ndarray  # [P, 4] float64 accumulation
    sample_count: np.ndarray  # [P] int64
    chunks_done: int
    spp: int
    spp_chunk: int
    seed: int
    width: int
    height: int
    fingerprint: str = ""

    def image(self) -> np.ndarray:
        """Current mean image [H, W, 4] (alpha = coverage)."""
        img = self.pixel_sum / np.maximum(self.sample_count, 1)[:, None]
        img[:, 3] = (self.sample_count > 0).astype(np.float64)
        return img.reshape(self.height, self.width, 4).astype(np.float32)


def save_checkpoint(path: str, state: FilmState) -> None:
    """Write `state` to `path` atomically (a temporary file, then
    os.replace)."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        pixel_sum=state.pixel_sum,
        sample_count=state.sample_count,
        meta=json.dumps(
            {
                "version": _FORMAT_VERSION,
                "chunks_done": state.chunks_done,
                "spp": state.spp,
                "spp_chunk": state.spp_chunk,
                "seed": state.seed,
                "width": state.width,
                "height": state.height,
                "fingerprint": state.fingerprint,
            }
        ),
    )
    # np.savez appends .npz when missing.
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)


def load_checkpoint(path: str) -> FilmState:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        return FilmState(
            pixel_sum=z["pixel_sum"],
            sample_count=z["sample_count"],
            chunks_done=meta["chunks_done"],
            spp=meta["spp"],
            spp_chunk=meta["spp_chunk"],
            seed=meta["seed"],
            width=meta["width"],
            height=meta["height"],
            fingerprint=meta.get("fingerprint", ""),
        )


def render_resumable(
    scene: SceneData,
    camera: Camera,
    options: RenderOptions,
    spp: int,
    seed: int = 0,
    spp_chunk: int = 64,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 1,
    progress_callback=None,
    mesh=None,
    device=None,
) -> FilmState:
    """Fixed-spp render on `device` (default: the CUDA card) with periodic
    checkpoints; resumes from `checkpoint_path` when it exists. The spp are
    rendered in chunks of `spp_chunk` (the last one smaller when it does not
    divide), chunk c through `render_chunk` with a generator seeded by
    `chunk_seed(seed, c)`, so resumed and uninterrupted renders are bit for
    bit equal. A checkpoint is saved every `checkpoint_every` chunks and
    at the end; a checkpoint of another config (width, height, spp,
    spp_chunk, seed) or fingerprint raises ValueError.

    With `mesh` (a (dp, sp) mesh, parallel/mesh.py) each chunk renders
    sharded over it (`parallel.render.render_chunk_sharded`): chunk c's
    shards draw from shard_seed(chunk_seed(seed, c), dp_i, sp_i), every
    rank of the mesh calls this with the same arguments and gets the same
    state, and the mesh's rank (0, 0) writes the checkpoint of the
    all-reduced film (the others wait for it). Resumed on the same mesh
    shape the render is bit-equal to an uninterrupted one; on another shape
    (an elastic restart) the remaining chunks draw from that shape's
    streams, still an unbiased render. The device is the mesh's."""
    writer = True
    if mesh is not None:
        from ..parallel.mesh import mesh_barrier, mesh_coords, mesh_device, mesh_dims
        from ..parallel.render import render_chunk_sharded

        dp, sp = mesh_dims(mesh)
        chunk = min(spp_chunk, spp)
        if chunk % sp != 0:
            raise ValueError(f"spp_chunk {chunk} not divisible by the mesh's "
                             f"sample-parallel axis sp={sp}")
        if spp % chunk != 0 and (spp % chunk) % sp != 0:
            raise ValueError(f"final chunk of {spp % chunk} spp not divisible by sp={sp}")
        dev = mesh_device(mesh)
        writer = mesh_coords(mesh) == (0, 0)
    else:
        dev = resolve_device(device)
    scene = scene.to(dev)
    camera = camera.to(dev)
    w, h = options.image_width, options.image_height
    spp_chunk = min(spp_chunk, spp)
    n_chunks = -(-spp // spp_chunk)
    # The fingerprint copies every scene tensor to the host: only paid
    # for when checkpointing.
    fingerprint = render_fingerprint(scene, camera) if checkpoint_path else ""

    state = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = load_checkpoint(checkpoint_path)
        if (
            state.width != w or state.height != h
            or state.spp != spp
            or state.spp_chunk != spp_chunk or state.seed != seed
        ):
            raise ValueError("checkpoint is for a different render config")
        if state.fingerprint and state.fingerprint != fingerprint:
            raise ValueError(
                "checkpoint was taken for a different scene/camera "
                f"(fingerprint {state.fingerprint} != {fingerprint})"
            )
    if state is None:
        state = FilmState(
            pixel_sum=np.zeros((w * h, 4), np.float64),
            sample_count=np.zeros(w * h, np.int64),
            chunks_done=0,
            spp=spp,
            spp_chunk=spp_chunk,
            seed=seed,
            width=w,
            height=h,
            fingerprint=fingerprint,
        )

    xg, yg = np.meshgrid(np.arange(w, dtype=np.float32), np.arange(h, dtype=np.float32))
    x_cam, y_cam = pixel_camera_coords(options, xg.ravel(), yg.ravel())
    n = x_cam.size
    if mesh is not None:
        pad = (-n) % dp
        x_cam = np.concatenate([x_cam, np.zeros(pad, np.float32)])
        y_cam = np.concatenate([y_cam, np.zeros(pad, np.float32)])
    x_cam = torch.from_numpy(np.ascontiguousarray(x_cam, np.float32)).to(dev)
    y_cam = torch.from_numpy(np.ascontiguousarray(y_cam, np.float32)).to(dev)

    def save():
        if writer:
            save_checkpoint(checkpoint_path, state)
        if mesh is not None:
            mesh_barrier(mesh)

    for c in range(state.chunks_done, n_chunks):
        chunk = min(spp_chunk, spp - c * spp_chunk)
        if mesh is not None:
            s, cnt = render_chunk_sharded(scene, camera, options, mesh, x_cam, y_cam,
                                          chunk_seed(seed, c), chunk)
            s, cnt = s[:n], cnt[:n]
        else:
            generator = torch.Generator(device=dev)
            generator.manual_seed(chunk_seed(seed, c))
            s, cnt = render_chunk(scene, camera, options, x_cam, y_cam, generator, chunk)
        state.pixel_sum += s.detach().cpu().numpy().astype(np.float64)
        state.sample_count += cnt.cpu().numpy().astype(np.int64)
        state.chunks_done = c + 1
        if checkpoint_path and (c + 1) % checkpoint_every == 0:
            save()
        if progress_callback is not None:
            progress_callback(c + 1, n_chunks)

    if checkpoint_path:
        save()
    return state
