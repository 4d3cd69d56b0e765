"""Scene table persistence: save / load a built `SceneData` to one binary
file, and a keyed build cache.

Port of `cpupathtrace_tpu/scene/cache.py`. Build once, persist every
table (the multi-gigabyte cluster records of a large binned scene
included) and reload at disk speed: a JSON header of the static fields and
an array directory, then the raw arrays, each at a 64-byte boundary.

The port's tables are not the JAX package's (compact `krn_records`
[C, rows, 32], the K6/K7 tables in the port's layout), so its files carry
their own magic and version and its keys their own prefix and suffix: a
cache directory shared by both packages never has one package load the
other's file, or overwrite it as a corrupt miss.

On the card the loader reads slices of at most `SLICE_BYTES` on a reader
thread into two pinned host buffers, in turns, and copies each slice
into its place in a device tensor allocated once, without blocking the
host; a buffer is read into again only after the event recorded behind
its copy has completed. On the CPU it reads straight into the tensors.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import struct
import threading
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..core.config import resolve_device
from .scene import GP_FIELDS, STATIC_FIELDS, SceneData

_MAGIC = b"PTXTORCH"
# Bump when the SceneData field set or a table's layout changes.
_FORMAT_VERSION = 1
_ALIGN = 64
# The file suffix and the key prefix of the port's cache files (the JAX
# package's are ".ptxs" and none).
SUFFIX = ".ptxt"
KEY_PREFIX = "cpupathtrace_tpu_torch"
# Knobs of where tables reside, not of their layout: not keyed (the JAX
# package's cache.py:196-203 skips the same two).
RESIDENCY_KNOBS = ("PTX_KRN_CLB_VMEM_MB", "PTX_KRN_BLOCK_ROWS")
# The most bytes the loader reads into one pinned buffer.
SLICE_BYTES = 256 << 20

META_FIELDS = STATIC_FIELDS + ("bvh_depth",)
ARRAY_FIELDS = tuple(f.name for f in dataclasses.fields(SceneData)
                     if f.name not in META_FIELDS + GP_FIELDS)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _torch_dtype(name: str) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=np.dtype(name))).dtype


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 tensor."""
    return t.reshape(-1).view(torch.uint8)


def save_scene(scene: SceneData, path: str | os.PathLike) -> None:
    """Persist a built scene's tables to `path` (raw binary, atomic). The
    tables are read from host memory: a scene on the card is copied to the
    host first."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    hosts = {n: getattr(scene, n).detach().cpu().contiguous() for n in ARRAY_FIELDS}
    meta = {n: getattr(scene, n) for n in META_FIELDS}
    meta["__format__"] = _FORMAT_VERSION
    entries = [
        {"name": n, "dtype": _numpy_dtype(t.dtype).str, "shape": list(t.shape)}
        for n, t in hosts.items()
    ]
    header = {"meta": meta, "arrays": entries}
    # The header's length moves the first array's offset: budget the
    # offset fields, then pad the header (JSON allows trailing blanks) to
    # the budget.
    budget = len(json.dumps(header).encode()) + 32 * len(entries) + 64
    off = (len(_MAGIC) + 8 + budget + _ALIGN - 1) // _ALIGN * _ALIGN
    hlen = off - len(_MAGIC) - 8
    for e in entries:
        e["offset"] = off
        off += hosts[e["name"]].numel() * hosts[e["name"]].element_size()
        off = (off + _ALIGN - 1) // _ALIGN * _ALIGN
    blob = json.dumps(header).encode()
    if len(blob) > hlen:
        raise RuntimeError(f"scene cache header budget exceeded ({len(blob)} > {hlen})")
    blob = blob + b" " * (hlen - len(blob))
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for e in entries:
            f.seek(e["offset"])
            f.write(_bytes(hosts[e["name"]]).numpy())
    os.replace(tmp, path)  # atomic against concurrent readers


def _read_header(f, path):
    """(meta, array entries) of an open cache file; ValueError when it is
    not one of the port's cache files or not of this format version."""
    if f.read(len(_MAGIC)) != _MAGIC:
        raise ValueError(f"{path}: not a scene cache file")
    try:
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        meta = dict(header["meta"])
        entries = [(e["name"], _torch_dtype(e["dtype"]), tuple(int(s) for s in e["shape"]),
                    int(e["offset"])) for e in header["arrays"]]
    except (struct.error, KeyError, TypeError, AttributeError) as exc:
        raise ValueError(f"{path}: corrupt scene cache header ({exc!r})") from exc
    if meta.pop("__format__", None) != _FORMAT_VERSION:
        raise ValueError(f"{path}: stale scene-cache format (want {_FORMAT_VERSION}); rebuild")
    if (sorted(meta) != sorted(META_FIELDS)
            or sorted(e[0] for e in entries) != sorted(ARRAY_FIELDS)):
        raise ValueError(f"{path}: its fields are not SceneData's")
    return meta, entries


def _slices(entries, dests, slice_bytes):
    """(name, file offset, byte offset in the tensor, bytes) of every slice
    of at most `slice_bytes`, in file order."""
    for name, _, _, offset in entries:
        nbytes = dests[name].numel()
        for start in range(0, nbytes, slice_bytes):
            yield name, offset + start, start, min(slice_bytes, nbytes - start)


def _read_exact(f, path, name, offset, out: np.ndarray):
    f.seek(offset)
    if f.readinto(memoryview(out)) != out.nbytes:
        raise ValueError(f"{path}: truncated ({name})")


def load_scene(path: str | os.PathLike, device=None,
               slice_bytes: int = SLICE_BYTES) -> SceneData:
    """Reload a scene saved by `save_scene` onto `device` (default: the CUDA
    card). Raises ValueError on a file that is not one of the port's cache
    files, of another format version, or truncated. On the card, slices of
    at most `slice_bytes` go through two pinned buffers (see the module
    docstring)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        meta, entries = _read_header(f, path)
        tensors = {name: torch.empty(shape, dtype=dtype, device=device)
                   for name, dtype, shape, _ in entries}
        dests = {name: _bytes(t) for name, t in tensors.items()}
        slices = list(_slices(entries, dests, slice_bytes))
        if device.type == "cuda":
            with torch.cuda.device(device):
                _read_pinned(f, path, slices, dests, device)
        else:
            for name, offset, start, n in slices:
                _read_exact(f, path, name, offset, dests[name][start:start + n].numpy())
    return SceneData(**tensors, **meta)


def _read_pinned(f, path, slices, dests, device):
    """Read `slices` on a reader thread into two pinned buffers in turns;
    copy each into its device tensor on the current stream. A buffer goes
    back to the reader only after its copy's event has completed."""
    size = max((n for *_, n in slices), default=1)
    buffers = [torch.empty(size, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
    free: queue.Queue = queue.Queue()
    full: queue.Queue = queue.Queue()
    for i in range(len(buffers)):
        free.put(i)

    def reader():
        try:
            for name, offset, start, n in slices:
                i = free.get()
                if i is None:  # the consumer stopped
                    return
                _read_exact(f, path, name, offset, buffers[i][:n].numpy())
                full.put((i, name, start, n))
            full.put(None)
        except Exception as exc:  # the thread's boundary: raised on the consumer's side
            full.put(exc)

    stream = torch.cuda.current_stream(device)
    in_flight: list = []  # (event, buffer) of the copies not known done
    thread = threading.Thread(target=reader, daemon=True)
    thread.start()
    try:
        while (item := full.get()) is not None:
            if isinstance(item, Exception):
                raise item
            i, name, start, n = item
            dests[name][start:start + n].copy_(buffers[i][:n], non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
            in_flight.append((event, i))
            # Hand back every buffer but the newest once its copy is done:
            # the reader fills one while the other copies.
            while len(in_flight) > 1:
                done, j = in_flight.pop(0)
                done.synchronize()
                free.put(j)
        for event, _ in in_flight:
            event.synchronize()
    finally:
        free.put(None)
        thread.join()


def build_cache_key(*parts, env_knobs: bool = True) -> str:
    """Hash printable parts (mesh path and mtime, triangle counts, accel
    options...) and, by default, every PTX_KRN_* variable that can change
    the tables (not RESIDENCY_KNOBS) into a hex key; the port's prefix
    keeps its keys apart from the JAX package's for the same parts."""
    h = hashlib.sha256()
    h.update(f"{KEY_PREFIX} v{_FORMAT_VERSION}".encode())
    for p in parts:
        h.update(repr(p).encode())
        h.update(b"\x00")
    if env_knobs:
        for k in sorted(os.environ):
            if k.startswith("PTX_KRN_") and k not in RESIDENCY_KNOBS:
                h.update(f"{k}={os.environ[k]}".encode())
    return h.hexdigest()[:24]


def cached_build(
    key: str,
    build_fn: Callable[..., SceneData],
    cache_dir: str | os.PathLike,
    device=None,
) -> tuple[SceneData, bool]:
    """(scene on `device` (default: the CUDA card), cache hit). A hit loads
    `cache_dir/<key>.ptxt`. On a miss, `build_fn(device="cpu")` builds on
    the host, the scene is saved from host memory and then moved to
    `device` once. A corrupt or stale file is a miss and is overwritten.
    The seconds of the last call's steps are in `cached_build.seconds`."""
    device = resolve_device(device)
    path = Path(cache_dir) / f"{key}{SUFFIX}"
    t0 = time.perf_counter()
    if path.exists():
        try:
            scene = load_scene(path, device)
            cached_build.seconds = dict(load=time.perf_counter() - t0)
            return scene, True
        except (ValueError, OSError):  # corrupt or stale: rebuild
            pass
    t0 = time.perf_counter()
    scene = build_fn(device="cpu")
    t1 = time.perf_counter()
    save_scene(scene, path)
    t2 = time.perf_counter()
    scene = scene.to(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cached_build.seconds = dict(build=t1 - t0, save=t2 - t1, move=time.perf_counter() - t2)
    return scene, False


cached_build.seconds = {}
