"""Seeded fuzz parity of the port's host parsers with the JAX package's:
mutated OBJ text (fuzz/fuzz_targets.py's `mutate_obj`) through both
packages' load_mesh on both parse routes, equal triangles and no exception;
mutated PNG bytes (its `fuzz_png_once` recipe) through both packages'
read_rgb_image, equal arrays or the same exception class."""
import importlib.util
import io
import os

import numpy as np
import pytest

import cpupathtrace_tpu.scene.mesh as jmesh
from cpupathtrace_tpu.native import get_lib
from cpupathtrace_tpu.utils import image_io as jio
import cpupathtrace_tpu_torch.scene.mesh as tmesh
from cpupathtrace_tpu_torch.utils import image_io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = 8  # 8 x 25 = 200 inputs for each target
PER_GROUP = 25


def _fuzz_targets():
    spec = importlib.util.spec_from_file_location(
        "fuzz_targets", os.path.join(ROOT, "fuzz", "fuzz_targets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(tris):
    return [tuple(np.asarray(getattr(t, f)).tobytes() for f in ("a", "b", "c", "na", "nb", "nc"))
            + (t.cull_backface, t.material) for t in tris]


@pytest.mark.parametrize("group", range(GROUPS))
def test_mutated_obj_parity(group, monkeypatch):
    assert get_lib() is not None, "the JAX package's native library did not build"
    mutate_obj = _fuzz_targets().mutate_obj
    rng = np.random.default_rng(4000 + group)
    for _ in range(PER_GROUP):
        cull = bool(rng.integers(0, 2))
        smooth = bool(rng.integers(0, 2))
        text = mutate_obj(rng).decode("utf-8", errors="replace")
        for limit in (1 << 62, 0):  # the Python parsers, then the C++ parser
            for mod in (jmesh, tmesh):
                monkeypatch.setattr(mod, "NATIVE_PARSE_MIN_BYTES", limit)
            got = tmesh.load_mesh(io.StringIO(text), None, cull, smooth)
            want = jmesh.load_mesh(io.StringIO(text), None, cull, smooth)
            assert _bits(got) == _bits(want), (limit, text[:200])


def _png_payload(rng) -> bytes:
    """fuzz_png_once's input: random bytes, a valid 4x4 RGBA PNG, or one
    with a few bytes mutated and maybe truncated."""
    choice = rng.random()
    if choice < 0.4:
        return bytes(rng.integers(0, 256, size=int(rng.integers(0, 256)), dtype=np.uint8))
    img = rng.random((4, 4, 4)).astype(np.float32)
    tmp = io.BytesIO()
    jio.write_rgb_image(tmp, img)
    payload = bytearray(tmp.getvalue())
    if choice < 0.8 and len(payload) > 8:
        for _ in range(int(rng.integers(1, 6))):
            payload[int(rng.integers(0, len(payload)))] = int(rng.integers(0, 256))
        if rng.random() < 0.5:
            payload = payload[: int(rng.integers(8, len(payload)))]
    return bytes(payload)


def _read(read, payload):
    """The image, or the class of what reading raised: its name and its
    nearest builtin class. Pillow's own classes (UnidentifiedImageError,
    an OSError; DecompressionBombError, an Exception) have namesakes in
    the port with the same base; the rest are builtins."""
    try:
        return read(io.BytesIO(payload))
    except Exception as e:  # the class is what is compared
        base = next(c for c in type(e).__mro__ if c.__module__ == "builtins")
        return type(e).__name__, base


@pytest.mark.parametrize("group", range(GROUPS // 2))
def test_mutated_png_parity(group):
    rng = np.random.default_rng(5000 + group)
    for _ in range(2 * PER_GROUP):
        payload = _png_payload(rng)
        got, want = _read(tio.read_rgb_image, payload), _read(jio.read_rgb_image, payload)
        if isinstance(want, tuple):
            assert got == want, (want, got, payload[:64])
        else:
            assert isinstance(got, np.ndarray) and got.dtype == want.dtype
            assert got.tobytes() == want.tobytes() and got.shape == want.shape
