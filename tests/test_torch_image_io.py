"""The port's PNG codec (cpupathtrace_tpu_torch/utils/image_io.py, numpy +
zlib) against the JAX package's Pillow one: the same bytes written, the
same values read."""
import io

import numpy as np
import pytest
import torch

from cpupathtrace_tpu.utils import image_io as jio
from cpupathtrace_tpu_torch.utils import image_io as tio
from tests import torch_util  # noqa: F401  (caps torch threads)


def _png_bytes(writer, image):
    buf = io.BytesIO()
    writer(buf, image)
    return buf.getvalue()


@pytest.mark.parametrize(
    "h,w,c,kind",
    [(1, 1, 4, "noise"), (48, 64, 4, "noise"), (33, 17, 3, "noise"),
     (64, 64, 4, "smooth"), (256, 256, 4, "smooth"), (200, 300, 4, "noise"),
     (16, 16, 4, "flat")],
)
def test_written_bytes_equal_jax_writer(h, w, c, kind):
    rng = np.random.default_rng(h * 1000 + w)
    if kind == "noise":
        img = rng.uniform(-0.2, 1.2, size=(h, w, c))
    elif kind == "smooth":
        yy, xx = np.mgrid[0:h, 0:w]
        img = np.stack([xx / w, yy / h, (xx + yy) / (w + h), np.ones_like(xx)], -1)[..., :c]
        img = img + rng.normal(0, 0.01, img.shape)
    else:
        img = np.full((h, w, c), 0.5)
    img = img.astype(np.float32)
    assert _png_bytes(tio.write_rgb_image, img) == _png_bytes(jio.write_rgb_image, img)


def test_write_accepts_tensor_and_reads_back(tmp_path):
    img = np.random.default_rng(1).random((20, 30, 4)).astype(np.float32)
    path = tmp_path / "a.png"
    tio.write_rgb_image(path, torch.from_numpy(img))
    back = tio.read_rgb_image(path)
    np.testing.assert_allclose(back, np.round(img * 255) / 255, atol=1e-7)
    np.testing.assert_array_equal(back, jio.read_rgb_image(path))


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "I;16"])
def test_read_matches_jax_reader(tmp_path, mode):
    from PIL import Image

    rng = np.random.default_rng(7)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (13, 21), dtype=np.uint16))
    elif mode == "P":
        im = Image.fromarray(rng.integers(0, 255, (13, 21, 3), dtype=np.uint8), "RGB")
        im = im.convert("P", palette=Image.Palette.ADAPTIVE, colors=16)
    else:
        ch = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        arr = rng.integers(0, 256, (13, 21, ch), dtype=np.uint8)
        im = Image.fromarray(arr[..., 0] if ch == 1 else arr, mode)
    path = tmp_path / f"{mode.replace(';', '')}.png"
    im.save(path, format="PNG")
    np.testing.assert_array_equal(tio.read_rgb_image(path), jio.read_rgb_image(path))


def test_read_rejects_non_png(tmp_path):
    """As the JAX package's Pillow reader: an OSError (Pillow's
    UnidentifiedImageError)."""
    path = tmp_path / "x.png"
    path.write_bytes(b"not a png at all")
    with pytest.raises(OSError, match="cannot identify image file"):
        tio.read_rgb_image(path)
    with pytest.raises(OSError, match="cannot identify image file"):
        jio.read_rgb_image(path)


def _chunk(kind, data):
    import struct
    import zlib

    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _raw_png(rng, w, h, depth, ctype, interlace):
    """A PNG of random scanlines under random filters (Adam7 passes when
    interlaced), with a PLTE and a tRNS where the colour type takes them."""
    import struct
    import zlib

    bits = depth * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    passes = ([(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
               (0, 1, 2, 2), (1, 0, 2, 1)] if interlace else [(0, 0, 1, 1)])
    raw = b""
    for r0, c0, dr, dc in passes:
        cols, rows = max(0, -(-(w - c0) // dc)), max(0, -(-(h - r0) // dr))
        for _ in range(rows if cols else 0):
            raw += bytes([int(rng.integers(0, 5))])
            raw += rng.integers(0, 256, (cols * bits + 7) // 8, dtype=np.uint8).tobytes()
    out = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if ctype == 3:
        out += _chunk(b"PLTE", rng.integers(0, 256, 3 * 5, dtype=np.uint8).tobytes())
        out += _chunk(b"tRNS", b"\x40\x00\xc0")
    elif ctype in (0, 2):
        out += _chunk(b"tRNS", rng.integers(0, 1 << min(depth, 8), 3 if ctype else 1)
                      .astype(">u2").tobytes())
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,ctype", [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2),
                                         (16, 2), (1, 3), (2, 3), (4, 3), (8, 3), (8, 4),
                                         (16, 4), (8, 6), (16, 6)])
def test_read_matches_jax_on_every_colour_type(depth, ctype, interlace):
    """Every bit depth and colour type PNG has, Adam7 or not, with tRNS
    (and a short PLTE: indices past it read black): the same values as
    the JAX package's Pillow reader."""
    rng = np.random.default_rng(depth * 10 + ctype)
    for w, h in [(1, 1), (3, 5), (9, 7), (13, 21)]:
        payload = _raw_png(rng, w, h, depth, ctype, interlace)
        got = tio.read_rgb_image(io.BytesIO(payload))
        want = jio.read_rgb_image(io.BytesIO(payload))
        assert got.shape == want.shape == (h, w, 4)
        assert got.tobytes() == want.tobytes(), (w, h)
