"""PNG image I/O in numpy + zlib.

The conversions of the reference's libpng codecs (ref: src/image/image_io.cpp):
  * write: round + clamp to 0..255, 8-bit RGBA (ref: image_io.cpp:132-149)
  * read: 8-bit expansion (16-bit channels keep their high byte), 1-4
    channels or a palette -> float/255, alpha 1 when absent (:55-80)

The writer produces the bytes of `cpupathtrace_tpu/utils/image_io.py`'s
Pillow writer: IHDR, IDAT chunks of at most 64 KiB, IEND; per row the
filter (none, up, sub, paeth; average is off) with the least sum of
absolute byte values, first one on ties; deflate level 6, memLevel 9,
Z_FILTERED. tests/test_torch_image_io.py holds the bytes equal.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_IDAT_MAX = 65536


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def _paeth_predictor(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(raw: np.ndarray, bpp: int) -> bytes:
    """Filter every row of `raw` [h, stride] uint8; returns the filtered
    stream with each row's filter byte in front."""
    cur = raw.astype(np.int16)
    prior = np.zeros_like(cur)
    prior[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    upleft = np.zeros_like(cur)
    upleft[:, bpp:] = prior[:, :-bpp]
    # Candidates in the order they are tried: none, up, sub, paeth.
    cands = np.stack(
        [cur, cur - prior, cur - left, cur - _paeth_predictor(left, prior, upleft)]
    ).astype(np.uint8)
    cost = np.where(cands < 128, cands, 256 - cands.astype(np.int32)).sum(axis=2)
    choice = np.argmin(cost, axis=0)  # first minimum = the earlier filter
    filter_byte = np.array([0, 2, 1, 4], np.uint8)[choice]
    rows = cands[choice, np.arange(raw.shape[0])]
    return np.concatenate([filter_byte[:, None], rows], axis=1).tobytes()


def write_rgb_image(path, image) -> None:
    """Write an [H, W, 3|4] float image in [0,1] as an 8-bit RGBA PNG;
    min(max(round(v*255), 0), 255) per channel (ref: image_io.cpp:138-143).
    `image` may be a numpy array or a torch tensor."""
    if hasattr(image, "detach"):
        image = image.detach().cpu().numpy()
    image = np.asarray(image, dtype=np.float32)
    if image.shape[-1] == 3:
        image = np.concatenate([image, np.ones_like(image[..., :1])], axis=-1)
    data = np.clip(np.round(image * 255.0), 0, 255).astype(np.uint8)
    h, w = data.shape[0], data.shape[1]
    filtered = _filter_rows(data.reshape(h, w * 4), 4)
    comp = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    stream = comp.compress(filtered) + comp.flush()
    out = [_SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))]
    out += [_chunk(b"IDAT", stream[i:i + _IDAT_MAX])
            for i in range(0, len(stream), _IDAT_MAX)]
    out.append(_chunk(b"IEND", b""))
    payload = b"".join(out)
    if hasattr(path, "write"):
        path.write(payload)
    else:
        with open(path, "wb") as f:
            f.write(payload)


def _unfilter(stream: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = np.frombuffer(stream, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        f = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = f
        elif ftype == 2:
            cur = (f + prior) & 0xFF
        elif ftype == 1:
            # Reconstruction runs along each channel lane: a cumulative sum.
            cur = (np.cumsum(f.reshape(-1, bpp), axis=0) & 0xFF).reshape(-1)
        elif ftype in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prior[x:x + bpp]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    pred = _paeth_predictor(a, b, c)
                cur[x:x + bpp] = (f[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {ftype}")
        out[y] = cur
        prior = cur.astype(np.int32)
    return out


def read_rgb_image(path) -> np.ndarray:
    """Read a PNG into an [H, W, 4] float32 array in [0, 1]. Takes
    greyscale (1-16 bits), grey+alpha, RGB, RGBA (8 or 16 bits) and palette
    (1-8 bits) images, not interlaced ones."""
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    palette = trns = None
    ihdr = None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG: missing IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(ctype)
    packed = depth < 8 and ctype in (0, 3)
    if channels is None or interlace or not (packed or depth in (8, 16)) or (
        ctype == 3 and depth == 16
    ):
        raise ValueError(
            f"PNG: unsupported colour type {ctype} / depth {depth} / interlace {interlace}"
        )
    stride = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    raw = _unfilter(zlib.decompress(b"".join(idat)), h, stride, bpp)
    if packed:
        # 1/2/4-bit samples, most significant first; grey scales to 8 bits.
        bits = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(-1, dtype=np.uint8)[:, :w, None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    else:
        bps = depth // 8
        px = raw.reshape(h, w, channels * bps)[..., ::bps]  # 16-bit: high byte
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        alpha = np.full(len(palette), 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = trns[:len(palette)]
        rgba = np.concatenate([palette, alpha[:, None]], axis=1)[px[..., 0]]
    elif channels == 1:
        rgba = np.concatenate([np.repeat(px, 3, -1), np.full_like(px, 255)], -1)
    elif channels == 2:
        rgba = np.concatenate([np.repeat(px[..., :1], 3, -1), px[..., 1:]], -1)
    elif channels == 3:
        rgba = np.concatenate([px, np.full_like(px[..., :1], 255)], -1)
    else:
        rgba = px
    return rgba.astype(np.float32) / 255.0
