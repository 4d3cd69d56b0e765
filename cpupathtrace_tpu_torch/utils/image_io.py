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

The reader follows that package's Pillow reader (Pillow's PNG plugin and
row decoder, without Pillow): the chunks it reads and checks, the rows it
decodes, the values it returns, and the class of what it raises on bad
input; tests/test_torch_fuzz.py holds both to mutated files.
"""
from __future__ import annotations

import re
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


class UnidentifiedImageError(OSError):
    """The bytes are not a PNG image that opens (Pillow's class of this
    name, which the JAX package's reader raises, is an OSError too)."""


class DecompressionBombError(Exception):
    """More than 2 * MAX_IMAGE_PIXELS pixels (Pillow's limit and class)."""


MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3
_MAXBLOCK = 65536
_IS_CID = re.compile(rb"\w\w\w\w").match
# (bit depth, colour type) -> (Pillow's mode, raw bits a pixel, raw layout).
_MODES = {
    (1, 0): ("1", 1, "1"), (2, 0): ("L", 2, "L;2"), (4, 0): ("L", 4, "L;4"),
    (8, 0): ("L", 8, "L"), (16, 0): ("I;16", 16, "I;16B"),
    (8, 2): ("RGB", 24, "RGB"), (16, 2): ("RGB", 48, "RGB;16B"),
    (1, 3): ("P", 1, "P;1"), (2, 3): ("P", 2, "P;2"), (4, 3): ("P", 4, "P;4"),
    (8, 3): ("P", 8, "P"),
    (8, 4): ("LA", 16, "LA"), (16, 4): ("RGBA", 32, "LA;16B"),
    (8, 6): ("RGBA", 32, "RGBA"), (16, 6): ("RGBA", 64, "RGBA;16B"),
}
# Adam7: first row and column, row and column steps of each pass.
_START_ROW = (0, 0, 4, 0, 2, 0, 1)
_START_COL = (0, 4, 0, 2, 0, 1, 0)
_ROW_STEP = (8, 8, 8, 4, 4, 2, 2)
_COL_STEP = (8, 8, 4, 4, 2, 2, 1)


class _Stream:
    """A byte string read like a file."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _u32(b: bytes, at: int = 0) -> int:
    return struct.unpack_from(">I", b, at)[0]  # struct.error when short


def _chunk_header(f: _Stream):
    """(type, data position, length) of the next chunk: struct.error when
    its length is cut, SyntaxError when its type is not four word bytes."""
    s = f.read(8)
    cid, pos, length = s[4:], f.pos, _u32(s)
    if not _IS_CID(cid):
        raise SyntaxError(f"broken PNG file (chunk {cid!r})")
    return cid, pos, length


def _safe_read(f: _Stream, size: int) -> bytes:
    if size <= 0:
        return b""
    data = f.read(size)
    if len(data) < size:
        raise OSError("Truncated File Read")
    return data


def _read_chunk(f: _Stream, cid: bytes, length: int, hdr: dict) -> bytes:
    """A chunk's data read, and IHDR, PLTE and tRNS applied to `hdr`."""
    body = _safe_read(f, length)
    if cid == b"IHDR":
        if length < 13:
            raise ValueError("Truncated IHDR chunk")
        hdr["size"] = (_u32(body), _u32(body, 4))
        if (body[8], body[9]) in _MODES:
            hdr["mode"], hdr["bits"], hdr["raw"] = _MODES[(body[8], body[9])]
        if body[12]:
            hdr["interlace"] = True
        if body[11]:
            raise SyntaxError("unknown filter category")
    elif cid == b"PLTE":
        if hdr["mode"] == "P":
            hdr["palette"] = body
    elif cid == b"tRNS":
        mode = hdr["mode"]
        if mode == "P":
            if re.match(b"^\xff*\x00\xff*$", body):
                if body.find(b"\0") >= 0:
                    hdr["transparency"] = body.find(b"\0")
            else:
                hdr["transparency"] = body
        elif mode == "1":
            hdr["transparency"] = 255 if struct.unpack_from(">H", body)[0] else 0
        elif mode in ("L", "I;16"):
            hdr["transparency"] = struct.unpack_from(">H", body)[0]
        elif mode == "RGB":
            hdr["transparency"] = struct.unpack_from(">HHH", body)
    return body


def _open(f: _Stream) -> dict:
    """The header chunks up to the first IDAT, checked as Pillow's
    Image.open checks them: the image's mode, size, interlace, palette,
    transparency and first IDAT (position, length)."""
    if f.read(8) != _SIGNATURE:
        raise UnidentifiedImageError("cannot identify image file: not a PNG signature")
    hdr = dict(mode=None, bits=0, raw=None, size=(0, 0), interlace=False, palette=None,
               transparency=None, idat=None)
    try:
        while True:
            cid, pos, length = _chunk_header(f)
            if cid == b"IDAT":
                hdr["idat"] = (pos, length)
                break
            if cid == b"IEND":
                break
            body = _read_chunk(f, cid, length, hdr)
            crc = f.read(4)
            if len(crc) < 4 or zlib.crc32(body, zlib.crc32(cid)) != _u32(crc):
                raise SyntaxError(f"broken PNG file (bad checksum in {cid!r})")
        w, h = hdr["size"]
        if not hdr["mode"] or w <= 0 or h <= 0:
            raise SyntaxError("not identified by this driver")
    except (SyntaxError, IndexError, TypeError, KeyError, EOFError, struct.error) as e:
        raise UnidentifiedImageError(f"cannot identify image file: {e}") from e
    if max(1, w) * max(1, h) > 2 * MAX_IMAGE_PIXELS:
        raise DecompressionBombError(f"image size ({w * h} pixels) exceeds the limit")
    return hdr


def _unpack(raw: np.ndarray, n: int, bits: int, layout: str) -> np.ndarray:
    """The first `n` pixels of a raw row as the mode's stored values."""
    if bits < 8:
        v = np.unpackbits(raw)[:n * bits].reshape(n, bits)
        v = (v * (1 << np.arange(bits - 1, -1, -1))).sum(1).astype(np.uint8)
        if layout == "1":
            return np.where(v > 0, 255, 0).astype(np.uint8)
        return v * np.uint8(255 // ((1 << bits) - 1)) if layout.startswith("L") else v
    px = raw[:n * bits // 8].reshape(n, bits // 8)
    if layout == "I;16B":
        return (px[:, 0].astype(np.uint16) << 8) | px[:, 1]
    if layout == "LA;16B":
        return px[:, [0, 0, 0, 2]]
    if layout.endswith(";16B"):
        return px[:, ::2]
    return px[:, 0] if px.shape[1] == 1 else px


class _ZipRows:
    """Pillow's PNG row decoder (ZipDecode): inflates one filtered row at a
    time and is done when the last row is stored or the stream ends at a
    row's end, so a stream cut after its last row (its checksum missing)
    still reads."""

    def __init__(self, hdr):
        (self.w, self.h), self.bits, self.layout = hdr["size"], hdr["bits"], hdr["raw"]
        self.interlace = hdr["interlace"]
        self.bpp = (self.bits + 7) // 8
        self.z = zlib.decompressobj()
        self.need_dict = False
        self.row = bytearray()
        self.pass_ = 0
        self.y = 0
        self.row_len = self._row_len()
        self.prev = np.zeros(self.row_len, np.int32)
        self.rows = {}  # y -> [(columns, values)]

    def _columns(self) -> np.ndarray:
        """The image columns of the current row's pixels."""
        if not self.interlace:
            return np.arange(self.w)
        step, first = _COL_STEP[self.pass_], _START_COL[self.pass_]
        return np.arange(first, self.w, step)

    def _row_len(self) -> int:
        return (len(self._columns()) * self.bits + 7) // 8

    def _store(self, cur: np.ndarray) -> None:
        cols = self._columns()
        px = _unpack(cur.astype(np.uint8), len(cols), self.bits, self.layout)
        self.rows.setdefault(self.y, []).append((cols, px))

    def feed(self, data: bytes) -> bool:
        """Inflate `data`; True when the image is done. Raises OSError on a
        broken stream or an unknown filter."""
        while data and not self.need_dict:
            want = self.row_len + 1 - len(self.row)
            try:
                self.row += self.z.decompress(data, want)
            except zlib.error as e:
                if str(e).startswith("Error 2 "):
                    # Z_NEED_DICT (a preset dictionary is asked for) is no
                    # error to Pillow: the stream just never gives a row.
                    self.need_dict = True
                    break
                raise OSError("broken data stream when reading image file") from e
            data = self.z.unconsumed_tail
            if len(self.row) < self.row_len + 1:
                break
            ftype = self.row[0]
            f = np.frombuffer(bytes(self.row[1:]), np.uint8).astype(np.int32)
            self.row.clear()
            cur = _unfilter_row(ftype, f, self.prev, self.bpp)
            self._store(cur)
            self.prev = cur
            if self.interlace:
                self.y += _ROW_STEP[self.pass_]
                while self.y >= self.h or self.row_len <= 0:
                    self.pass_ += 1
                    if self.pass_ == 7:
                        self.y = self.h
                        break
                    self.y = _START_ROW[self.pass_]
                    self.row_len = self._row_len()
                    self.prev = np.zeros(self.row_len, np.int32)
            else:
                self.y += 1
            if self.y >= self.h or self.z.eof:
                return True
        return False


def _unfilter_row(ftype: int, f: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """One row's bytes from its filtered bytes `f` and the row above."""
    if ftype == 0:
        return f
    if ftype == 2:
        return (f + prior) & 0xFF
    if ftype == 1:
        # Reconstruction runs along each channel lane: a cumulative sum.
        pad = -len(f) % bpp
        lanes = np.concatenate([f, np.zeros(pad, np.int32)]).reshape(-1, bpp)
        return (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)[:len(f)]
    if ftype not in (3, 4):
        raise OSError("decoder error -3 when reading image file (unknown filter)")
    f, prior = f.tolist(), prior.tolist()
    cur = [0] * len(f)
    for x in range(len(f)):
        a = cur[x - bpp] if x >= bpp else 0
        b = prior[x]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prior[x - bpp] if x >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (f[x] + pred) & 0xFF
    return np.array(cur, np.int32)


def _load(f: _Stream, hdr: dict) -> _ZipRows:
    """The image data, read as Pillow's PNG load reads it: IDAT chunks in
    turn (their checksums unread), 64 KB at a time, until the decoder is
    done; then the chunks after it (_load_end). A codec error is raised
    after _load_end, as Pillow raises it."""
    if hdr["idat"] is None:
        raise OSError("cannot load this image")
    if hdr["mode"] == "P" and hdr["palette"] is not None and len(hdr["palette"]) // 3 > 256:
        raise ValueError("invalid palette size")
    pos, left = hdr["idat"]
    f.pos = pos
    dec = _ZipRows(hdr)
    error = None
    while True:
        while left == 0:
            f.read(4)
            try:
                cid, _, length = _chunk_header(f)
            except struct.error as e:
                raise OSError("image file is truncated") from e
            if cid not in (b"IDAT", b"DDAT", b"fdAT"):
                raise OSError("image file is truncated (the image data ended)")
            if cid == b"fdAT":
                _safe_read(f, 4)
                length -= 4
            left = length
        n = min(_MAXBLOCK, left)
        left -= n
        s = f.read(n)
        if not s:
            raise OSError("image file is truncated")
        try:
            if dec.feed(s):
                break
        except OSError as e:
            error = e
            break
    _load_end(f, left, hdr)
    if error is not None:
        raise error
    return dec


def _load_end(f: _Stream, left: int, hdr: dict) -> None:
    """The chunks after the image data, as Pillow's load_end reads them:
    until IEND or a chunk header that does not parse; their data must be
    there, their checksums are not checked."""
    f.read(left)
    while True:
        f.read(4)
        try:
            cid, _, length = _chunk_header(f)
        except (struct.error, SyntaxError):
            return
        if cid == b"IEND":
            return
        if cid in (b"IDAT", b"fdAT"):
            _safe_read(f, length - 4 if cid == b"fdAT" else length)
        else:
            _read_chunk(f, cid, length, hdr)


def _rgba(hdr: dict, dec: _ZipRows) -> np.ndarray:
    """The decoded pixels as [H, W, 4] uint8 RGBA, converted as the JAX
    package's reader converts Pillow's modes (16-bit grey to its high byte,
    grey / palette / 1-bit through convert("RGBA") with tRNS, RGB opaque)."""
    (w, h), mode, trns = hdr["size"], hdr["mode"], hdr["transparency"]
    shape = {"RGB": (3,), "RGBA": (4,), "LA": (4,)}.get(mode, ())
    dtype = np.uint16 if mode == "I;16" else np.uint8
    px = np.zeros((h, w) + shape, dtype)
    for y, pieces in dec.rows.items():
        for cols, vals in pieces:
            if mode == "LA":
                vals = vals[:, [0, 0, 0, 1]]
            px[y, cols] = vals
    if mode in ("RGB", "RGBA", "LA"):
        if mode == "RGB":
            return np.concatenate([px, np.full((h, w, 1), 255, np.uint8)], -1)
        return px
    if mode == "I;16":
        px, trns = (px >> 8).astype(np.uint8), None
    if mode == "P":
        lut = np.zeros((256, 4), np.uint8)
        lut[:, 3] = 255
        if hdr["palette"] is not None:
            pal = np.frombuffer(hdr["palette"][:len(hdr["palette"]) // 3 * 3], np.uint8)
            lut[:len(pal) // 3, :3] = pal.reshape(-1, 3)[:256]
        if isinstance(trns, bytes):
            a = np.frombuffer(trns, np.uint8)[:256]
            lut[:len(a), 3] = a
        elif trns is not None:
            lut[trns, 3] = 0
        return lut[px]
    rgba = np.repeat(px[..., None], 4, -1)
    rgba[..., 3] = 255
    if trns is not None:
        rgba[..., 3] = np.where(px == trns, 0, 255)
    return rgba


def read_rgb_image(path) -> np.ndarray:
    """Read a PNG into an [H, W, 4] float32 array in [0, 1], as the JAX
    package's Pillow reader does: every colour type and bit depth, Adam7
    interlace, tRNS; 16-bit channels keep their high byte, alpha 1 when
    absent. Bad input raises what Pillow raises, by class:
    UnidentifiedImageError (an OSError) when the signature or a header
    chunk is broken, OSError when a header chunk or the image data is cut
    or the data stream is broken, ValueError for an IHDR under 13 bytes,
    SyntaxError for a broken chunk header inside the image data,
    DecompressionBombError past 2 * MAX_IMAGE_PIXELS pixels."""
    if hasattr(path, "read"):
        data = path.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    f = _Stream(bytes(data))
    hdr = _open(f)
    dec = _load(f, hdr)
    return _rgba(hdr, dec).astype(np.float32) / 255.0
