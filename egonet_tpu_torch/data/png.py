"""PNG reading and writing with the standard library and numpy alone
(``zlib``, ``struct``), for hosts without cv2 or PIL.

:func:`decode` (a file) and :func:`decode_bytes` (bytes, as a request
carries them) read 8-bit, non-interlaced gray, RGB and RGBA images with
all five row filters and returns RGB uint8 [H, W, 3] with cv2's
``IMREAD_COLOR`` semantics: gray is replicated, alpha is dropped.
Palette, 16-bit and interlaced images raise ``ValueError``.
:func:`image_size` reads the header alone.  :func:`encode` writes an RGB
uint8 image whose rows cycle through the five row filters.

The None, Sub and Up filters are undone with numpy; Average and Paeth
depend on the pixel to the left, so they run as a Python loop over the
row's bytes — on the order of a second for a 1242x375 RGB frame whose rows
use them (PERF.md has the measured time).
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples per pixel (8-bit only)
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunks(f):
    """Yield (type, data) for every chunk after the signature, checking
    each CRC, up to IEND."""
    if f.read(8) != _SIGNATURE:
        raise ValueError("not a PNG file")
    while True:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", head)
        data = f.read(length)
        crc = f.read(4)
        if len(data) < length or len(crc) < 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + data) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"bad CRC in PNG chunk {kind!r}")
        yield kind, data
        if kind == b"IEND":
            return


def _header(data: bytes) -> dict:
    w, h, depth, color, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                               data)
    return {"width": w, "height": h, "bit_depth": depth, "color_type": color,
            "compression": comp, "filter": filt, "interlace": interlace}


def image_size(path: str):
    """(width, height) from the IHDR chunk, without decoding."""
    with open(path, "rb") as f:
        head = f.read(33)
    if (len(head) < 33 or head[:8] != _SIGNATURE
            or head[12:16] != b"IHDR"):
        raise ValueError(f"{path} is not a PNG file")
    w, h = struct.unpack(">II", head[16:24])
    return int(w), int(h)


def _undo_average(cur: list, prev: list, bpp: int) -> None:
    for i in range(bpp):
        cur[i] = (cur[i] + (prev[i] >> 1)) & 255
    for i in range(bpp, len(cur)):
        cur[i] = (cur[i] + ((cur[i - bpp] + prev[i]) >> 1)) & 255


def _undo_paeth(cur: list, prev: list, bpp: int) -> None:
    for i in range(bpp):                  # a = c = 0: the predictor is b
        cur[i] = (cur[i] + prev[i]) & 255
    for i in range(bpp, len(cur)):
        a, b, c = cur[i - bpp], prev[i], prev[i - bpp]
        pa, pb = b - c, a - c             # p - a, p - b with p = a + b - c
        pc = pa + pb                      # p - c
        pa, pb, pc = abs(pa), abs(pb), abs(pc)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        cur[i] = (cur[i] + pred) & 255


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines (one filter byte + ``stride`` bytes each) ->
    [height, stride] uint8."""
    need = height * (stride + 1)
    if len(raw) < need:
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, count=need).reshape(height,
                                                            stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:                   # Sub: running sum per channel
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:                   # Up
            out[y] = line + prev
        elif kind in (3, 4):
            cur = line.tolist()
            (_undo_average if kind == 3 else _undo_paeth)(
                cur, prev.tolist(), bpp)
            out[y] = cur
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        prev = out[y]
    return out


def decode(path: str) -> np.ndarray:
    """PNG file -> RGB uint8 [H, W, 3] (cv2 ``IMREAD_COLOR`` semantics)."""
    with open(path, "rb") as f:
        return decode_bytes(f.read(), path)


def is_png(data: bytes) -> bool:
    """Whether ``data`` starts with the PNG signature."""
    return data[:8] == _SIGNATURE


def decode_bytes(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> RGB uint8 [H, W, 3] (cv2 ``IMREAD_COLOR`` semantics);
    ``path`` names the source in errors."""
    header, idat = None, []
    for kind, body in _chunks(io.BytesIO(data)):
        if kind == b"IHDR":
            header = _header(body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    color, depth = header["color_type"], header["bit_depth"]
    if color not in _CHANNELS or depth != 8:
        raise ValueError(f"{path}: PNG color type {color} at bit depth "
                         f"{depth} is not supported (8-bit gray, RGB and "
                         "RGBA are)")
    if header["interlace"] != 0:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if header["compression"] != 0 or header["filter"] != 0:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    w, h, ch = header["width"], header["height"], _CHANNELS[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch,
                       ch).reshape(h, w, ch)
    if ch == 1:                           # gray: replicated
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body)))


def encode(img: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] -> PNG bytes, rows cycling through the None,
    Sub, Up, Average and Paeth filters (so a reader meets all five)."""
    h, w, _ = img.shape
    rows = img.reshape(h, -1).astype(np.int32)
    data, prev = bytearray(), np.zeros_like(rows[0])
    for y in range(h):
        kind, r = y % 5, rows[y]
        a = np.concatenate([np.zeros(3, np.int32), r[:-3]])
        c = np.concatenate([np.zeros(3, np.int32), prev[:-3]])
        pa, pb, pc = np.abs(prev - c), np.abs(a - c), np.abs(a + prev - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, prev, c))
        pred = (0, a, prev, (a + prev) >> 1, paeth)[kind]
        data.append(kind)
        data += ((r - pred) & 255).astype(np.uint8).tobytes()
        prev = r
    return (_SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(bytes(data), 6))
            + _chunk(b"IEND", b""))
