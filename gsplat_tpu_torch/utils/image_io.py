"""PNG reading and writing with the standard library (``zlib``, ``struct``).

The JAX package reads a scene's images and writes its renders with ``cv2``;
the port reads and writes the same PNG files without it, so a scene loads
where ``cv2`` is not installed.  Supported: 8-bit RGB and RGBA, no
interlace (the alpha channel is dropped on reading).  Writing uses filter
type 0 on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}      # PNG color type → channels (RGB, RGBA)


def _chunks(data: bytes, path):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _paeth_row(line, prior, bpp: int) -> np.ndarray:
    """Undo the Paeth filter of one scanline, byte by byte."""
    line, prior = line.tobytes(), prior.tobytes()
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(line, prior, bpp: int) -> np.ndarray:
    line, prior = line.tobytes(), prior.tobytes()
    out = bytearray(len(line))
    for i, x in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (x + ((a + prior[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit RGB or RGBA PNG → (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit RGB/RGBA PNGs without interlace are "
            f"supported (bit depth {depth}, color type {ctype}, interlace "
            f"{interlace})")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = raw.reshape(height, stride + 1)
    img = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(width, bpp).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(stride)
        elif ftype == 2:      # Up
            cur = line + prior
        elif ftype == 3:
            cur = _average_row(line, prior, bpp)
        elif ftype == 4:
            cur = _paeth_row(line, prior, bpp)
        else:
            raise ValueError(f"{path}: bad PNG filter type {ftype}")
        img[y] = cur
        prior = img[y]
    return np.ascontiguousarray(img.reshape(height, width, bpp)[..., :3])


def write_png(path, img: np.ndarray):
    """(H, W, 3) or (H, W, 4) uint8 → an 8-bit RGB or RGBA PNG."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"write_png needs (H, W, 3|4) uint8, got "
                         f"{img.shape} {img.dtype}")
    height, width, ch = img.shape
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           img.reshape(height, width * ch)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2 if ch == 3 else 6,
                       0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))
