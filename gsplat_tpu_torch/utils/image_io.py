"""PNG and JPEG reading and writing without ``cv2``.

The JAX package reads a scene's images and writes its renders and image
pyramids with ``cv2``; the port reads and writes the same files without it,
so a scene loads where ``cv2`` is not installed.

PNG (the standard library's ``zlib`` and ``struct``): ``read_png`` reads
what ``cv2.imread(path, IMREAD_COLOR)`` reads from a non-interlaced PNG:
gray (1-16 bits), gray with alpha, palette, RGB and RGBA at 8 or 16 bits,
the alpha channel dropped and 16-bit samples cut to their high byte, as cv2
(libpng's ``png_set_strip_16``) cuts them.  Interlaced PNGs raise.
``write_png`` writes 8-bit RGB or RGBA with filter type 0 on every row.

JPEG (the port's own codec, ``csrc/jpeg_codec.cpp``, built at first use
with the system C++ compiler): ``read_jpeg`` equals cv2's decode (its
libjpeg-turbo, EXIF orientation applied) bit for bit, and ``write_jpeg``
writes the bytes of ``cv2.imwrite``'s defaults.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> (samples a pixel, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}


def _chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
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


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int, path):
    """Undo the per-row PNG filters: (height, stride) bytes."""
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    rows = raw.reshape(height, stride + 1)
    img = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum along each byte of a pixel
            pad = (-stride) % bpp
            cur = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)])
                            .reshape(-1, bpp).astype(np.int64), axis=0
                            ).astype(np.uint8).reshape(-1)[:stride]
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
    return img


def read_png(path) -> np.ndarray:
    """A PNG → (H, W, 3) uint8 RGB, what ``cv2.imread(path)[..., ::-1]``
    gives: gray replicated, palette looked up, alpha dropped, 16-bit samples
    cut to their high byte, gray below 8 bits scaled to 0-255."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, palette = None, [], None
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"{path}: bad PNG bit depth {depth} for color type "
                         f"{ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _COLOR_TYPES[ctype][0]
    stride = (width * ch * depth + 7) // 8
    img = _unfilter(np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8),
                    height, stride, max(1, ch * depth // 8), path)
    if depth == 16:           # big-endian samples: keep the high byte
        px = img[:, 0::2].reshape(height, width, ch)
    elif depth == 8:
        px = img.reshape(height, width, ch)
    else:                     # 1, 2 or 4 bits, one sample a pixel
        bits = np.unpackbits(img, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        px = (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width, None]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: PNG palette index out of range")
        return np.ascontiguousarray(palette[px[..., 0]])
    if ch <= 2:               # gray, gray + alpha
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])


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
        f.write(PNG_SIGNATURE + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + chunk(b"IEND", b""))


# ------------------------------------------------------------------- JPEG

JPEG_SIGNATURE = b"\xff\xd8"
_ERRLEN = 256


def _load_jpeg_codec():
    """The port's JPEG codec (``csrc/jpeg_codec.cpp``), built at first use;
    raises when it cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("jpeg_codec")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.jpeg_info.restype = ctypes.c_int
    lib.jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                              ctypes.c_int]
    lib.jpeg_decode.restype = ctypes.c_int
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong, u8p,
                                ctypes.c_longlong, ctypes.c_char_p,
                                ctypes.c_int]
    lib.jpeg_encode.restype = ctypes.c_longlong
    lib.jpeg_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                ctypes.c_longlong, ctypes.c_char_p,
                                ctypes.c_int]
    return lib


def _apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """EXIF orientation 1-8 applied as OpenCV's ``ApplyExifOrientation``."""
    t = img.transpose(1, 0, 2)
    return np.ascontiguousarray({
        1: img, 2: img[:, ::-1], 3: img[::-1, ::-1], 4: img[::-1],
        5: t, 6: t[:, ::-1], 7: t[::-1, ::-1], 8: t[::-1]}[orientation])


def read_jpeg(path) -> np.ndarray:
    """A JPEG file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (libjpeg-turbo's default
    decompression, EXIF orientation applied).  Raises ``ValueError`` naming
    the file for what the codec does not decode (arithmetic coding, 12-bit,
    lossless, CMYK, an incomplete progressive file) and for truncated or
    malformed data."""
    import ctypes

    with open(path, "rb") as f:
        data = f.read()
    lib = _load_jpeg_codec()
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 4)()
    if lib.jpeg_info(data, len(data), info, err, _ERRLEN) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    width, height, _, orientation = info
    img = np.empty((height, width, 3), np.uint8)
    if lib.jpeg_decode(data, len(data),
                       img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                       img.size, err, _ERRLEN) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return _apply_orientation(img, orientation)


def write_jpeg(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes ``cv2.imwrite(path, img[..., ::-1])``
    writes with its defaults: baseline JFIF, 4:2:0, quality 95 with the
    standard tables."""
    import ctypes

    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_jpeg needs (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    height, width = img.shape[:2]
    lib = _load_jpeg_codec()
    err = ctypes.create_string_buffer(_ERRLEN)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = img.size + 65536
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(img.ctypes.data_as(u8p), width, height,
                            out.ctypes.data_as(u8p), cap, err, _ERRLEN)
        if n == -1:
            raise ValueError(f"{path}: {err.value.decode()}")
        if n >= 0:
            break
        cap = -2 - n              # the exact size, when the buffer was short
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())


def read_image(fn: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB, what ``cv2.imread`` then
    ``COLOR_BGR2RGB`` gives the JAX package.  The format is the file's
    signature, not its extension (as for ``cv2.imread``): PNG and JPEG
    through the port's own readers; anything else raises ``RuntimeError``
    naming the file."""
    with open(fn, "rb") as f:
        head = f.read(8)
    if head.startswith(PNG_SIGNATURE):
        return read_png(fn)
    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(fn)
    raise RuntimeError(f"{fn}: not a PNG or JPEG image")
