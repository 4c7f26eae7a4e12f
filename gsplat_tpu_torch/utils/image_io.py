"""Image reading and writing without ``cv2``.

The JAX package reads a scene's images and writes its renders and image
pyramids with ``cv2``; the port reads and writes the same files without it,
so a scene loads where ``cv2`` is not installed.  Every reader returns what
``cv2.imread(path, IMREAD_COLOR)`` then ``COLOR_BGR2RGB`` gives, bit for bit
(the behaviour of cv2 5.0.0 as built with libjpeg-turbo 3.1.2, libpng,
libtiff 4.7.1, OpenCV's own BMP and PNM decoders), and every writer the
bytes of ``cv2.imwrite``'s defaults.  ``read_image`` picks the reader by the
file's signature, as cv2's ``findDecoder`` does.

PNG (the standard library's ``zlib`` and ``struct``): gray (1-16 bits),
gray with alpha, palette, RGB and RGBA at 8 or 16 bits, interlaced (Adam7)
or not, the alpha channel dropped and 16-bit samples cut to their high
byte, as cv2 (libpng's ``png_set_strip_16``) cuts them.  ``write_png``
writes 8-bit RGB or RGBA with filter type 0 on every row.

JPEG (the port's own codec, ``csrc/jpeg_codec.cpp``): baseline, extended,
progressive and arithmetic-coded frames, lossless ones, CMYK and YCCK, and
files cut short (decoded as libjpeg decodes them, with a warning).

TIFF (``csrc/tiff_codec.cpp`` for LZW and PackBits, ``zlib`` for Deflate,
the JPEG codec for JPEG strips; the directory is parsed here), BMP and PNM
(numpy).
"""

from __future__ import annotations

import os
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


# Adam7 passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_samples(img: np.ndarray, height: int, width: int, ch: int,
                 depth: int) -> np.ndarray:
    """Unfiltered scanlines (height, stride) → (height, width, ch) uint8
    samples: 16-bit ones cut to their high byte, 1-4 bit ones unpacked."""
    if depth == 16:           # big-endian samples: keep the high byte
        return img[:, 0::2].reshape(height, width, ch)
    if depth == 8:
        return img.reshape(height, width, ch)
    bits = np.unpackbits(img, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(axis=2, dtype=np.uint8)[:, :width, None]


def read_png(path) -> np.ndarray:
    """A PNG → (H, W, 3) uint8 RGB, what ``cv2.imread(path)[..., ::-1]``
    gives: gray replicated, palette looked up, alpha dropped, 16-bit samples
    cut to their high byte, gray below 8 bits scaled to 0-255; interlaced
    (Adam7) or not."""
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
    if interlace > 1:
        raise ValueError(f"{path}: bad PNG interlace method {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    ch = _COLOR_TYPES[ctype][0]
    bpp = max(1, ch * depth // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if not interlace:
        stride = (width * ch * depth + 7) // 8
        px = _png_samples(_unfilter(raw, height, stride, bpp, path), height,
                          width, ch, depth)
    else:
        px = np.zeros((height, width, ch), np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:        # an empty pass has no scanlines
                continue
            stride = (pw * ch * depth + 7) // 8
            n = ph * (stride + 1)
            rows = _unfilter(raw[pos:pos + n], ph, stride, bpp, path)
            px[y0::dy, x0::dx] = _png_samples(rows, ph, pw, ch, depth)
            pos += n
        if pos != raw.size:
            raise ValueError(f"{path}: truncated PNG image data")
    if depth < 8 and ctype == 0:
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
    lib.jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_longlong,
                                ctypes.c_int, u8p, ctypes.c_longlong,
                                ctypes.c_char_p, ctypes.c_int]
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


def _decode_jpeg_bytes(data: bytes, path, transform: int = -1):
    """JPEG bytes → ((H, W, 3) uint8 RGB in the stored orientation, EXIF
    orientation, warning or None).  ``transform``: -1 the color space the
    markers give (libjpeg's default), 0 the components as they are, 1
    YCbCr (what libtiff asks libjpeg for in a TIFF)."""
    import ctypes

    lib = _load_jpeg_codec()
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 4)()
    if lib.jpeg_info(data, len(data), info, err, _ERRLEN) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    width, height, _, orientation = info
    img = np.empty((height, width, 3), np.uint8)
    rc = lib.jpeg_decode(data, len(data), transform,
                         img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         img.size, err, _ERRLEN)
    if rc < 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return img, orientation, (err.value.decode() if rc == 1 else None)


def read_jpeg(path) -> np.ndarray:
    """A JPEG file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (libjpeg-turbo's default
    decompression, EXIF orientation applied; a CMYK or YCCK file through
    OpenCV's CMYK → BGR).  A file whose data ends early decodes as libjpeg
    decodes it, with a ``RuntimeWarning`` that names the file.  Raises
    ``ValueError`` naming the file for what cv2 does not read either
    (hierarchical frames, 12-bit samples, 2 components, lossless
    grayscale), for what the codec does not decode yet (arithmetic-coded or
    subsampled lossless) and for malformed data."""
    import warnings

    with open(path, "rb") as f:
        data = f.read()
    img, orientation, warning = _decode_jpeg_bytes(data, path)
    if warning:
        warnings.warn(f"{path}: {warning}", RuntimeWarning, stacklevel=2)
    return _apply_orientation(img, orientation)


def write_jpeg(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes ``cv2.imwrite(path, img[..., ::-1])``
    writes with its defaults: baseline JFIF, 4:2:0, quality 95 with the
    standard tables."""
    import ctypes

    img = _rgb_u8(img, "write_jpeg")
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


# -------------------------------------------------------------------- BMP


def _le(data: bytes, pos: int, fmt: str, path):
    size = struct.calcsize(fmt)
    if pos + size > len(data):
        raise ValueError(f"{path}: truncated BMP file")
    return struct.unpack_from(fmt, data, pos)


def _bmp_rle(data: bytes, pos: int, width: int, height: int, bits: int,
             palette: np.ndarray, path) -> np.ndarray:
    """RLE8 / RLE4 pixel data → (height, width, 3) palette colors in file
    row order, as OpenCV's ``BmpDecoder::readData`` fills them: a skipped
    pixel (end of line, delta, end of bitmap) takes palette entry 0, and
    a run that would cross its row's end makes the file unreadable."""
    out = np.zeros((height, width, 3), np.uint8)
    x = y = 0
    line_end_flag = 0
    n = len(data)

    def byte():
        nonlocal pos
        if pos >= n:
            raise ValueError(f"{path}: truncated BMP RLE data")
        pos += 1
        return data[pos - 1]

    def fill(count, color):          # OpenCV's FillUniColor
        nonlocal x, y
        while True:
            end = min(x + count, width)
            count -= end - x
            out[y, x:end] = color
            x = end
            if x >= width:
                x = 0
                y += 1
                if y >= height:
                    break
            if count <= 0:
                break

    def bad():
        return ValueError(f"{path}: corrupt BMP RLE{bits} data (a run "
                          f"crosses the end of a row)")

    while True:
        length, code = byte(), byte()
        if length:                                   # encoded run
            if x + length > width:
                raise bad()
            if bits == 8:
                prev_y = y
                fill(length, palette[code])
                line_end_flag = y - prev_y
                if y >= height:
                    break
            else:
                idx = np.resize([code >> 4, code & 15], length)
                out[y, x:x + length] = palette[idx]
                x += length
        elif code > 2:                               # absolute run
            if x + code > width:
                raise bad()
            if bits == 8:
                raw = data[pos:pos + code]
                pos += (code + 1) & ~1
                idx = np.frombuffer(raw, np.uint8)
            else:
                nbytes = (((code + 1) >> 1) + 1) & ~1
                raw = np.frombuffer(data[pos:pos + nbytes], np.uint8)
                pos += nbytes
                idx = np.stack([raw >> 4, raw & 15], 1).reshape(-1)[:code]
            if pos > n:
                raise ValueError(f"{path}: truncated BMP RLE data")
            out[y, x:x + code] = palette[idx]
            x += code
            line_end_flag = 0
        elif bits == 4:                              # EOL, EOB, delta
            shift = width - x
            if code == 2:
                shift = byte()
                byte()
            fill(shift, palette[0])
            if y >= height:
                break
        else:
            shift, y_shift = width - x, height - y
            if code or not line_end_flag or shift < width:
                if code == 2:
                    shift, y_shift = byte(), byte()
                if code != 0:
                    shift += y_shift * width
                if y >= height:
                    break
                fill(shift, palette[0])
                if y >= height:
                    break
            line_end_flag = 0
            if y >= height:
                break
    return out


def read_bmp(path) -> np.ndarray:
    """A BMP → (H, W, 3) uint8 RGB, what ``cv2.imread(path)[..., ::-1]``
    gives (OpenCV's own ``BmpDecoder``): 1, 4 and 8 bits through the
    palette, RLE4 and RLE8, 16 bits as 555 (or 565 under BI_BITFIELDS) with
    the low bits zero, 24 bits, 32 bits with the fourth byte dropped;
    bottom-up or top-down."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"BM"):
        raise ValueError(f"{path}: not a BMP file")
    offset, hsize = _le(data, 10, "<iI", path)
    if hsize >= 36:
        width, height, _, bits, comp = _le(data, 18, "<iiHHI", path)
        clrused = _le(data, 46, "<i", path)[0]
        pos = 14 + hsize
        entry = 4
    elif hsize == 12:
        width, height, _, bits = _le(data, 18, "<hhHH", path)
        comp, clrused, pos, entry = 0, 0, 26, 3
    else:
        raise ValueError(f"{path}: unsupported BMP header size {hsize}")
    kinds = {(1, 0), (4, 0), (8, 0), (16, 0), (24, 0), (32, 0), (16, 3),
             (32, 3), (4, 2), (8, 1)}
    if width <= 0 or height == 0 or (bits, comp) not in kinds or \
            (hsize == 12 and bits not in (1, 4, 8, 24, 32)):
        raise ValueError(f"{path}: unsupported BMP ({bits} bits, "
                         f"compression {comp}): cv2 does not read it either")
    palette = np.zeros((256, 3), np.uint8)
    if bits <= 8:
        if not 0 <= clrused <= 256:
            raise ValueError(f"{path}: bad BMP palette size {clrused}")
        count = clrused or (1 << bits)
        raw = data[pos:pos + count * entry]
        if len(raw) < count * entry:
            raise ValueError(f"{path}: truncated BMP palette")
        palette[:count] = np.frombuffer(raw, np.uint8).reshape(
            count, entry)[:, 2::-1]
    elif bits == 16 and comp == 3:
        red, green, blue = _le(data, pos, "<III", path)
        if (red, green, blue) == (0x7C00, 0x3E0, 0x1F):
            bits = 15
        elif (red, green, blue) != (0xF800, 0x7E0, 0x1F):
            raise ValueError(f"{path}: BMP bit fields {red:#x} {green:#x} "
                             f"{blue:#x} are neither 555 nor 565: cv2 does "
                             f"not read them either")
    elif bits == 16:
        bits = 15
    top_down = height < 0
    height = abs(height)
    if comp in (1, 2):
        img = _bmp_rle(data, offset, width, height, 8 if comp == 1 else 4,
                       palette, path)
    else:
        pitch = ((width * (16 if bits == 15 else bits) + 7) // 8 + 3) & ~3
        raw = data[offset:offset + pitch * height]
        if len(raw) < pitch * height:
            raise ValueError(f"{path}: truncated BMP pixel data")
        rows = np.frombuffer(raw, np.uint8).reshape(height, pitch)
        if bits <= 8:
            idx = np.unpackbits(rows, axis=1).reshape(height, -1, bits)
            idx = (idx * (1 << np.arange(bits - 1, -1, -1))).sum(2)
            img = palette[idx[:, :width]]
        elif bits in (15, 16):
            v = rows[:, :2 * width].view("<u2").astype(np.uint32)
            if bits == 15:
                b, g, r = v << 3, v >> 2, v >> 7
            else:
                b, g, r = v << 3, v >> 3, v >> 8
            img = np.stack([r & 0xF8, g & (0xF8 if bits == 15 else 0xFC),
                            b & 0xF8], 2).astype(np.uint8)
        else:
            n = bits // 8
            img = rows[:, :width * n].reshape(height, width, n)[..., 2::-1]
    if not top_down:
        img = img[::-1]
    return np.ascontiguousarray(img)


def write_bmp(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.bmp, bgr)``:
    a 24-bit BI_RGB bottom-up bitmap with a 40-byte header."""
    img = _rgb_u8(img, "write_bmp")
    height, width = img.shape[:2]
    step = (width * 3 + 3) & ~3
    rows = np.zeros((height, step), np.uint8)
    rows[:, :width * 3] = img[::-1, :, ::-1].reshape(height, -1)
    header = b"BM" + struct.pack("<IIIIiiHHIIIIII", 54 + step * height, 0,
                                 54, 40, width, height, 1, 24, 0, 0, 0, 0,
                                 0, 0)
    with open(path, "wb") as f:
        f.write(header + rows.tobytes())


def _rgb_u8(img, who: str) -> np.ndarray:
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"{who} needs (H, W, 3) uint8, got {img.shape} "
                         f"{img.dtype}")
    return img


# -------------------------------------------------------------------- PNM


def read_pnm(path) -> np.ndarray:
    """A PBM, PGM or PPM (P1-P6) → (H, W, 3) uint8 RGB, what
    ``cv2.imread(path)[..., ::-1]`` gives (OpenCV's ``PxMDecoder``): a
    binary file's samples as they are below maxval 256 and their high byte
    above, a text file's scaled by 255 / maxval below 256 (values clamped to
    maxval) and cut to their high byte above; bit 1 of a bitmap black."""
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)

    def byte():
        nonlocal pos
        if pos >= n:
            raise ValueError(f"{path}: truncated PNM file")
        pos += 1
        return data[pos - 1]

    def number(maxdigits=0):         # OpenCV's ReadNumber
        c = byte()
        while not 48 <= c <= 57:
            if c == 35:              # '#': a comment to the end of the line
                while c not in (10, 13):
                    c = byte()
                c = byte()
            elif c in b" \t\n\v\f\r":
                while c in b" \t\n\v\f\r":
                    c = byte()
            else:
                raise ValueError(f"{path}: unexpected byte {c:#x} in a PNM "
                                 f"header or text sample")
        val = digits = 0
        while True:
            val = val * 10 + c - 48
            digits += 1
            if maxdigits and digits >= maxdigits:
                break
            c = byte()
            if not 48 <= c <= 57:
                break
        return val

    if n < 2 or data[0] != ord("P") or data[1] not in b"123456":
        raise ValueError(f"{path}: not a PNM file")
    kind = data[1] - 48
    pos = 2
    width, height = number(), number()
    maxval = number() if kind not in (1, 4) else 1
    if width <= 0 or height <= 0 or not 0 < maxval < 65536:
        raise ValueError(f"{path}: bad PNM header")
    ch = 3 if kind in (3, 6) else 1
    count = width * height * ch
    if kind == 1:
        bits = np.array([number(1) != 0 for _ in range(count)], np.uint8)
        px = (1 - bits) * np.uint8(255)
    elif kind == 4:
        pitch = (width + 7) // 8
        raw = data[pos:pos + pitch * height]
        if len(raw) < pitch * height:
            raise ValueError(f"{path}: truncated PNM file")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(
            height, pitch), axis=1)[:, :width]
        px = (1 - bits) * np.uint8(255)
    elif kind in (2, 3):
        vals = np.minimum([number() for _ in range(count)], maxval)
        if maxval > 255:
            px = (vals >> 8).astype(np.uint8)
        else:
            px = (vals * 255 // maxval).astype(np.uint8)
    else:
        size = 2 if maxval > 255 else 1
        raw = data[pos:pos + count * size]
        if len(raw) < count * size:
            raise ValueError(f"{path}: truncated PNM file")
        px = np.frombuffer(raw, np.uint8)[::size]   # big-endian: high byte
    px = px.reshape(height, width, ch)
    if ch == 1:
        px = np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px)


def write_pnm(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite`` for a ``.ppm`` or
    ``.pnm`` name: a binary P6 file.  cv2 writes no color ``.pgm`` or
    ``.pbm`` (it needs one channel there), so those names raise."""
    img = _rgb_u8(img, "write_pnm")
    ext = os.path.splitext(str(path))[1].lower()
    if ext in (".pgm", ".pbm"):
        raise ValueError(f"{path}: cv2 writes no color image as {ext} (it "
                         f"needs one channel), and neither does the port")
    height, width = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{width} {height}\n255\n".encode() + img.tobytes())


# ------------------------------------------------------------------- TIFF

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*")
# TIFF field type -> (struct code, bytes)
_TIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
               5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
               9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}
# none, LZW, JPEG, Deflate, PackBits, Deflate (Adobe's code)
_TIFF_COMPRESSIONS = (1, 5, 7, 8, 32773, 32946)


def _load_tiff_codec():
    """The port's TIFF strip codecs (``csrc/tiff_codec.cpp``), built at
    first use; raises when they cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("tiff_codec")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for fn in (lib.tiff_lzw_decode, lib.tiff_packbits_decode,
               lib.tiff_lzw_encode):
        fn.restype = ctypes.c_longlong
        fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong, u8p,
                       ctypes.c_longlong]
    return lib


def _tiff_directory(data: bytes, path):
    """The first IFD: (byte order, {tag: values}); UNDEFINED and ASCII
    fields as bytes, the others as tuples."""
    e = "<" if data[:2] == b"II" else ">"
    try:
        (ifd,) = struct.unpack_from(e + "I", data, 4)
        (n,) = struct.unpack_from(e + "H", data, ifd)
        tags = {}
        for i in range(n):
            entry = ifd + 2 + 12 * i
            tag, typ, count = struct.unpack_from(e + "HHI", data, entry)
            if typ not in _TIFF_TYPES:
                continue
            code, size = _TIFF_TYPES[typ]
            pos = entry + 8
            if size * count > 4:
                (pos,) = struct.unpack_from(e + "I", data, pos)
            if pos + size * count > len(data):
                raise ValueError(f"{path}: TIFF tag {tag} points past the "
                                 f"end of the file")
            if typ in (2, 7):
                tags[tag] = data[pos:pos + count]
            else:
                tags[tag] = struct.unpack_from(e + code * count, data, pos)
    except struct.error:
        raise ValueError(f"{path}: truncated TIFF directory") from None
    return e, tags


def _tiff_chunk(lib, raw: bytes, comp: int, nbytes: int, path) -> bytes:
    """One strip or tile, decompressed to (at least) its nbytes."""
    import ctypes

    if comp == 1:
        out = raw
    elif comp in (8, 32946):
        try:
            out = zlib.decompressobj().decompress(raw, nbytes)
        except zlib.error as err:
            raise ValueError(f"{path}: corrupt Deflate TIFF data ({err})") \
                from None
    else:
        buf = np.empty(nbytes, np.uint8)
        fn = lib.tiff_lzw_decode if comp == 5 else lib.tiff_packbits_decode
        got = fn(raw, len(raw), buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), nbytes)
        if got < 0:
            raise ValueError(f"{path}: corrupt (or old-style) LZW TIFF data")
        out = buf[:got].tobytes()
    if len(out) < nbytes:
        raise ValueError(f"{path}: a TIFF strip or tile holds "
                         f"{len(out)} bytes, not {nbytes}")
    return out[:nbytes]


def _tiff_jpeg_chunk(raw: bytes, tables, transform: int, path):
    """A strip or tile of a JPEG-compressed TIFF (compression 7): its JPEG
    stream after the JPEGTables' tables, decoded as libtiff asks libjpeg
    (``transform`` 1: YCbCr → RGB; 0: the components as they are)."""
    if tables is not None and len(tables) > 4 and raw[:2] == JPEG_SIGNATURE:
        raw = bytes(tables[:-2]) + raw[2:]
    return _decode_jpeg_bytes(raw, path, transform)[0]


def read_tiff(path) -> np.ndarray:
    """The first image of a TIFF → (H, W, 3) uint8 RGB, what
    ``cv2.imread(path)[..., ::-1]`` gives (OpenCV's ``TiffDecoder``, which
    reads 8-bit output through libtiff's RGBA interface): II or MM, strips
    or tiles, chunky or planar; no compression, LZW, Deflate, PackBits or
    JPEG, the horizontal predictor at 8 and 16 bits; bilevel, 8- and 16-bit
    gray (white or black is zero, 16 bits cut to the high byte), RGB at 8
    or 16 bits (16 bits rounded to 8 as libtiff rounds them, an unassociated
    alpha multiplied in, the alpha then dropped), palettes of 1-8 bits,
    8-bit CMYK; the orientation tag applied.  Raises ``ValueError`` naming
    the file and the tag for the rest (cv2 refuses some of them too: 2- and
    4-bit gray, gray with alpha, float samples)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] not in TIFF_SIGNATURES:
        raise ValueError(f"{path}: not a TIFF file")
    e, tags = _tiff_directory(data, path)

    def tag(t, default=None):
        if t in tags:
            return tags[t][0]
        if default is None:
            raise ValueError(f"{path}: TIFF without tag {t}")
        return default

    def refuse(what):
        return ValueError(f"{path}: TIFF {what} is not supported")

    width, height = tag(256), tag(257)
    spp = tag(277, 1)
    bps_all = tags.get(258, (1,) * spp)
    bps = bps_all[0]
    comp, photo = tag(259, 1), tag(262)
    planar, predictor = tag(284, 1), tag(317, 1)
    extra = tags.get(338, ())
    if any(b != bps for b in bps_all):
        raise refuse(f"tag 258 (BitsPerSample {bps_all}, mixed)")
    if tag(339, 1) not in (1, 2):
        raise refuse(f"tag 339 (SampleFormat {tag(339)}: float)")
    if comp not in _TIFF_COMPRESSIONS:
        raise refuse(f"tag 259 (Compression {comp})")
    if comp in (1, 32773):     # libtiff applies a predictor only to LZW,
        predictor = 1          # Deflate (and JPEG's own) data
    if predictor not in (1, 2) or (predictor == 2 and bps not in (8, 16)):
        raise refuse(f"tag 317 (Predictor {predictor} at {bps} bits)")
    if tag(266, 1) not in (1, 2):
        raise refuse(f"tag 266 (FillOrder {tag(266)})")
    if photo in (0, 1):
        if spp != 1:
            raise refuse(f"gray with {spp} samples a pixel (tag 277; cv2 "
                         f"does not read it either)")
        if bps not in (1, 8, 16):
            raise refuse(f"{bps}-bit gray (tag 258; cv2 does not read it "
                         f"either)")
    elif photo == 2:
        if spp < 3 or bps not in (8, 16):
            raise refuse(f"RGB with {spp} samples of {bps} bits (tags "
                         f"277, 258)")
    elif photo == 3:
        if spp != 1 or bps not in (1, 4, 8) or 320 not in tags:
            raise refuse(f"palette of {bps} bits (tags 258, 320; cv2 reads "
                         f"no 2-bit one either)")
    elif photo == 5:
        if spp < 4 or bps != 8 or tag(332, 1) != 1:
            raise refuse(f"separated (tag 262 = 5) with {spp} samples of "
                         f"{bps} bits")
    elif not (photo == 6 and comp == 7):
        raise refuse(f"tag 262 (Photometric {photo})")
    if comp == 7 and (bps != 8 or photo not in (1, 2, 6) or planar != 1):
        raise refuse(f"JPEG compression with tag 262 = {photo}, 258 = "
                     f"{bps}, 284 = {planar}")
    tiled = 322 in tags
    if tiled:
        cw, ch = tag(322), tag(323)
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(tag(278, 2 ** 32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
    if offsets is None or counts is None or cw <= 0 or ch <= 0:
        raise ValueError(f"{path}: TIFF without strip or tile offsets")
    nplanes = spp if planar == 2 else 1
    cspp = 1 if planar == 2 else spp               # samples in a chunk
    across, down = -(-width // cw), -(-height // ch)
    if len(offsets) < across * down * nplanes or len(counts) < len(offsets):
        raise ValueError(f"{path}: TIFF with too few strips or tiles")
    row_bytes = (cw * cspp * bps + 7) // 8
    wide = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)
    samples = np.zeros((height, width, spp), np.uint16 if bps == 16
                       else np.uint8)
    lib = _load_tiff_codec() if comp in (5, 32773) else None
    transform = 1 if photo == 6 else 0
    reverse = tag(266, 1) == 2 and comp != 7
    k = 0
    for plane in range(nplanes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tiled else min(ch, height - y0)
                raw = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                if reverse:
                    raw = np.unpackbits(np.frombuffer(raw, np.uint8))
                    raw = np.packbits(raw.reshape(-1, 8)[:, ::-1]).tobytes()
                if comp == 7:
                    block = _tiff_jpeg_chunk(raw, tags.get(347), transform,
                                             path)
                    if photo == 1:
                        block = block[..., :1]
                else:
                    buf = _tiff_chunk(lib, raw, comp, rows * row_bytes, path)
                    if bps >= 8:
                        block = np.frombuffer(buf, wide).reshape(
                            rows, cw, cspp)
                        if predictor == 2:
                            block = np.cumsum(block, axis=1,
                                              dtype=block.dtype)
                    else:
                        bits = np.unpackbits(np.frombuffer(buf, np.uint8)
                                             .reshape(rows, row_bytes),
                                             axis=1)[:, :cw * bps]
                        weights = 1 << np.arange(bps - 1, -1, -1)
                        block = (bits.reshape(rows, cw, bps) * weights).sum(
                            2, dtype=np.uint8)[..., None]
                h = min(rows, height - y0, block.shape[0])
                w = min(cw, width - x0, block.shape[1])
                sl = slice(plane, plane + 1) if planar == 2 else slice(None)
                samples[y0:y0 + h, x0:x0 + w, sl] = block[:h, :w]
    img = _tiff_rgb(samples, photo, bps, extra, tags.get(320), path)
    orientation = tag(274, 1)
    if orientation > 4 and width != height:
        raise ValueError(f"{path}: TIFF orientation {orientation} (tag 274) "
                         f"of a non-square image: cv2 fails on it")
    return _apply_orientation(img, orientation if 1 <= orientation <= 8
                              else 1)


def _tiff_rgb(px: np.ndarray, photo: int, bps: int, extra, colormap,
              path) -> np.ndarray:
    """Decoded samples (H, W, spp) → RGB as libtiff's TIFFRGBAImage gives
    them to OpenCV."""
    if photo in (0, 1):
        if bps == 1:
            v = px[..., 0] * np.uint8(255)
        elif bps == 16:
            v = (px[..., 0] >> 8).astype(np.uint8)
        else:
            v = px[..., 0]
        if photo == 0:
            v = 255 - v
        return np.repeat(v[..., None], 3, axis=2)
    if photo == 3:
        cmap = np.asarray(colormap, np.int64).reshape(3, -1)
        if cmap.shape[1] < (1 << bps):
            raise ValueError(f"{path}: TIFF colormap (tag 320) too short")
        if (cmap >= 256).any():                    # a 16-bit colormap
            cmap = cmap >> 8
        return np.ascontiguousarray(cmap.T.astype(np.uint8)[px[..., 0]])
    if photo == 5:                                 # putRGBcontig8bitCMYK
        k = 255 - px[..., 3:4].astype(np.int32)
        return (k * (255 - px[..., :3].astype(np.int32)) // 255).astype(
            np.uint8)
    if photo == 6:                                 # JPEG, converted there
        return px[..., :3]
    rgb = px[..., :3].astype(np.int64)
    if bps == 16:                                  # Bitdepth16To8
        rgb = (rgb + 128) // 257
    if px.shape[2] >= 4 and len(extra) >= 1 and extra[0] == 2:
        a = px[..., 3:4].astype(np.int64)
        if bps == 16:
            a = (a + 128) // 257
        rgb = (rgb * a + 127) // 255               # UaToAa
    return rgb.astype(np.uint8)


def write_tiff(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.tif, bgr)``
    with its defaults: LZW with the horizontal predictor, strips of
    8192 // (3 W) rows, the directory after the strips, as libtiff lays
    them out."""
    import ctypes

    img = _rgb_u8(img, "write_tiff")
    height, width = img.shape[:2]
    rps = max(1, min(height, 8192 // (width * 3)))
    diff = img.copy()
    diff[:, 1:] -= img[:, :-1]                       # predictor 2, mod 256
    lib = _load_tiff_codec()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    body, offsets, counts = bytearray(b"II*\x00\x00\x00\x00\x00"), [], []
    for y in range(0, height, rps):
        strip = diff[y:y + rps].tobytes()
        cap = 16 + len(strip) * 3 // 2
        out = np.empty(cap, np.uint8)
        n = lib.tiff_lzw_encode(strip, len(strip), out.ctypes.data_as(u8p),
                                cap)
        if n < 0:
            raise ValueError(f"{path}: LZW encoding overflowed")
        offsets.append(len(body))
        counts.append(n)
        body += out[:n].tobytes()
    if len(body) % 2:
        body += b"\x00"
    ifd = len(body)
    nstrips = len(offsets)

    def short_or_long(v):
        return (3, v) if v < 65536 else (4, v)

    # (tag, type, values), and libtiff's order for the values that do not
    # fit in their entry
    fields = {256: (*short_or_long(width),), 257: (*short_or_long(height),),
              258: (3, 8, 8, 8), 259: (3, 5), 262: (3, 2),
              273: (4, *offsets), 277: (3, 3),
              278: (*short_or_long(rps),), 279: (4, *counts), 284: (3, 1),
              317: (3, 2), 339: (3, 1, 1, 1)}
    extra_at = ifd + 2 + 12 * len(fields) + 4
    extra = bytearray()
    where = {}
    for t in (258, 279, 273, 339):
        typ, *vals = fields[t]
        raw = struct.pack(f"<{len(vals)}{'H' if typ == 3 else 'I'}", *vals)
        if len(raw) > 4:
            where[t] = extra_at + len(extra)
            extra += raw
            if len(extra) % 2:
                extra += b"\x00"
    entries = bytearray(struct.pack("<H", len(fields)))
    for t in sorted(fields):
        typ, *vals = fields[t]
        code = "H" if typ == 3 else "I"
        if t in where:
            entries += struct.pack("<HHII", t, typ, len(vals), where[t])
        else:
            entries += struct.pack("<HHI", t, typ, len(vals)) + struct.pack(
                f"<{len(vals)}{code}", *vals).ljust(4, b"\x00")
    entries += b"\x00\x00\x00\x00"
    body[4:8] = struct.pack("<I", ifd)
    with open(path, "wb") as f:
        f.write(bytes(body + entries + extra))


# Formats cv2 reads and the port does not yet: (signature test, name)
_UNPORTED = (
    (lambda h: h[:4] == b"RIFF" and h[8:12] == b"WEBP", "WebP"),
    (lambda h: h[:6] in (b"GIF87a", b"GIF89a"), "GIF"),
    (lambda h: h[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
     or h[:4] == b"\xff\x4f\xff\x51", "JPEG 2000"),
    (lambda h: h[4:8] == b"ftyp" and h[8:12] in (b"avif", b"avis"), "AVIF"),
    (lambda h: h[:10] == b"#?RADIANCE" or h[:6] == b"#?RGBE",
     "Radiance HDR"),
    (lambda h: h[:2] in (b"PF", b"Pf") and h[2:3].isspace(), "PFM"),
    (lambda h: h[:2] == b"P7" and h[2:3].isspace(), "PAM"),
    (lambda h: h[:4] == b"\x59\xa6\x6a\x95", "Sun raster"),
    (lambda h: h[:4] in (b"II+\x00", b"MM\x00+"), "BigTIFF"),
)


def read_image(fn: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB, what ``cv2.imread`` then
    ``COLOR_BGR2RGB`` gives the JAX package.  The format is the file's
    signature, not its extension (as for ``cv2.imread``): PNG, JPEG, TIFF
    (``II*\\0``, ``MM\\0*``), BMP (``BM``) and PNM (``P1``-``P6``) through
    the port's own readers.  A format cv2 reads that the port does not yet
    (WebP, GIF, JPEG 2000, AVIF, Radiance HDR, PFM, PAM, Sun raster,
    BigTIFF), and
    any other file, raises ``RuntimeError`` naming the file and the
    format."""
    with open(fn, "rb") as f:
        head = f.read(32)
    if head.startswith(PNG_SIGNATURE):
        return read_png(fn)
    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(fn)
    if head[:4] in TIFF_SIGNATURES:
        return read_tiff(fn)
    if head.startswith(b"BM"):
        return read_bmp(fn)
    if head[:1] == b"P" and head[1:2] in (b"1", b"2", b"3", b"4", b"5",
                                          b"6") and head[2:3].isspace():
        return read_pnm(fn)
    for test, name in _UNPORTED:
        if test(head):
            raise RuntimeError(f"{fn}: a {name} image, which the port does "
                               f"not read yet (cv2 does)")
    raise RuntimeError(f"{fn}: not an image format that cv2 or the port "
                       f"reads")
