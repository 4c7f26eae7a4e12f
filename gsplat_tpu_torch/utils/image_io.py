"""Image reading and writing without ``cv2``.

The JAX package reads a scene's images and writes its renders and image
pyramids with ``cv2``; the port reads and writes the same files without it,
so a scene loads where ``cv2`` is not installed.  Every reader returns what
``cv2.imread(path, IMREAD_COLOR)`` then ``COLOR_BGR2RGB`` gives, bit for bit
(the behaviour of cv2 5.0.0 as built with libjpeg-turbo 3.1.2, libpng,
libtiff 4.7.1, libwebp 1.6, OpenCV's own BMP, PNM, GIF, Radiance HDR, PFM,
PAM and Sun raster decoders, OpenJPEG 2.5.3), and every writer the bytes of
``cv2.imwrite``'s defaults, except the WebP writer, held to pixels, and
the Sun raster writer's last pad byte, which cv2 copies from past its
image.  ``read_image`` picks the reader by the file's signature, as cv2's
``findDecoder`` does.

PNG (the standard library's ``zlib`` and ``struct``): gray (1-16 bits),
gray with alpha, palette, RGB and RGBA at 8 or 16 bits, interlaced (Adam7)
or not, the alpha channel dropped and 16-bit samples cut to their high
byte, as cv2 (libpng's ``png_set_strip_16``) cuts them.  ``write_png``
writes 8-bit RGB or RGBA with filter type 0 on every row.

JPEG (the port's own codec, ``csrc/jpeg_codec.cpp``): baseline, extended,
progressive and arithmetic-coded frames, lossless ones, CMYK and YCCK, and
files cut short (decoded as libjpeg decodes them, with a warning).

TIFF and BigTIFF (``csrc/tiff_codec.cpp`` for LZW and PackBits, ``zlib``
for Deflate, the JPEG codec for JPEG strips; the directory is parsed here),
BMP and PNM (numpy).

WebP (``csrc/webp_codec.cpp`` for the VP8L and VP8 bitstreams and the ALPH
chunk; the RIFF container, libwebp's demuxer rules and EXIF are parsed
here): lossless, lossy, alpha, extended and animated files; ``write_webp``
writes lossless VP8L with the port's own small encoder.

GIF and Radiance HDR (``csrc/gif_hdr_codec.cpp`` for GIF's LZW, the GIF
writer's Floyd-Steinberg dither onto its fixed 3-3-2 palette and HDR's
run-length scanlines; the blocks, headers and colours here), PFM, PAM and
Sun raster (numpy).

JPEG 2000 (``csrc/jpeg2000_codec.cpp`` for the codestream: OpenJPEG 2.5.3's
decoding, every Part-1 option; the JP2 boxes, palettes, channel
definitions and cv2's colour rules here); ``write_jpeg2000`` writes cv2's
JP2 byte for byte at any ``IMWRITE_JPEG2000_COMPRESSION_X1000``: lossless
at 1000, else OpenJPEG's rate allocation (cv2's default is 250).

AVIF (``csrc/avif_codec.cpp`` for the AV1 key frame: the specification's
intra decoding process, every tool libaom's still-image encoder uses; the
HEIF boxes as libavif parses them and libavif's and libyuv's YUV → RGB
here).  The port writes no AVIF.
"""

from __future__ import annotations

import os
import re
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

TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
# TIFF field type -> (struct code, bytes)
_TIFF_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4),
               5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
               9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8)}
# BigTIFF's own: LONG8, SLONG8, IFD8
_BIGTIFF_TYPES = {16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
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
    fields as bytes, the others as tuples.  A BigTIFF (version 43) has
    8-byte offsets and counts, 20-byte entries with values of up to 8
    bytes inline, and the LONG8, SLONG8 and IFD8 types."""
    e = "<" if data[:2] == b"II" else ">"
    try:
        big = struct.unpack_from(e + "H", data, 2)[0] == 43
        if big:
            size, zero = struct.unpack_from(e + "HH", data, 4)
            if size != 8 or zero != 0:
                raise ValueError(f"{path}: BigTIFF with {size}-byte offsets "
                                 f"(and {zero}): libtiff reads only 8")
            types = {**_TIFF_TYPES, **_BIGTIFF_TYPES}
            (ifd,) = struct.unpack_from(e + "Q", data, 8)
            (n,) = struct.unpack_from(e + "Q", data, ifd)
            first, width, head, inline = ifd + 8, 20, "HHQ", 8
        else:
            types = _TIFF_TYPES
            (ifd,) = struct.unpack_from(e + "I", data, 4)
            (n,) = struct.unpack_from(e + "H", data, ifd)
            first, width, head, inline = ifd + 2, 12, "HHI", 4
        tags = {}
        for i in range(n):
            entry = first + width * i
            tag, typ, count = struct.unpack_from(e + head, data, entry)
            if typ not in types:
                continue
            code, size = types[typ]
            pos = entry + width - inline
            if size * count > inline:
                (pos,) = struct.unpack_from(e + ("Q" if big else "I"), data,
                                            pos)
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
    """The first image of a TIFF or BigTIFF → (H, W, 3) uint8 RGB, what
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


# ------------------------------------------------------------------- WebP

WEBP_SIGNATURE = (b"RIFF", b"WEBP")          # bytes 0-3 and 8-11
_WEBP_MAX_PAYLOAD = 0xFFFFFFFF - 8 - 1       # libwebp's MAX_CHUNK_PAYLOAD
_WEBP_MAX_AREA = 1 << 32
_VP8X_ANIMATION, _VP8X_EXIF = 0x02, 0x08


def _load_webp_codec():
    """The port's WebP codec (``csrc/webp_codec.cpp``), built at first use;
    raises when it cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("webp_codec")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ll = ctypes.c_longlong
    lib.webp_decode_vp8l.restype = ctypes.c_int
    lib.webp_decode_vp8l.argtypes = [ctypes.c_char_p, ll, ctypes.c_int,
                                     ctypes.c_int, u8p, u8p, ctypes.c_char_p,
                                     ctypes.c_int]
    lib.webp_decode_vp8.restype = ctypes.c_int
    lib.webp_decode_vp8.argtypes = [ctypes.c_char_p, ll, ll, ctypes.c_char_p,
                                    ll, ctypes.c_int, ctypes.c_int, u8p, u8p,
                                    ctypes.c_char_p, ctypes.c_int]
    lib.webp_encode_vp8l.restype = ll
    lib.webp_encode_vp8l.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p, ll]
    return lib


def _uint_le(data, pos: int, size: int) -> int:
    return int.from_bytes(data[pos:pos + size], "little")


def _webp_info(payload: bytes, lossless: bool, chunk_size: int):
    """libwebp's VP8GetInfo / VP8LGetInfo on a bitstream: (width, height)
    or None where they fail."""
    if lossless:
        if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
            return None
        bits = _uint_le(payload, 1, 4)
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        return None
    bits = _uint_le(payload, 0, 3)
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or \
            bits >> 5 >= chunk_size:
        return None
    w, h = _uint_le(payload, 6, 2) & 0x3FFF, _uint_le(payload, 8, 2) & 0x3FFF
    return (w, h) if w and h else None


def _webp_bitstream(data: bytes, path):
    """WebPDecode's header walk (ParseHeadersInternal, all data present)
    over a file, or over an animation frame's chunks: → (payload offset,
    declared payload size, lossless, (width, height), ALPH payload or None).
    Raises ``RuntimeError`` naming the file where libwebp fails."""
    def bad(what):
        return RuntimeError(f"{path}: {what}")

    n, pos, riff_size, found_vp8x = len(data), 0, 0, False
    if n < 12:
        raise bad("WebP file cut short")
    if data[:4] == b"RIFF":
        if data[8:12] != b"WEBP":
            raise bad("not a WebP file")
        riff_size = _uint_le(data, 4, 4)
        if riff_size < 12 or riff_size > _WEBP_MAX_PAYLOAD:
            raise bad(f"bad RIFF size {riff_size}")
        if riff_size > n - 8:
            raise bad(f"WebP file cut short (RIFF size {riff_size}, "
                      f"{n - 8} bytes)")
        pos = 12
    canvas = None
    if n - pos < 8:
        raise bad("WebP file cut short")
    if data[pos:pos + 4] == b"VP8X":
        if _uint_le(data, pos + 4, 4) != 10:
            raise bad("bad VP8X chunk size")
        if n - pos < 18:
            raise bad("WebP file cut short")
        canvas = (1 + _uint_le(data, pos + 12, 3),
                  1 + _uint_le(data, pos + 15, 3))
        if canvas[0] * canvas[1] >= _WEBP_MAX_AREA:
            raise bad("WebP canvas too large")
        if _uint_le(data, pos + 8, 4) & _VP8X_ANIMATION:
            raise bad("animated WebP")
        pos += 18
        found_vp8x = True
    if n - pos < 4:
        raise bad("WebP file cut short")
    alpha = None
    if (riff_size and found_vp8x) or (not riff_size and not found_vp8x
                                      and data[pos:pos + 4] == b"ALPH"):
        total = 22                        # "WEBP" + the VP8X chunk
        while True:                       # ParseOptionalChunks
            if n - pos < 8:
                raise bad("WebP file cut short before its image chunk")
            size = _uint_le(data, pos + 4, 4)
            if size > _WEBP_MAX_PAYLOAD:
                raise bad("bad WebP chunk size")
            disk = (8 + size + 1) & ~1
            total += disk
            if riff_size and total > riff_size:
                raise bad(f"WebP chunk {data[pos:pos + 4]!r} runs past the "
                          f"RIFF size")
            if data[pos:pos + 4] in (b"VP8 ", b"VP8L"):
                break
            if n - pos < disk:
                raise bad("WebP file cut short before its image chunk")
            if data[pos:pos + 4] == b"ALPH":
                alpha = data[pos + 8:pos + 8 + size]
            pos += disk
    if n - pos < 8:
        raise bad("WebP file cut short")
    tag = data[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        size = _uint_le(data, pos + 4, 4)
        if riff_size >= 12 and size > riff_size - 12:
            raise bad(f"WebP {tag.decode()} chunk larger than its RIFF")
        if size > n - pos - 8:
            raise bad(f"WebP {tag.decode()} chunk cut short")
        pos += 8
        lossless = tag == b"VP8L"
    else:                                 # a bare bitstream
        size = n - pos
        lossless = size >= 5 and data[pos] == 0x2F and not data[pos + 4] >> 5
    if size > _WEBP_MAX_PAYLOAD:
        raise bad("bad WebP chunk size")
    if n - pos < (5 if lossless else 10):
        raise bad("WebP image chunk cut short")
    info = _webp_info(data[pos:pos + 10], lossless, size)
    if info is None:
        raise bad(f"bad {'VP8L' if lossless else 'VP8'} header")
    if canvas is not None and canvas != info:
        raise bad(f"WebP image {info[0]}x{info[1]} differs from its canvas "
                  f"{canvas[0]}x{canvas[1]}")
    return pos, size, lossless, info, alpha


def _webp_decode(data: bytes, path):
    """A still WebP (or an animation frame's chunks) → ((H, W, 3) uint8
    RGB, (H, W) uint8 alpha or None), as WebPDecode decodes it: the
    bitstream read to the end of ``data``, an ALPH chunk decoded (and
    required valid) beside a VP8 image, a VP8L image's own alpha."""
    import ctypes

    pos, size, lossless, (w, h), alph = _webp_bitstream(data, path)
    lib = _load_webp_codec()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    rgb = np.empty((h, w, 3), np.uint8)
    alpha = np.empty((h, w), np.uint8) if lossless or alph is not None \
        else None
    aptr = alpha.ctypes.data_as(u8p) if alpha is not None else None
    body = data[pos:]
    if lossless:
        rc = lib.webp_decode_vp8l(body, len(body), w, h,
                                  rgb.ctypes.data_as(u8p), aptr, err, _ERRLEN)
    else:
        rc = lib.webp_decode_vp8(body, len(body), size, alph,
                                 -1 if alph is None else len(alph), w, h,
                                 rgb.ctypes.data_as(u8p), aptr, err, _ERRLEN)
    if rc != 0:
        raise RuntimeError(f"{path}: {err.value.decode()}")
    return rgb, alpha


class _WebPDemux:
    """libwebp's WebPDemux over a whole file (demux.c: ReadHeader,
    ParseSingleImage, ParseVP8X with its chunks and ANMF frames, then
    IsValidSimpleFormat / IsValidExtendedFormat), as far as cv2's reading
    depends on it: ``valid``, the canvas, the frames (x, y, width, height,
    (start, end) of their ALPH-to-image bytes) and the first EXIF chunk
    stored (only under the VP8X EXIF flag)."""

    def __init__(self, data: bytes):
        self.data, self.frames, self.exif = data, [], None
        self.canvas, self.flags, self.ext = (0, 0), 0, False
        self.valid = self._parse()

    def _parse(self) -> bool:
        d = self.data
        if len(d) < 20 or d[:4] != b"RIFF" or d[8:12] != b"WEBP":
            return False
        riff = _uint_le(d, 4, 4)
        if riff < 8 or riff > _WEBP_MAX_PAYLOAD or len(d) < riff + 8:
            return False                  # (a partial file is refused)
        self.end, self.pos = riff + 8, 12
        tag = d[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            ok = self._single_image()
        elif tag == b"VP8X":
            ok = self._vp8x()
        else:
            return False
        return ok and self._valid_format()

    def _left(self) -> int:
        return self.end - self.pos

    def _store_frame(self, frame: dict, min_size: int = 0) -> bool:
        """StoreFrame: an optional ALPH and a VP8/VP8L chunk; False where
        libwebp's parse fails (or needs data the file does not hold)."""
        d = self.data
        if self._left() < 8 or self._left() < min_size:
            return False
        alpha_chunks = image_chunks = 0
        while True:
            start = self.pos
            tag, size = d[start:start + 4], _uint_le(d, start + 4, 4)
            if size > _WEBP_MAX_PAYLOAD:
                return False
            padded = size + (size & 1)
            self.pos += 8
            if padded > self._left():
                return False
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                frame["alpha"] = start
                self.pos += padded
            elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0:
                if tag == b"VP8L" and alpha_chunks:
                    return False          # VP8L carries its own alpha
                info = _webp_info(d[start + 8:start + 8 + min(padded, 10)],
                                  tag == b"VP8L", size) \
                    if 8 + padded >= 12 else None
                if info is None:
                    return False
                image_chunks = 1
                frame["size"] = info
                frame["image"] = (start, start + 8 + padded)
                self.pos += padded
            else:
                self.pos -= 8             # back up: the frame ends here
                break
            if self.pos == self.end:
                break
            if self._left() < 8:
                return False
        return True

    def _single_image(self) -> bool:
        if self.frames or self._left() < 8:
            return False
        frame = {"x": 0, "y": 0}
        if not self._store_frame(frame):
            return False
        if "image" not in frame:
            return False                  # an ALPH without its image
        if not self.ext:
            self.canvas = frame["size"]
        self.frames.append(frame)
        return True

    def _vp8x(self) -> bool:
        d = self.data
        if self._left() < 8:
            return False
        self.ext = True
        size = _uint_le(d, self.pos + 4, 4)
        if size > _WEBP_MAX_PAYLOAD or size < 10:
            return False
        size += size & 1
        self.pos += 8
        if size > self._left():
            return False
        self.flags = d[self.pos]
        self.canvas = (1 + _uint_le(d, self.pos + 4, 3),
                       1 + _uint_le(d, self.pos + 7, 3))
        if self.canvas[0] * self.canvas[1] >= _WEBP_MAX_AREA:
            return False
        self.pos += size
        if self._left() < 8:
            return False
        animation = bool(self.flags & _VP8X_ANIMATION)
        anim_chunks = 0
        while True:
            start = self.pos
            tag, size = d[start:start + 4], _uint_le(d, start + 4, 4)
            if size > _WEBP_MAX_PAYLOAD:
                return False
            padded = size + (size & 1)
            if padded > self._left() - 8:
                return False
            if tag == b"VP8X":
                return False
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation or not self._single_image():
                    return False
            elif tag == b"ANIM":
                if padded < 6:
                    return False
                if anim_chunks == 0:
                    anim_chunks = 1
                self.pos += 8 + padded
            elif tag == b"ANMF":
                if anim_chunks == 0 or not self._anmf(padded):
                    return False
            else:
                if tag == b"EXIF" and self.flags & _VP8X_EXIF and \
                        self.exif is None:
                    self.exif = d[start + 8:start + 8 + size]
                self.pos += 8 + padded
            if self.pos == self.end:
                return True
            if self._left() < 8:
                return False

    def _anmf(self, padded: int) -> bool:
        d = self.data
        self.pos += 8
        if padded < 16 or self._left() < 16:
            return False
        p = self.pos
        frame = {"x": 2 * _uint_le(d, p, 3), "y": 2 * _uint_le(d, p + 3, 3)}
        if (1 + _uint_le(d, p + 6, 3)) * (1 + _uint_le(d, p + 9, 3)) \
                >= _WEBP_MAX_AREA:
            return False
        self.pos += 16
        start = self.pos
        if not self._store_frame(frame, padded - 16):
            return False
        if self.pos - start > padded - 16:
            return False
        if "image" not in frame or not self.flags & _VP8X_ANIMATION:
            return False
        self.frames.append(frame)
        return True

    def _valid_format(self) -> bool:
        cw, ch = self.canvas
        if cw <= 0 or ch <= 0 or not self.frames:
            return False
        if self.ext and self.flags & ~0x3E:
            return False
        animation = self.ext and bool(self.flags & _VP8X_ANIMATION)
        for f in self.frames:
            fw, fh = f["size"]
            if not animation and len(self.frames) > 1:
                return False
            if not animation and (f["x"], f["y"], fw, fh) != (0, 0, cw, ch):
                return False
            if f["x"] + fw > cw or f["y"] + fh > ch:
                return False
        return True

    def frame_bytes(self, frame: dict) -> bytes:
        """GetFramePayload: from the ALPH chunk (if any) to the image
        chunk's end."""
        start = frame.get("alpha", frame["image"][0])
        return self.data[start:frame["image"][1]]


def _exif_orientation(t: bytes) -> int:
    """OpenCV's ExifReader on an EXIF chunk: little-endian after ``II``,
    big-endian otherwise; the TIFF mark 42; IFD0's entries in order up to
    tag 0x0112, whose value it returns (1-8; 1 otherwise, and where a read
    runs past the chunk)."""
    e = "<" if t[:2] == b"II" else ">"

    def u16(o):
        if o + 1 >= len(t):
            raise IndexError(o)
        return struct.unpack_from(e + "H", t, o)[0]

    try:
        if u16(2) != 42 or 4 + 3 >= len(t):
            return 1
        ifd = struct.unpack_from(e + "I", t, 4)[0]
        for i in range(u16(ifd)):
            entry = ifd + 2 + 12 * i
            if u16(entry) == 0x0112:
                value = u16(entry + 8)
                return value if 1 <= value <= 8 else 1
    except IndexError:
        pass
    return 1


def _decode_webp_file(path):
    """A WebP file → ((H, W, 3) uint8 RGB, (H, W) uint8 alpha or None), as
    cv2 decodes it: a still image by WebPDecode, an animation (the VP8X
    animation flag) by WebPAnimDecoder's first frame on a transparent black
    canvas; the EXIF orientation of the demuxed file's first EXIF chunk
    applied."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 32:            # OpenCV reads a 32-byte header first
        raise RuntimeError(f"{path}: WebP file of {len(data)} bytes, "
                           f"shorter than cv2's 32-byte header")
    if data[12:16] == b"VP8X":
        if _uint_le(data, 16, 4) != 10:
            raise RuntimeError(f"{path}: bad VP8X chunk size")
        cw, ch = 1 + _uint_le(data, 24, 3), 1 + _uint_le(data, 27, 3)
        if cw > 1 << 20 or ch > 1 << 20 or cw * ch > 1 << 30:
            raise RuntimeError(f"{path}: a {cw}x{ch} WebP canvas, past "
                               f"cv2's image size limits")
    demux = _WebPDemux(data)
    animated = data[12:16] == b"VP8X" and data[20] & _VP8X_ANIMATION
    if animated:
        if not demux.valid:
            raise RuntimeError(f"{path}: invalid animated WebP (its frames "
                               f"or chunks do not parse)")
        first = demux.frames[0]
        rgb1, alpha1 = _webp_decode(demux.frame_bytes(first), path)
        cw, ch = demux.canvas
        rgb = np.zeros((ch, cw, 3), np.uint8)
        alpha = np.zeros((ch, cw), np.uint8)
        fh, fw = rgb1.shape[:2]
        rgb[first["y"]:first["y"] + fh, first["x"]:first["x"] + fw] = rgb1
        alpha[first["y"]:first["y"] + fh, first["x"]:first["x"] + fw] = \
            255 if alpha1 is None else alpha1
    else:
        rgb, alpha = _webp_decode(data, path)
    orientation = _exif_orientation(demux.exif) \
        if demux.valid and demux.exif else 1
    rgb = _apply_orientation(rgb, orientation)
    if alpha is not None:
        alpha = _apply_orientation(alpha[..., None], orientation)[..., 0]
    return rgb, alpha


def read_webp(path) -> np.ndarray:
    """A WebP file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (libwebp's default decoding, the
    port's own VP8L and VP8 decoders in ``csrc/webp_codec.cpp``): lossless
    and lossy, alpha (an ALPH chunk or VP8L's own) decoded and dropped,
    extended (VP8X) files with their EXIF orientation, an animation's first
    frame on its canvas (black outside the frame).  Raises ``RuntimeError``
    naming the file where cv2 returns None (a file cut short, a chunk size
    past the RIFF, a corrupt bitstream or ALPH chunk, ...)."""
    return _decode_webp_file(path)[0]


def write_webp(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → a lossless (VP8L) WebP, what
    ``cv2.imwrite(name.webp, bgr)`` writes by default.  The bytes are the
    port's small encoder's (subtract-green, a predictor a 32x32 tile, LZ77
    against the left and upper pixels); the pixels any decoder reads back
    are the input's."""
    import ctypes

    img = _rgb_u8(img, "write_webp")
    height, width = img.shape[:2]
    if width > 16384 or height > 16384:
        raise ValueError(f"{path}: {width}x{height} is past WebP's 16384 "
                         f"pixel limit")
    lib = _load_webp_codec()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = img.size + img.size // 8 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.webp_encode_vp8l(img.ctypes.data_as(u8p), width, height,
                                 out.ctypes.data_as(u8p), cap)
        if n >= 0:
            break
        cap = -2 - n
    body = out[:n].tobytes() + b"\x00" * (n & 1)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 12 + len(body)) + b"WEBPVP8L"
                + struct.pack("<I", n) + body)


# ------------------------------------------------------------ image sizes


_MAX_SIDE, _MAX_PIXELS = 1 << 20, 1 << 30    # cv2's CV_IO_MAX_IMAGE_*


def _check_size(width: int, height: int, path, what: str):
    """cv2's validateInputImageSize: imread raises past these limits."""
    if not (0 < width <= _MAX_SIDE and 0 < height <= _MAX_SIDE
            and width * height <= _MAX_PIXELS):
        raise ValueError(f"{path}: a {width}x{height} {what}, outside cv2's "
                         f"image size limits")


def _round_saturate(x: np.ndarray) -> np.ndarray:
    """cv2's float → uint8 conversion: round half to even, clamp to 0-255;
    NaN and values whose rounding leaves int32 give 0 (the x86 conversion's
    INT_MIN, then clamped)."""
    x = np.asarray(x, np.float64)
    r = np.rint(x)
    bad = ~np.isfinite(r) | (r >= 2.0 ** 31) | (r < -(2.0 ** 31))
    return np.where(bad, 0, np.clip(r, 0, 255)).astype(np.uint8)


# -------------------------------------------------------------------- GIF

GIF_SIGNATURES = (b"GIF87a", b"GIF89a")
# cv2's GIF writer: the fixed 3-3-2 table, index R << 5 | G << 2 | B
_GIF_LEVELS = ((np.arange(8) * 36).astype(np.uint8),
               (np.arange(8) * 36).astype(np.uint8),
               (np.arange(4) * 85).astype(np.uint8))
GIF_PALETTE = np.stack([_GIF_LEVELS[0][np.arange(256) >> 5],
                        _GIF_LEVELS[1][(np.arange(256) >> 2) & 7],
                        _GIF_LEVELS[2][np.arange(256) & 3]], 1)
_GIF_STATUS = {0: "its LZW data end before the frame is full, hold a code "
                  "past the table, or go on past the full frame",
               -1: "the file ends inside the frame's data",
               -2: "an LZW string runs past the frame",
               -3: "an LZW minimum code size outside 2-11"}


def _load_gif_hdr_codec():
    """The port's GIF and Radiance HDR codecs (``csrc/gif_hdr_codec.cpp``),
    built at first use; raises when they cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("gif_hdr_codec")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ll = ctypes.c_longlong
    lib.gif_lzw_decode.restype = ctypes.c_int
    lib.gif_lzw_decode.argtypes = [ctypes.c_char_p, ll, ll, ctypes.c_int,
                                   ctypes.c_int, u8p]
    lib.gif_dither_332.restype = None
    lib.gif_dither_332.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    for fn in (lib.gif_lzw_encode, lib.hdr_write_pixels):
        fn.restype = ll
    lib.gif_lzw_encode.argtypes = [u8p, ll, u8p, ll]
    lib.hdr_write_pixels.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p,
                                     ll]
    lib.hdr_read_pixels.restype = ctypes.c_int
    lib.hdr_read_pixels.argtypes = [ctypes.c_char_p, ll, ll, ctypes.c_int,
                                    ctypes.c_int, u8p]
    return lib


class _Stream:
    """cv2's RLByteStream over a file's bytes: a read past the end raises
    (cv2's imread then gives None); a skip past it raises at the next
    read."""

    def __init__(self, data: bytes, path, pos: int = 0):
        self.data, self.path, self.pos = data, path, pos

    def byte(self) -> int:
        if self.pos >= len(self.data):
            raise RuntimeError(f"{self.path}: the file ends early (at byte "
                               f"{self.pos})")
        self.pos += 1
        return self.data[self.pos - 1]

    def word(self) -> int:                    # little-endian
        lo = self.byte()
        return lo | self.byte() << 8

    def skip(self, n: int):
        self.pos += n

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise RuntimeError(f"{self.path}: the file ends early (at byte "
                               f"{len(self.data)})")
        self.pos += n
        return self.data[self.pos - n:self.pos]


def _gif_walk(st: _Stream):
    """GifDecoder::getFrameCount_: every block up to the trailer (0x3B) must
    parse, or cv2's readHeader fails; the NETSCAPE2.0 application block as
    cv2 parses it (a 3-byte sub-block of another application consumes only
    2 bytes, its third read as the next length)."""
    def sub_blocks():
        n = st.byte()
        while n:
            st.skip(n)
            n = st.byte()

    b = st.byte()
    while b != 0x3B:
        if b == 0x2C:
            st.skip(8)
            flags = st.byte()
            if flags & 0x80:
                st.skip(3 << ((flags & 7) + 1))
            st.skip(1)
            sub_blocks()
        elif b == 0x21:
            label = st.byte()
            if label == 0xFF:
                netscape = False
                n = st.byte()
                while n:
                    if n == 11:
                        netscape = st.take(11) == b"NETSCAPE2.0"
                    elif n == 3:
                        if netscape and st.byte() == 1:
                            st.word()
                        else:
                            st.skip(2)
                    else:
                        st.skip(n)
                    n = st.byte()
            elif label == 0xF9:
                n = st.byte()
                while n:
                    if n == 4:
                        st.skip(4)
                    else:
                        st.skip(n)
                    n = st.byte()
            else:
                sub_blocks()
        else:
            raise RuntimeError(f"{st.path}: GIF block {b:#04x} at byte "
                               f"{st.pos - 1}: neither an extension, an "
                               f"image nor the trailer")
        b = st.byte()


def read_gif(path) -> np.ndarray:
    """A GIF87a or GIF89a file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (cv2 5.0.0's own GifDecoder): the
    first frame on the logical screen, the screen the global table's
    background colour (black without a global table), the frame's pixels
    from its local table, else the global one, else gray levels with index
    1 white; a transparent index leaves the screen's colour; interlaced
    frames; the LZW data as cv2 decodes it (``csrc/gif_hdr_codec.cpp``).
    Raises ``RuntimeError`` naming the file where cv2 returns None (a file
    cut short or with a block it cannot parse, a frame outside the screen,
    an index past every table, LZW data that do not fill the frame, ...)."""
    import ctypes

    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in GIF_SIGNATURES:
        raise RuntimeError(f"{path}: not a GIF87a or GIF89a file")
    st = _Stream(data, path, 6)
    width, height = st.word(), st.word()
    if width <= 0 or height <= 0:
        raise RuntimeError(f"{path}: a GIF screen of {width}x{height}")
    flags, bg = st.byte(), st.byte()
    st.byte()
    gsize = 1 << ((flags & 7) + 1) if flags & 0x80 else 0
    gtable = np.frombuffer(st.take(3 * gsize), np.uint8).reshape(-1, 3)
    if gsize and bg >= gsize:
        raise RuntimeError(f"{path}: GIF background index {bg} past its "
                           f"{gsize}-colour table")
    start = st.pos
    _gif_walk(st)
    _check_size(width, height, path, "GIF")
    # readExtensions, then the first image
    st.pos = start
    transparent = None
    b = st.byte()
    while b == 0x21:
        if st.byte() == 0xF9:
            transparent = None
            if st.byte() != 4:
                raise RuntimeError(f"{path}: a graphic control extension "
                                   f"not 4 bytes long")
            gflags = st.byte()
            if gflags & 0x10:
                raise RuntimeError(f"{path}: GIF disposal method "
                                   f"{(gflags >> 2) & 7}, past cv2's 0-3")
            st.word()
            index = st.byte()
            transparent = index if gflags & 1 else None
        n = st.byte()
        while n:
            st.skip(n)
            n = st.byte()
        b = st.byte()
    if b != 0x2C:
        raise RuntimeError(f"{path}: no GIF image (block {b:#04x})")
    left, top, fw, fh = st.word(), st.word(), st.word(), st.word()
    if fw <= 0 or fh <= 0 or left + fw > width or top + fh > height:
        raise RuntimeError(f"{path}: GIF frame {fw}x{fh} at ({left}, {top}) "
                           f"outside its {width}x{height} screen")
    canvas = np.zeros((height, width, 3), np.uint8)
    if bg < gsize:
        canvas[:] = gtable[bg]
    iflags = st.byte()
    lsize = 1 << ((iflags & 7) + 1) if iflags & 0x80 else 0
    ltable = np.frombuffer(st.take(3 * lsize), np.uint8).reshape(-1, 3)
    lib = _load_gif_hdr_codec()
    idx = np.empty(fw * fh, np.uint8)
    rc = lib.gif_lzw_decode(data, len(data), st.pos, fw, fh,
                            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if rc != 1:
        raise RuntimeError(f"{path}: GIF image data that cv2 does not read: "
                           f"{_GIF_STATUS[rc]}")
    if iflags & 0x40:                          # the four interlace passes
        rows = np.concatenate([np.arange(s, fh, k) for s, k in
                               ((0, 8), (4, 8), (2, 4), (1, 2))])
        frame = np.empty((fh, fw), np.uint8)
        frame[rows] = idx.reshape(fh, fw)
    else:
        frame = idx.reshape(fh, fw)
    if lsize == 0 and gsize == 0:
        table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        table[1] = 255
        tsize = 256
    else:
        tsize = max(lsize, gsize)
        table = np.zeros((256, 3), np.uint8)
        table[:gsize] = gtable
        table[:lsize] = ltable
    shown = np.ones(frame.shape, bool) if transparent is None \
        else frame != transparent
    if (frame[shown] >= tsize).any():
        raise RuntimeError(f"{path}: a GIF index past its colour tables")
    region = canvas[top:top + fh, left:left + fw]
    region[shown] = table[frame[shown]]
    return canvas


def gif_332(img: np.ndarray) -> np.ndarray:
    """The plain numpy version of the map ``write_gif`` applies, what
    reading its file back gives: (H, W, 3) uint8 RGB → (H, W, 3) uint8 RGB
    on the 3-3-2 palette, by the same float Floyd-Steinberg error diffusion
    (``csrc/gif_hdr_codec.cpp``'s ``gif_dither_332``), computed along the
    anti-diagonals t = x + 2y, whose pixels do not depend on each other:
    pixel (y, x) sits at [t, y] of a skewed grid, where each anti-diagonal
    is one slice."""
    img = _rgb_u8(img, "gif_332")
    h, w = img.shape[:2]
    f32 = np.float32
    n = w + 2 * (h - 1)
    skew = np.zeros((n, h, 3), f32)
    for y in range(h):
        skew[2 * y:2 * y + w, y] = img[y]
    # the shares of the errors, with room for those that fall outside
    err = np.zeros((n + 3, h + 1, 3), f32)
    out = np.empty((n, h, 3), np.uint8)
    step = np.array([36, 36, 85], f32)
    top = np.array([7, 7, 3], f32)      # every value float32, as the codec
    for t in range(n):
        y0, y1 = max(0, (t - w + 2) // 2), min(h - 1, t // 2) + 1
        p = skew[t, y0:y1] + err[t, y0:y1]
        # the nearest level is one of the two around p; a tie goes up
        lo = np.clip(np.floor(p / step), 0, top - 1)
        near_lo = np.abs(p - lo * step) < np.abs(p - (lo + 1) * step)
        q = np.where(near_lo, lo, lo + 1) * step
        out[t, y0:y1] = q
        e = p - q
        # each target's shares arrive in the order cv2 adds them: from
        # the row above (down-right, down, down-left), then from the left
        err[t + 1, y0 + 1:y1 + 1] += e * f32(3) / f32(16)
        err[t + 1, y0:y1] += e * f32(7) / f32(16)
        err[t + 2, y0 + 1:y1 + 1] += e * f32(5) / f32(16)
        err[t + 3, y0 + 1:y1 + 1] += e / f32(16)
    ys = np.arange(h)[:, None]
    return out[2 * ys + np.arange(w)[None], ys]


def write_gif(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.gif, bgr)``
    with its defaults: GIF89a, the fixed 3-3-2 global table, a NETSCAPE2.0
    loop block (loop 0), a graphic control extension (disposal 3, delay
    100), the frame's pixels Floyd-Steinberg dithered onto the table
    (``gif_332``) and LZW-coded (``csrc/gif_hdr_codec.cpp``)."""
    import ctypes

    img = _rgb_u8(img, "write_gif")
    height, width = img.shape[:2]
    if width > 65535 or height > 65535:
        raise ValueError(f"{path}: {width}x{height} is past GIF's 65535 "
                         f"pixel limit")
    lib = _load_gif_hdr_codec()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    idx = np.empty((height, width), np.uint8)
    lib.gif_dither_332(img.ctypes.data_as(u8p), width, height,
                       idx.ctypes.data_as(u8p))
    cap = idx.size * 2 + 4096
    out = np.empty(cap, np.uint8)
    n = lib.gif_lzw_encode(idx.ctypes.data_as(u8p), idx.size,
                           out.ctypes.data_as(u8p), cap)
    if n < 0:
        raise ValueError(f"{path}: LZW encoding overflowed")
    head = (b"GIF89a" + struct.pack("<HHBBB", width, height, 0xF7, 0, 0)
            + GIF_PALETTE.tobytes()
            + b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
            + b"\x21\xf9\x04\x0c\x64\x00\x00\x00"
            + b"\x2c" + struct.pack("<HHHHB", 0, 0, width, height, 7)
            + b"\x08")
    with open(path, "wb") as f:
        f.write(head + out[:n].tobytes() + b"\x3b")


# ----------------------------------------------------------- Radiance HDR

HDR_SIGNATURES = (b"#?RGBE", b"#?RADIANCE")
_HDR_FORMAT = b"FORMAT=32-bit_rle_rgbe\n"
_HDR_SIZE = re.compile(rb"-Y[ \t\n\v\f\r]*([+-]?\d+)[ \t\n\v\f\r]*"
                       rb"\+X[ \t\n\v\f\r]*([+-]?\d+)")
_HDR_STATUS = {-1: "the file ends inside its pixels",
               -2: "a run-length scanline of another width",
               -3: "a bad run in a scanline"}


def read_hdr(path) -> np.ndarray:
    """A Radiance RGBE file (``#?RADIANCE`` or ``#?RGBE``) → (H, W, 3) uint8
    RGB, bit for bit what ``cv2.imread(path)[..., ::-1]`` gives (cv2's
    HdrDecoder over rgbe.c): the header read as ``fgets`` lines of up to
    127 bytes, ``FORMAT=32-bit_rle_rgbe`` required, then a blank line and
    ``-Y H +X W`` (other orientations refused); flat or new-style
    run-length scanlines (``csrc/gif_hdr_codec.cpp``); each value
    m · 2^(e - 136) times 255 rounded half to even and saturated as cv2
    converts a float (2^31 and more give 0).  Raises ``RuntimeError`` naming
    the file where cv2 returns None."""
    import ctypes

    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(HDR_SIGNATURES):
        raise RuntimeError(f"{path}: not a Radiance HDR file")
    pos = 0

    def fgets():
        nonlocal pos
        if pos >= len(data):
            raise RuntimeError(f"{path}: Radiance header cut short")
        end = data.find(b"\n", pos, pos + 127)
        end = min(pos + 127, len(data)) if end < 0 else end + 1
        line, pos = data[pos:end], end
        return line.split(b"\x00", 1)[0]      # what strcmp sees

    line = fgets()
    while line != _HDR_FORMAT:
        if line[:1] in (b"", b"\n"):
            raise RuntimeError(f"{path}: Radiance header without "
                               f"FORMAT=32-bit_rle_rgbe")
        line = fgets()
    if fgets() != b"\n":
        raise RuntimeError(f"{path}: no blank line after the Radiance FORMAT")
    m = _HDR_SIZE.match(fgets())
    if m is None:
        raise RuntimeError(f"{path}: Radiance resolution is not -Y H +X W "
                           f"(cv2 reads no other orientation)")
    height, width = int(m.group(1)), int(m.group(2))
    if width <= 0 or height <= 0:
        raise RuntimeError(f"{path}: a {width}x{height} Radiance image")
    _check_size(width, height, path, "Radiance image")
    lib = _load_gif_hdr_codec()
    rgbe = np.empty((height, width, 4), np.uint8)
    rc = lib.hdr_read_pixels(data, len(data), pos, width, height,
                             rgbe.ctypes.data_as(ctypes.POINTER(
                                 ctypes.c_uint8)))
    if rc != 0:
        raise RuntimeError(f"{path}: {_HDR_STATUS[rc]}")
    return _rgbe_to_u8(rgbe)


def _rgbe_to_u8(rgbe: np.ndarray) -> np.ndarray:
    """rgbe.c's rgbe2float (m · 2^(e - 136), 0 where e is 0), times 255 and
    converted as cv2 converts floats to bytes."""
    e = rgbe[..., 3:].astype(np.int64)
    val = rgbe[..., :3] * 255.0 * np.exp2(e - 136)
    return _round_saturate(np.where(e > 0, val, 0.0))


def hdr_round_trip(img: np.ndarray) -> np.ndarray:
    """The plain numpy version of what ``write_hdr`` then ``read_hdr`` give
    an (H, W, 3) uint8 RGB image: each pixel's RGBE encoding of v / 255,
    decoded and converted back to bytes (within 2 of the input)."""
    return _rgbe_to_u8(_float2rgbe(_rgb_u8(img, "hdr_round_trip")))


def _float2rgbe(img: np.ndarray) -> np.ndarray:
    """rgbe.c's float2rgbe on v / 255 (cv2 scales 8-bit input so): (H, W,
    3) uint8 RGB → (H, W, 4) uint8 R, G, B, E."""
    x = img.astype(np.float32) * np.float32(1 / 255.0)
    v = x.max(axis=2)
    mant, ex = np.frexp(v)
    safe = np.where(v < 1e-32, np.float32(1), v)
    scale = (mant.astype(np.float64) * 256.0 / safe).astype(np.float32)
    out = np.empty(img.shape[:2] + (4,), np.uint8)
    out[..., :3] = (x * scale[..., None]).astype(np.int32)
    out[..., 3] = ex + 128
    out[v < 1e-32] = 0
    return out


def write_hdr(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.hdr, bgr)``
    (or ``.pic``): ``#?RADIANCE``, ``FORMAT=32-bit_rle_rgbe``, ``-Y H +X
    W``, each pixel rgbe.c's encoding of v / 255, new-style run-length
    scanlines where 8 <= W <= 32767, else flat (``csrc/gif_hdr_codec.cpp``)."""
    import ctypes

    img = _rgb_u8(img, "write_hdr")
    height, width = img.shape[:2]
    rgbe = np.ascontiguousarray(_float2rgbe(img))
    lib = _load_gif_hdr_codec()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cap = rgbe.size + rgbe.size // 64 + 4 * height + 64
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.hdr_write_pixels(rgbe.ctypes.data_as(u8p), width, height,
                                 out.ctypes.data_as(u8p), cap)
        if n >= 0:
            break
        cap = -2 - n
    head = (b"#?RADIANCE\n" + _HDR_FORMAT
            + f"\n-Y {height} +X {width}\n".encode())
    with open(path, "wb") as f:
        f.write(head + out[:n].tobytes())


# -------------------------------------------------------------------- PFM

_PFM_NUMBER = re.compile(
    rb"[ \t\n\v\f\r]*[+-]?(?:0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|"
    rb"\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?|(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    rb"|[iI][nN][fF](?:[iI][nN][iI][tT][yY])?|[nN][aA][nN])")
_INT_PREFIX = re.compile(rb"[ \t\n\v\f\r]*([+-]?\d+)")


def _atof(token: bytes) -> float:
    """C's atof: the longest number at the start, else 0."""
    m = _PFM_NUMBER.match(token)
    if m is None:
        return 0.0
    text = m.group(0).strip().decode()
    if text.lower().lstrip("+-").startswith("0x"):
        return float.fromhex(text)
    return float(text)


def _atoi(token: bytes) -> int:
    """C's atoi (glibc: strtol cut to int)."""
    m = _INT_PREFIX.match(token)
    if m is None:
        return 0
    v = max(-2 ** 63, min(2 ** 63 - 1, int(m.group(1))))
    return (v + 2 ** 31) % 2 ** 32 - 2 ** 31


def read_pfm(path) -> np.ndarray:
    """A colour PFM (``PF``) → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (cv2's PFMDecoder): ``PF`` and a
    line break, then width, height and scale, each the bytes up to one
    whitespace byte read as C's atoi / atof; the scale's sign picks the byte
    order (negative: little-endian); rows bottom-up; the floats times
    1 / |scale| in float, then rounded half to even and saturated as cv2
    converts them (NaN, infinities and 2^31 and more give 0).  A gray
    ``Pf`` file raises, as cv2 returns None for it in colour."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:1] != b"P" or data[1:2] not in (b"F", b"f"):
        raise RuntimeError(f"{path}: not a PFM file")
    if data[2:3] != b"\n":
        raise RuntimeError(f"{path}: no line break after the PFM magic")
    if data[1:2] == b"f":
        raise RuntimeError(f"{path}: a gray PFM (Pf), which cv2 does not "
                           f"read in colour either")
    pos = 3

    def token() -> bytes:
        nonlocal pos
        out = bytearray()
        while len(out) < 2048:
            if pos >= len(data):
                raise RuntimeError(f"{path}: PFM header cut short")
            c = data[pos]
            pos += 1
            if c >= 128:
                raise RuntimeError(f"{path}: a byte {c:#x} in the PFM header")
            if c in b" \t\n\v\f\r":
                break
            out.append(c)
        return bytes(out)

    width, height, scale = _atoi(token()), _atoi(token()), _atof(token())
    _check_size(width, height, path, "PFM")
    if not abs(scale) > 0:
        raise RuntimeError(f"{path}: PFM scale {scale}")
    raw = data[pos:pos + width * height * 12]
    if len(raw) < width * height * 12:
        raise RuntimeError(f"{path}: PFM pixels cut short")
    px = np.frombuffer(raw, ">f4" if scale > 0 else "<f4").astype(
        np.float32).reshape(height, width, 3)[::-1]
    with np.errstate(invalid="ignore", over="ignore"):
        px = px * np.float32(1.0 / abs(scale))
    return np.ascontiguousarray(_round_saturate(px))


def write_pfm(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.pfm, bgr)``:
    ``PF``, ``W H``, ``-1`` (little-endian), the values as float32 RGB, rows
    bottom-up."""
    img = _rgb_u8(img, "write_pfm")
    height, width = img.shape[:2]
    body = img[::-1].astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(f"PF\n{width} {height}\n-1\n".encode() + body)


# -------------------------------------------------------------------- PAM

_PAM_FIELDS = ("ENDHDR", "HEIGHT", "WIDTH", "DEPTH", "MAXVAL", "TUPLTYPE")
# TUPLTYPE → (the number cv2 gives it, the depth it requires)
_PAM_TUPLES = {"": (0, None), "BLACKANDWHITE": (1, 1), "GRAYSCALE": (2, 1),
               "GRAYSCALE_ALPHA": (3, 2), "RGB": (4, 3), "RGB_ALPHA": (5, 4)}
_PAM_NUMBER = re.compile(r"-?\d*")


def _pam_number(value: str, path) -> int:
    """cv2's ParseNumber: an optional minus and digits (none read as 0), at
    most 2147483646; anything else raises."""
    if _PAM_NUMBER.fullmatch(value) is None or value == "-":
        raise RuntimeError(f"{path}: PAM header value {value!r} is not a "
                           f"number")
    v = int(value) if value.lstrip("-") else 0
    if abs(v) > 0x7FFFFFFE:
        raise RuntimeError(f"{path}: PAM header value {value} too large")
    return v


def read_pam(path) -> np.ndarray:
    """A PAM (``P7``) → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (cv2's PAMDecoder): the header's
    fields in any order, comments and blank lines, each field once, the
    values as cv2 parses them; ``TUPLTYPE`` BLACKANDWHITE, GRAYSCALE, RGB
    or none (then told from DEPTH and MAXVAL as cv2 tells it); MAXVAL up to
    65535, samples as they are (no scaling to 255), 16-bit ones cut to
    their high byte, MAXVAL 1 read as bits (a row still takes W · DEPTH
    bytes); an RGB file's bytes taken in cv2's order (B, G, R as stored).
    Raises ``RuntimeError`` naming the file where cv2 returns None, and
    ``ValueError`` for GRAYSCALE_ALPHA and RGB_ALPHA files wider than one
    pixel, where cv2 fills only the first W / DEPTH pixels of each row and
    leaves the rest unset."""
    with open(path, "rb") as f:
        data = f.read()
    st = _Stream(data, path)
    if st.byte() != ord("P") or st.byte() != ord("7") or \
            st.byte() not in (10, 13):
        raise RuntimeError(f"{path}: not a PAM file (P7 and a line break)")
    space = b" \t\n\v\f\r"
    fields, tuple_name = {}, ""

    def bad(what):
        return RuntimeError(f"{path}: PAM header: {what}")

    while True:
        c = st.byte()
        while c in space:
            c = st.byte()
        if c == ord("#"):
            while c not in (10, 13):
                c = st.byte()
            continue
        ident = bytearray()
        while c not in space and len(ident) < 8:
            ident.append(c)
            c = st.byte()
        if c not in space:
            raise bad(f"field name {bytes(ident)!r}... longer than 8 bytes")
        name = bytes(ident).split(b"\0", 1)[0].decode("latin-1")   # C
        if name not in _PAM_FIELDS:
            raise bad(f"unknown field {name!r}")
        value = bytearray()
        if c not in (10, 13):
            c = st.byte()
            while c in space:
                c = st.byte()
            while c not in (10, 13):
                if len(value) == 255:
                    raise bad("a value longer than 255 bytes")
                value.append(c)
                c = st.byte()
        value = bytes(value).rstrip(space).split(b"\0", 1)[0].decode(
            "latin-1")
        if name == "ENDHDR":
            break
        if name == "TUPLTYPE":
            if value not in _PAM_TUPLES:
                raise bad(f"TUPLTYPE {value!r}")
            tuple_name = value
            continue
        if name in fields:
            raise bad(f"{name} twice")
        fields[name] = _pam_number(value, path)
        if name == "MAXVAL" and fields[name] > 0xFFFF:
            raise bad(f"MAXVAL {fields[name]}")
    code, need = _PAM_TUPLES[tuple_name]
    depth = fields.get("DEPTH")
    if code and depth is None:
        raise bad("no DEPTH")
    if code and depth != need:
        raise bad(f"TUPLTYPE {tuple_name} with DEPTH {depth}")
    if any(k not in fields for k in ("HEIGHT", "WIDTH", "DEPTH", "MAXVAL")):
        raise bad("a field missing")
    maxval = fields["MAXVAL"]
    if not code:
        if (maxval, depth) == (1, 1):
            code = 1
        elif depth == 1 and maxval <= 255:
            code = 2
        elif depth == 3 and maxval <= 255:
            code = 4
        else:
            raise bad(f"no TUPLTYPE, and DEPTH {depth} with MAXVAL {maxval}")
    if not 1 <= depth <= 4:
        raise bad(f"DEPTH {depth}")
    width, height = fields["WIDTH"], fields["HEIGHT"]
    _check_size(width, height, path, "PAM")
    size = 2 if maxval > 255 else 1
    stride = width * depth * size
    raw = data[st.pos:st.pos + stride * height]
    if len(raw) < stride * height:
        raise RuntimeError(f"{path}: PAM samples cut short")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride)
    if maxval == 1:                            # bits, MSB first
        bits = np.unpackbits(rows, axis=1)[:, :width]
        return np.repeat((bits * np.uint8(255))[..., None], 3, axis=2)
    px = rows[:, ::size].reshape(height, width, depth)    # the high byte
    if depth == 3:
        return np.ascontiguousarray(px[..., ::-1])
    if depth == 1:
        return np.repeat(px, 3, axis=2)
    if width == 1:                 # the one pixel cv2 fills: gray or RGB
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2)
                                    if depth == 2 else px[..., :3])
    raise ValueError(f"{path}: a {tuple_name} PAM {width} pixels wide: cv2 "
                     f"fills only the first {-(-width // depth)} pixels of "
                     f"each row and leaves the rest unset, so the port "
                     f"refuses it")


def write_pam(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.pam, bgr)``:
    ``P7``, WIDTH, HEIGHT, DEPTH 3, MAXVAL 255, ENDHDR, then the samples in
    cv2's order (B, G, R)."""
    img = _rgb_u8(img, "write_pam")
    height, width = img.shape[:2]
    head = (f"P7\nWIDTH {width}\nHEIGHT {height}\nDEPTH 3\nMAXVAL 255\n"
            f"ENDHDR\n").encode()
    with open(path, "wb") as f:
        f.write(head + img[..., ::-1].tobytes())


# ------------------------------------------------------------- Sun raster

SUNRAS_SIGNATURE = b"\x59\xa6\x6a\x95"


def read_sunras(path) -> np.ndarray:
    """A Sun raster file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (cv2's SunRasterDecoder): the old
    and standard types (cv2 5.0.0 refuses the byte-encoded and RGB types:
    its header test compares the image type with them, not the encoding),
    depths 1, 8, 24 (B, G, R) and 32 (X, B, G, R); no colour map, or an
    equal-RGB one of at most 3 · 2^depth bytes (then planar R, G, B thirds,
    missing entries black); 1 bit and 8 bits without a map read as gray
    levels (bit 1 white); rows padded to 2 bytes.  Raises ``RuntimeError``
    naming the file where cv2 returns None."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != SUNRAS_SIGNATURE or len(data) < 32:
        raise RuntimeError(f"{path}: not a Sun raster file (or cut short)")
    width, height, depth, _, kind, maptype, maplen = struct.unpack(
        ">7i", data[4:32])
    palsize = 3 << depth if 0 < depth <= 8 else 0
    if not (width > 0 and height > 0 and depth in (1, 8, 24, 32)
            and kind in (0, 1)
            and ((maptype == 0 and maplen == 0)
                 or (maptype == 1 and 0 < maplen <= palsize
                     and depth <= 8))):
        raise RuntimeError(f"{path}: a Sun raster of depth {depth}, type "
                           f"{kind}, map type {maptype} ({maplen} bytes): "
                           f"cv2 does not read it")
    _check_size(width, height, path, "Sun raster")
    pos = 32
    palette = np.zeros((256, 3), np.uint8)
    if maplen:
        cmap = data[pos:pos + maplen]
        if len(cmap) < maplen:
            raise RuntimeError(f"{path}: Sun raster colour map cut short")
        n = maplen // 3
        planes = np.frombuffer(cmap[:3 * n], np.uint8).reshape(3, n)
        palette[:n] = planes.T
        pos += maplen
    elif depth <= 8:
        levels = 1 << depth
        palette[:levels] = (np.arange(levels) * 255 // (levels - 1))[:, None]
    pitch = ((width * depth + 7) // 8 + 1) & ~1
    raw = data[pos:pos + pitch * height]
    if len(raw) < pitch * height:
        raise RuntimeError(f"{path}: Sun raster pixels cut short")
    rows = np.frombuffer(raw, np.uint8).reshape(height, pitch)
    if depth == 1:
        return palette[np.unpackbits(rows, axis=1)[:, :width]]
    if depth == 8:
        return palette[rows[:, :width]]
    n = depth // 8
    px = rows[:, :width * n].reshape(height, width, n)
    return np.ascontiguousarray(px[..., :0:-1] if n == 4 else px[..., ::-1])


def write_sunras(path, img: np.ndarray):
    """(H, W, 3) uint8 RGB → the bytes of ``cv2.imwrite(name.ras, bgr)``
    (or ``.sr``): a standard 24-bit raster without a map, B, G, R samples,
    rows padded to 2 bytes.  cv2 copies each pad byte from past its row:
    the next row's first byte, and for the last row a byte past the image,
    which is not the file's to know; the port writes 0 there."""
    img = _rgb_u8(img, "write_sunras")
    height, width = img.shape[:2]
    step = (width * 3 + 1) & ~1
    flat = img[..., ::-1].reshape(-1)
    rows = np.zeros((height, step), np.uint8)
    rows[:, :width * 3] = flat.reshape(height, width * 3)
    if step > width * 3 and height > 1:
        rows[:-1, -1] = flat[width * 3::width * 3]
    head = struct.pack(">8I", 0x59A66A95, width, height, 24, step * height,
                       1, 0, 0)
    with open(path, "wb") as f:
        f.write(head + rows.tobytes())


# -------------------------------------------------------------- JPEG 2000

JP2_SIGNATURE = b"\x00\x00\x00\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"
_J2K_ERRLEN = 256
# OpenJPEG's colour spaces from the colr box's EnumCS (opj_jp2_decode)
_J2K_ENUMCS = {16: "srgb", 17: "gray", 18: "sycc", 24: "eycc", 12: "cmyk"}


def _load_jpeg2000_codec():
    """The port's JPEG 2000 codec (``csrc/jpeg2000_codec.cpp``), built at
    first use; raises when it cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("jpeg2000_codec")
    ll, vp, cp = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p
    llp = ctypes.POINTER(ll)
    lib.j2k_header.restype = ctypes.c_int
    lib.j2k_header.argtypes = [cp, ll, ctypes.c_uint, ctypes.c_uint, llp, llp,
                               ctypes.c_int, cp, ctypes.c_int]
    lib.j2k_decode.restype = vp
    lib.j2k_decode.argtypes = [cp, ll, ctypes.c_uint, ctypes.c_uint, cp,
                               ctypes.c_int]
    lib.j2k_comp_info.restype = None
    lib.j2k_comp_info.argtypes = [vp, ctypes.c_int, llp]
    lib.j2k_comp_data.restype = None
    lib.j2k_comp_data.argtypes = [vp, ctypes.c_int, vp]
    lib.j2k_free.restype = None
    lib.j2k_free.argtypes = [vp]
    lib.j2k_encode.restype = ll
    lib.j2k_encode.argtypes = [vp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               vp, ll]
    return lib


class _JP2:
    """What OpenJPEG's JP2 reader (opj_jp2_read_header_procedure and its box
    handlers) keeps of a file's boxes, and where its codestream starts."""

    def __init__(self):
        self.state = set()          # signature, ftyp, header, unknown
        self.ihdr = None            # (h, w, numcomps)
        self.has_ihdr = self.has_jp2h = self.has_colr = False
        self.enumcs = 0
        self.pclr = None            # entries (NE, NPC)
        self.cmap = None            # [(cmp, mtyp, pcol)]
        self.cdef = None            # [(cn, typ, asoc)]
        self.codestream = None

    def sub_box(self, kind: bytes, body: bytes, path):
        if kind == b"ihdr":
            if self.ihdr is not None:
                return              # "Ignoring ihdr box"
            if len(body) != 14:
                raise RuntimeError(f"{path}: a JP2 ihdr box of {len(body)} "
                                   f"bytes, not 14")
            h, w, nc = struct.unpack(">IIH", body[:10])
            if nc - 1 >= 16384 or h < 1 or w < 1 or nc < 1:
                raise RuntimeError(f"{path}: JP2 ihdr values w {w} h {h} "
                                   f"numcomps {nc}")
            self.ihdr = (h, w, nc)
            self.has_ihdr = True
        elif kind == b"colr":
            if len(body) < 3:
                raise RuntimeError(f"{path}: a JP2 colr box under 3 bytes")
            if self.has_colr:
                return              # only the first colr box counts
            meth = body[0]
            if meth == 1:
                if len(body) < 7:
                    raise RuntimeError(f"{path}: an enumerated JP2 colr box "
                                       f"under 7 bytes")
                self.enumcs = struct.unpack(">I", body[3:7])[0]
                self.has_colr = True
            elif meth == 2:
                self.has_colr = True    # an ICC profile: cv2 ignores it
        elif kind == b"bpcc":
            numcomps = self.ihdr[2] if self.ihdr else 0
            if len(body) != numcomps:
                raise RuntimeError(f"{path}: a JP2 bpcc box of {len(body)} "
                                   f"bytes for {numcomps} components")
        elif kind == b"pclr":
            if self.pclr is not None or len(body) < 3:
                raise RuntimeError(f"{path}: a second or short JP2 pclr box")
            ne, npc = struct.unpack(">HB", body[:3])
            if ne == 0 or ne > 1024 or npc == 0:
                raise RuntimeError(f"{path}: a JP2 pclr box of {ne} entries "
                                   f"and {npc} columns")
            if len(body) < 3 + npc:
                raise RuntimeError(f"{path}: a short JP2 pclr box")
            sizes = [(b & 0x7F) + 1 for b in body[3:3 + npc]]
            pos = 3 + npc
            entries = np.zeros((ne, npc), np.int64)
            for j in range(ne):
                for i in range(npc):
                    n = min((sizes[i] + 7) >> 3, 4)
                    if len(body) < pos + n:
                        raise RuntimeError(f"{path}: a short JP2 pclr box")
                    entries[j, i] = int.from_bytes(body[pos:pos + n], "big")
                    pos += n
            self.pclr = entries
        elif kind == b"cmap":
            if self.pclr is None:
                raise RuntimeError(f"{path}: a JP2 cmap box before its pclr")
            if self.cmap is not None:
                raise RuntimeError(f"{path}: a second JP2 cmap box")
            npc = self.pclr.shape[1]
            if len(body) < 4 * npc:
                raise RuntimeError(f"{path}: a short JP2 cmap box")
            self.cmap = [struct.unpack(">HBB", body[4 * i:4 * i + 4])
                         for i in range(npc)]
        elif kind == b"cdef":
            if self.cdef is not None or len(body) < 2:
                raise RuntimeError(f"{path}: a second or short JP2 cdef box")
            n = struct.unpack(">H", body[:2])[0]
            if n == 0 or len(body) < 2 + 6 * n:
                raise RuntimeError(f"{path}: a JP2 cdef box of {n} entries "
                                   f"in {len(body)} bytes")
            self.cdef = [list(struct.unpack(">HHH", body[2 + 6 * i:8 + 6 * i]))
                         for i in range(n)]

    def jp2h(self, body: bytes, path):
        if "ftyp" not in self.state:
            raise RuntimeError(f"{path}: a JP2 jp2h box before ftyp")
        has_ihdr = False
        while body:
            if len(body) < 8:
                raise RuntimeError(f"{path}: a JP2 header box of "
                                   f"{len(body)} bytes")
            length, kind = struct.unpack(">I4s", body[:8])
            head = 8
            if length == 1:
                if len(body) < 16 or body[8:12] != b"\0\0\0\0":
                    raise RuntimeError(f"{path}: a JP2 XL box OpenJPEG "
                                       f"does not read")
                length, head = struct.unpack(">I", body[12:16])[0], 16
            if length == 0 or length < head or length > len(body):
                raise RuntimeError(f"{path}: a JP2 header box of length "
                                   f"{length}")
            self.sub_box(kind, body[head:length], path)
            has_ihdr |= kind == b"ihdr"
            body = body[length:]
        if not has_ihdr:
            raise RuntimeError(f"{path}: a JP2 jp2h box without ihdr")
        self.state.add("header")
        self.has_jp2h = True

    def parse(self, data: bytes, path):
        pos = 0
        while len(data) - pos >= 8:
            length, kind = struct.unpack(">I4s", data[pos:pos + 8])
            head = 8
            if length == 0:
                length = len(data) - pos
            elif length == 1:
                if len(data) - pos < 16:
                    break
                if data[pos + 8:pos + 12] != b"\0\0\0\0":
                    raise RuntimeError(f"{path}: a JP2 box past 2^32 bytes")
                length = struct.unpack(">I", data[pos + 12:pos + 16])[0]
                head = 16
            if kind == b"jp2c":
                if "header" not in self.state:
                    raise RuntimeError(f"{path}: the JP2 codestream box "
                                       f"comes before jp2h")
                self.codestream = data[pos + head:]
                return
            if length < head:
                raise RuntimeError(f"{path}: a JP2 box of length {length}")
            size = length - head
            body = data[pos + head:pos + head + size]
            top = kind in (b"jP  ", b"ftyp", b"jp2h")
            img = kind in (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap",
                           b"cdef")
            if top or img:
                if img and "header" not in self.state:
                    if len(data) - pos - head < size:     # the skip fails
                        raise RuntimeError(f"{path}: a JP2 box runs past "
                                           f"the file")
                    self.state.add("unknown")
                    pos += length
                    continue
                if size > len(data) - pos - head:
                    raise RuntimeError(f"{path}: a JP2 box of {size} bytes "
                                       f"past the file's end")
                if kind == b"jP  ":
                    if self.state:
                        raise RuntimeError(f"{path}: a JP2 signature box not "
                                           f"first")
                    if body != b"\r\n\x87\n":
                        raise RuntimeError(f"{path}: a bad JP2 signature box")
                    self.state.add("signature")
                elif kind == b"ftyp":
                    if self.state != {"signature"}:
                        raise RuntimeError(f"{path}: the JP2 ftyp box not "
                                           f"second")
                    if size < 8 or (size - 8) % 4:
                        raise RuntimeError(f"{path}: a JP2 ftyp box of "
                                           f"{size} bytes")
                    self.state.add("ftyp")
                elif kind == b"jp2h":
                    self.jp2h(body, path)
                else:
                    self.sub_box(kind, body, path)
            else:
                if "signature" not in self.state or "ftyp" not in self.state:
                    raise RuntimeError(f"{path}: a JP2 file whose first boxes "
                                       f"are not jP and ftyp")
                self.state.add("unknown")
                if len(data) - pos - head < size:
                    raise RuntimeError(f"{path}: a JP2 box runs past the file")
            pos += length
        self.codestream = b""          # no codestream: "Expected a SOC marker"


def _jp2_check_color(jp2: _JP2, comps: list, path):
    """opj_jp2_check_color, on the decoded components."""
    pclr = jp2.pclr if jp2.cmap is not None else None
    if jp2.cdef is not None:
        nr = pclr.shape[1] if pclr is not None else len(comps)
        for cn, _, asoc in jp2.cdef:
            if cn >= nr or (asoc != 65535 and asoc > 0 and asoc - 1 >= nr):
                raise RuntimeError(f"{path}: a JP2 cdef channel past the "
                                   f"{nr} channels")
        for k in range(nr - 1, -1, -1):
            if not any(cn == k for cn, _, _ in jp2.cdef):
                raise RuntimeError(f"{path}: incomplete JP2 channel "
                                   f"definitions")
    if pclr is not None:
        npc = pclr.shape[1]
        cmap = jp2.cmap
        sane = all(c < len(comps) for c, _, _ in cmap)
        used = [False] * npc
        for i, (_, mtyp, pcol) in enumerate(cmap):
            if mtyp not in (0, 1) or pcol >= npc \
                    or (used[pcol] and mtyp == 1) \
                    or (mtyp == 0 and pcol != 0) or (mtyp == 1 and pcol != i):
                sane = False
            else:
                used[pcol] = True
        if any(not used[i] and cmap[i][1] != 0 for i in range(npc)):
            sane = False
        if sane and len(comps) == 1 and not all(used):
            jp2.cmap = [(c, 1, i) for i, (c, _, _) in enumerate(cmap)]
        if not sane:
            raise RuntimeError(f"{path}: a JP2 cmap box OpenJPEG refuses")


def _jp2_apply(jp2: _JP2, comps: list) -> list:
    """opj_jp2_apply_pclr then opj_jp2_apply_cdef's channel swaps (cv2 reads
    neither the new precisions nor the alpha flags).  A component is a
    dict: data (int32 plane), dx, dy, x0, y0, w, h."""
    if jp2.pclr is not None and jp2.cmap is not None:
        entries = jp2.pclr
        top = entries.shape[0] - 1
        new = []
        for cmp, mtyp, pcol in jp2.cmap:
            c = dict(comps[cmp])
            src = comps[cmp]["data"]
            if mtyp == 0:
                c["data"] = src.copy()
            else:
                c["data"] = entries[np.clip(src, 0, top), pcol].astype(
                    np.uint32).view(np.int32)
            new.append(c)
        comps = new
    if jp2.cdef is not None:
        info = [list(e) for e in jp2.cdef]
        for i, (cn, typ, asoc) in enumerate(info):
            acn = asoc - 1
            if cn >= len(comps) or asoc in (0, 65535) or acn >= len(comps):
                continue
            if cn != acn and typ == 0:
                comps[cn], comps[acn] = comps[acn], comps[cn]
                for e in info[i + 1:]:
                    if e[0] == cn:
                        e[0] = acn
                    elif e[0] == acn:
                        e[0] = cn
    return comps


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """cv2.cvtColor(COLOR_YUV2BGR) on uint8 planes (its 14-bit fixed point
    coefficients 2.032, -0.395, -0.581, 1.140), returned as RGB."""
    y, u, v = (p.astype(np.int64) for p in (y, u, v))
    u, v = u - 128, v - 128

    def descale(x):
        return (x + (1 << 13)) >> 14
    b = y + descale(u * 33292)
    g = y + descale(u * -6472 + v * -9519)
    r = y + descale(v * 18678)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _j2k_error(path, err, what: str) -> RuntimeError:
    """The codec's refusal: OpenJPEG's reason, or a kind the port does not
    decode yet (its message starts ``unported: ``)."""
    msg = err.value.decode(errors="replace")
    if msg.startswith("unported: "):
        return RuntimeError(f"{path}: a JPEG 2000 codestream with {msg[10:]}"
                            f", which the port does not read yet (cv2 does)")
    return RuntimeError(f"{path}: {what} cv2 does not read: {msg}")


def _decode_jpeg2000_bytes(data: bytes, path):
    """A JP2 file or a raw codestream → (H, W, 3) uint8 RGB, as cv2 5.0.0's
    Jpeg2KOpjDecoder reads it (OpenJPEG's decode, then cv2's rules)."""
    import ctypes

    jp2 = None
    if data.startswith(JP2_SIGNATURE):
        jp2 = _JP2()
        jp2.parse(data, path)
        if not jp2.has_jp2h or not jp2.has_ihdr:
            raise RuntimeError(f"{path}: a JP2 file without jp2h and ihdr")
        cs = jp2.codestream
        ihdr_h, ihdr_w = jp2.ihdr[:2]
    else:
        cs, ihdr_w, ihdr_h = data, 0, 0
    lib = _load_jpeg2000_codec()
    err = ctypes.create_string_buffer(_J2K_ERRLEN)
    info = (ctypes.c_longlong * 5)()
    head = (ctypes.c_longlong * 16)()
    if not lib.j2k_header(cs, len(cs), ihdr_w, ihdr_h, info, head, 4, err,
                          _J2K_ERRLEN):
        raise _j2k_error(path, err, "a JPEG 2000 header")
    # cv2's readHeader
    x0, y0, x1, y1, numcomps = list(info)
    if not 1 <= numcomps <= 4:
        raise RuntimeError(f"{path}: a JPEG 2000 image of {numcomps} "
                           f"components (cv2 reads 1-4)")
    precs = [head[4 * c] for c in range(numcomps)]
    if any(head[4 * c + 1] for c in range(numcomps)):
        raise RuntimeError(f"{path}: signed JPEG 2000 components, which cv2 "
                           f"does not read")
    max_prec = max(precs)
    if max_prec < 8:
        raise RuntimeError(f"{path}: JPEG 2000 samples of {max_prec} bits "
                           f"(cv2 reads 8 and more)")
    try:
        _check_size(x1 - x0, y1 - y0, path, "JPEG 2000 image")
    except ValueError as e:
        raise RuntimeError(str(e)) from None
    handle = lib.j2k_decode(cs, len(cs), ihdr_w, ihdr_h, err, _J2K_ERRLEN)
    if not handle:
        raise _j2k_error(path, err, "JPEG 2000 data")
    try:
        comps = []
        ci = (ctypes.c_longlong * 6)()
        for c in range(numcomps):
            lib.j2k_comp_info(handle, c, ci)
            cx0, cy0, w, h, dx, dy = list(ci)
            plane = np.empty(w * h, np.int32)
            lib.j2k_comp_data(handle, c, plane.ctypes.data)
            comps.append(dict(data=plane.reshape(h, w), dx=dx, dy=dy, x0=cx0,
                              y0=cy0, w=w, h=h))
    finally:
        lib.j2k_free(handle)
    space = "unknown"
    if jp2 is not None:
        _jp2_check_color(jp2, comps, path)
        space = _J2K_ENUMCS.get(jp2.enumcs, "unknown")
        comps = _jp2_apply(jp2, comps)
    # cv2's readData
    if space in ("eycc", "cmyk"):
        raise RuntimeError(f"{path}: a JPEG 2000 colour space ({space}) cv2 "
                           f"does not convert")
    for c in comps:
        if (c["dx"], c["dy"], c["x0"], c["y0"], c["w"], c["h"]) != \
                (1, 1, 0, 0, x1 - x0, y1 - y0):
            raise RuntimeError(f"{path}: JPEG 2000 components subsampled or "
                               f"offset, which cv2 does not read")
    shift = max_prec - 8

    def u8(c):
        return (c["data"] >> shift).astype(np.uint8)
    if space == "gray":
        g = u8(comps[0])
        return np.stack([g, g, g], -1)
    if len(comps) < 3:
        raise RuntimeError(f"{path}: {len(comps)} JPEG 2000 components in "
                           f"a {'sYCC' if space == 'sycc' else 'sRGB'} image "
                           f"(cv2 converts 3 or 4)")
    if space == "sycc":
        return _yuv_to_rgb(u8(comps[0]), u8(comps[1]), u8(comps[2]))
    return np.stack([u8(comps[0]), u8(comps[1]), u8(comps[2])], -1)


def read_jpeg2000(path) -> np.ndarray:
    """A JPEG 2000 file (JP2 or a raw codestream) → (H, W, 3) uint8 RGB, bit
    for bit what ``cv2.imread(path)[..., ::-1]`` gives (cv2 5.0.0 with
    OpenJPEG 2.5.3; the port's own decoder in ``csrc/jpeg2000_codec.cpp``,
    the JP2 boxes parsed here): every progression, code-block style and
    transform of Part 1, tiles and tile-parts, layers cut by a rate, ROI,
    palettes (pclr/cmap) and channel definitions (cdef); a gray image
    copied into three channels, sYCC through cv2's YUV → BGR, samples past
    8 bits cut to their top 8, alpha dropped.  Raises ``RuntimeError``
    naming the file where cv2 returns None (a file cut short, signed or
    offset or subsampled components, a raw gray codestream, 2 or more than
    4 components, fewer than 8 bits, CMYK or e-sYCC, a corrupt box or
    codestream), and for the kinds the port does not decode yet (HT
    code-blocks, Part 2 markers)."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode_jpeg2000_bytes(data, path)


def write_jpeg2000(path, img: np.ndarray, compression_x1000: int = 1000):
    """(H, W, 3) uint8 RGB → the bytes ``cv2.imwrite(name.jp2, bgr,
    [IMWRITE_JPEG2000_COMPRESSION_X1000, compression_x1000])`` writes: one
    tile, 5 levels of the 5/3 transform, 64x64 code-blocks, one layer, no
    component transform.  At 1000 the layer holds every coding pass (the
    file reads back equal to ``img``); below it, OpenJPEG 2.5.3's rate
    allocation keeps the passes that fit the image's bytes over the rate
    ``1000 / compression_x1000`` (250, rate 4, is what ``cv2.imwrite``
    writes with no parameters).  The value is clamped to 1-1000, as cv2
    clamps it.  Raises ``ValueError`` where that ``imwrite`` fails: a side
    under 32 pixels, too small for OpenJPEG's 6 resolutions."""
    import ctypes

    img = _rgb_u8(img, "write_jpeg2000")
    height, width = img.shape[:2]
    if width < 32 or height < 32:
        raise ValueError(f"{path}: a {width}x{height} image, too small for "
                         f"the 5 wavelet levels of cv2's JPEG 2000 writer")
    lib = _load_jpeg2000_codec()
    cap = img.size + img.size // 4 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.j2k_encode(img.ctypes.data, width, height,
                           int(compression_x1000), out.ctypes.data, cap)
        if n >= 0:
            break
        cap = -n
    with open(path, "wb") as f:
        f.write(out[:n].tobytes())


AVIF_BRANDS = (b"avif", b"avis")
_AVIF_ERRLEN = 256
# libyuv 1924's full-range BT.601 constants (kYuvJPEGConstants): the U and V
# weights in 1/64 and the Y gain and bias of its 6-bit fixed point
_YUV_JPEG = dict(ub=113, ug=22, vg=46, vr=90, yg=16320, yb=32)
# the versions libavif 1.4.2 reads of the full boxes it parses
_AVIF_VERSIONS = {b"hdlr": (0,), b"pitm": (0, 1), b"iinf": (0, 1),
                  b"iloc": (0, 1, 2), b"ispe": (0,), b"pixi": (0,)}
# the auxiliary types libavif takes for an alpha plane
_AVIF_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
                    b"urn:mpeg:hevc:2015:auxid:1")
# the property boxes libavif 1.4.2 parses (an unknown one marked essential
# makes it refuse the item)
_AVIF_KNOWN_PROPERTIES = (b"ispe", b"pixi", b"av1C", b"colr", b"auxC",
                          b"clap", b"irot", b"imir", b"pasp", b"lsel",
                          b"a1op", b"a1lx", b"clli", b"mdcv", b"cclv",
                          b"amve", b"reve", b"ndwt", b"tmap", b"altt",
                          b"sato")


def _load_avif_codec():
    """The port's AV1 decoder (``csrc/avif_codec.cpp``), built at first use;
    raises when it cannot be built."""
    import ctypes

    from gsplat_tpu_torch.ops.cuda_build import load_host_library

    lib = load_host_library("avif_codec")
    ll, vp, cp = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_char_p
    lib.av1_decode.restype = vp
    lib.av1_decode.argtypes = [cp, ll, ctypes.c_int, cp, ctypes.c_int]
    lib.av1_info.restype = None
    lib.av1_info.argtypes = [vp, ctypes.POINTER(ll)]
    lib.av1_plane.restype = None
    lib.av1_plane.argtypes = [vp, ctypes.c_int, vp]
    lib.av1_free.restype = None
    lib.av1_free.argtypes = [vp]
    lib.av1_grain_params.restype = None
    lib.av1_grain_params.argtypes = [vp, vp]
    lib.av1_film_grain.restype = None
    lib.av1_film_grain.argtypes = [vp] + [ctypes.c_int] * 6 + [
        vp, ctypes.c_int, vp, vp, ctypes.c_int]
    return lib


def _avif_brands(head: bytes):
    """The major and compatible brands of a leading ``ftyp`` box that lies
    whole in ``head``, or None."""
    if len(head) < 16 or head[4:8] != b"ftyp":
        return None
    size = int.from_bytes(head[:4], "big")
    if size < 16 or size > len(head):
        return None
    return head[8:12], [head[i:i + 4] for i in range(16, size - 3, 4)]


def is_avif(head: bytes) -> bool:
    """What libavif's ``avifPeekCompatibleFileType`` answers for the first
    bytes of a file (cv2's AVIF signature test): a whole ``ftyp`` box whose
    major or compatible brands hold ``avif`` or ``avis``."""
    brands = _avif_brands(head)
    if brands is None:
        return False
    major, compat = brands
    return major in AVIF_BRANDS or any(b in AVIF_BRANDS for b in compat)


class _Heif:
    """The boxes of an AVIF file (ISO/IEC 14496-12 and 23008-12) as libavif
    1.4.2 parses a still image: ``ftyp``, ``meta`` (``hdlr``, ``pitm``,
    ``iloc``, ``iinf``, ``iprp``, ``iref``, ``idat``) and ``mdat``."""

    def __init__(self, data: bytes, path):
        self.data, self.path = data, path
        self.items = {}       # id -> dict(type, extents, method, assoc)
        self.props = []       # ipco's boxes: (type, payload)
        self.primary = None
        self.idat = b""
        self.refs = []        # (type, from, [to])
        self.alpha = None     # the alpha item's id, once found

    def bad(self, why: str) -> RuntimeError:
        return RuntimeError(f"{self.path}: an AVIF file cv2 does not read: "
                            f"{why}")

    def unported(self, what: str) -> RuntimeError:
        return RuntimeError(f"{self.path}: an AVIF file with {what}, which "
                            f"the port does not read yet (cv2 does)")

    def boxes(self, start: int, end: int, top: bool = False):
        """(type, payload start, end) of the boxes of a span; at the top
        level a box may run past the end of the file (libavif reads no
        further than the items' extents), and ends there."""
        d = self.data
        pos = start
        while pos < end:
            if end - pos < 8:
                raise self.bad("a box header cut short")
            size, kind = struct.unpack_from(">I4s", d, pos)
            hdr = 8
            if size == 1:
                if end - pos < 16:
                    raise self.bad("a box header cut short")
                size, = struct.unpack_from(">Q", d, pos + 8)
                hdr = 16
            elif size == 0:
                size = end - pos
            if top and kind != b"meta" and pos + size > end >= pos + hdr:
                size = end - pos
            if size < hdr or pos + size > end:
                raise self.bad(f"a {kind.decode('latin-1')!r} box past the "
                               f"end of its parent")
            yield kind, pos + hdr, pos + size
            pos += size

    def parse(self):
        d = self.data
        seen_ftyp = seen_meta = False
        for kind, s, e in self.boxes(0, len(d), top=True):
            if not seen_ftyp:
                if kind != b"ftyp":
                    raise self.bad("the first box is not ftyp")
                seen_ftyp = True
                major = d[s:s + 4]
                compat = [d[i:i + 4] for i in range(s + 8, e - 3, 4)]
                if major == b"avis" or (b"avis" in compat and
                                        b"avif" not in compat and
                                        major != b"avif"):
                    raise self.unported("an image sequence (avis)")
                if major not in AVIF_BRANDS and not any(
                        b in AVIF_BRANDS for b in compat):
                    raise self.bad("no avif brand in ftyp")
            elif kind == b"meta":
                self.parse_meta(s, e)
                seen_meta = True
                break                 # libavif reads no further
            elif kind == b"moov":
                raise self.unported("an image sequence (moov)")
        if not seen_meta:
            raise self.bad("no meta box")

    def parse_meta(self, s: int, e: int):
        d = self.data
        if e - s < 4 or d[s] != 0:
            raise self.bad("a meta box of an unknown version")
        first = True
        for kind, bs, be in self.boxes(s + 4, e):
            # libavif refuses a full box of a version it does not know
            if kind in _AVIF_VERSIONS and (be == bs or d[bs] not in
                                           _AVIF_VERSIONS[kind]):
                raise self.bad(f"a {kind.decode('latin-1')} box of an "
                               f"unknown version")
            if first:
                if kind != b"hdlr":
                    raise self.bad("meta's first box is not hdlr")
                if be - bs < 12 or d[bs + 8:bs + 12] != b"pict":
                    raise self.bad("a handler other than pict")
                if d[bs + 4:bs + 8] != bytes(4):
                    raise self.bad("hdlr's pre_defined is not 0")
                if b"\0" not in d[bs + 24:be]:
                    raise self.bad("a handler name without its terminating "
                                   "0")
                first = False
            elif kind == b"pitm":
                v = d[bs]
                self.primary = int.from_bytes(
                    d[bs + 4:bs + (6 if v == 0 else 8)], "big")
            elif kind == b"iloc":
                self.parse_iloc(bs, be)
            elif kind == b"iinf":
                self.parse_iinf(bs, be)
            elif kind == b"iprp":
                self.parse_iprp(bs, be)
            elif kind == b"iref":
                self.parse_iref(bs, be)
            elif kind == b"idat":
                self.idat = d[bs:be]
        if first:
            raise self.bad("a meta box without hdlr")

    def signature_check(self, grids):
        """Raises where OpenCV's own signature test refuses the file:
        cv2's ``AvifDecoder::checkSignature`` runs libavif's
        ``avifDecoderParse`` over the file's first 500 bytes alone and takes
        the file if that parse succeeds or runs out of data.  It fails
        where a top-level box header before ``meta`` is cut by the 500th
        byte or lies past it (a box before ``meta`` running past it), and,
        where the whole ``meta`` lies in those bytes, where the payload of
        a grid item libavif reads then (``grids``: the primary and alpha
        grid items) begins past them."""
        d = self.data[:500]
        n = len(d)
        pos = 0
        while True:
            if pos >= n or n - pos < 8:
                raise self.bad("a box header past OpenCV's 500-byte "
                               "signature test")
            size, kind = struct.unpack_from(">I4s", d, pos)
            if size == 1:
                if n - pos < 16:
                    raise self.bad("a box header past OpenCV's 500-byte "
                                   "signature test")
                size, = struct.unpack_from(">Q", d, pos + 8)
            if kind in (b"ftyp", b"meta") and (size == 0 or
                                               pos + size > n):
                return                    # libavif runs out of data
            if kind == b"meta":
                break
            if size < 8:                  # to the end, before meta
                raise self.bad("a box before meta running to the end")
            pos += size
        for item in grids:
            if item.get("method") != 0:
                continue
            for off, length in item["extents"]:
                if off > n:
                    raise self.bad("a grid payload past OpenCV's 500-byte "
                                   "signature test")
                if off + length > n:
                    return

    def reader(self, pos: int, end: int):
        d = self.data

        def rd(n: int) -> int:
            nonlocal pos
            if pos + n > end:
                raise self.bad("a box cut short")
            v = int.from_bytes(d[pos:pos + n], "big") if n else 0
            pos += n
            return v
        return rd

    def parse_iloc(self, s: int, e: int):
        rd = self.reader(s, e)
        version = rd(1)
        rd(3)
        if version > 2:
            raise self.bad(f"iloc version {version}")
        a, b = rd(1), rd(1)
        off_size, len_size, base_size = a >> 4, a & 15, b >> 4
        idx_size = b & 15 if version in (1, 2) else 0
        for n in (off_size, len_size, base_size, idx_size):
            if n not in (0, 4, 8):
                raise self.bad(f"iloc field size {n}")
        count = rd(2 if version < 2 else 4)
        for _ in range(count):
            item = rd(2 if version < 2 else 4)
            method = rd(2) & 15 if version in (1, 2) else 0
            if method > 1:
                raise self.unported("an item constructed from another item "
                                    "(iloc construction method 2)")
            rd(2)                     # data_reference_index, not read
            base = rd(base_size)
            extents = []
            for _ in range(rd(2)):
                if idx_size:
                    rd(idx_size)
                extents.append((base + rd(off_size), rd(len_size)))
            if item in self.items and "extents" in self.items[item]:
                raise self.bad(f"item {item} located twice")
            self.items.setdefault(item, {}).update(extents=extents,
                                                   method=method)

    def parse_iinf(self, s: int, e: int):
        d = self.data
        version = d[s]
        pos = s + 4 + (2 if version == 0 else 4)
        count = int.from_bytes(d[s + 4:pos], "big")
        entries = list(self.boxes(pos, e))
        if len(entries) < count:
            raise self.bad(f"iinf counts {count} entries and holds "
                           f"{len(entries)}")
        for kind, bs, be in entries[:count]:
            if kind != b"infe":
                continue
            v = d[bs]
            if v < 2:
                raise self.bad(f"an infe box of version {v}")
            rd = self.reader(bs + 4, be)
            item = rd(2 if v == 2 else 4)
            rd(2)
            at = bs + 4 + (2 if v == 2 else 4) + 2
            itype = d[at:at + 4]
            if b"\0" not in d[at + 4:be]:
                raise self.bad("an item name without its terminating 0")
            self.items.setdefault(item, {})["type"] = itype

    def parse_iprp(self, s: int, e: int):
        d = self.data
        for kind, bs, be in self.boxes(s, e):
            if kind == b"ipco":
                self.props = [(k, d[ps:pe]) for k, ps, pe
                              in self.boxes(bs, be)]
            elif kind == b"ipma":
                rd = self.reader(bs, be)
                version = rd(1)
                if version > 1:
                    raise self.bad(f"ipma version {version}")
                flags = rd(3)
                prev = -1
                for _ in range(rd(4)):
                    item = rd(2 if version < 1 else 4)
                    if item <= prev:
                        raise self.bad("ipma's item IDs do not increase")
                    prev = item
                    assoc = []
                    for _ in range(rd(1)):
                        if flags & 1:
                            v = rd(2)
                            assoc.append((bool(v >> 15), v & 0x7FFF))
                        else:
                            v = rd(1)
                            assoc.append((bool(v >> 7), v & 0x7F))
                    self.items.setdefault(item, {})["assoc"] = assoc

    def parse_iref(self, s: int, e: int):
        d = self.data
        version = d[s]
        n = 2 if version == 0 else 4
        for kind, bs, be in self.boxes(s + 4, e):
            rd = self.reader(bs, be)
            src = rd(n)
            self.refs.append((kind, src, [rd(n) for _ in range(rd(2))]))

    def item_data(self, item: dict) -> bytes:
        src = self.idat if item["method"] == 1 else self.data
        out = []
        for off, length in item["extents"]:
            if length == 0:                     # libavif's rule
                raise self.bad("an item extent of length 0")
            if off + length > len(src):
                raise self.bad("an item's data past the end of the file")
            out.append(src[off:off + length])
        return b"".join(out)

    def primary_item(self):
        """The primary item's coded data (a grid's first tile's) and
        properties."""
        tiles, props, _ = self.primary_image()
        return tiles[0][0], props

    def primary_image(self):
        """The primary item as libavif takes it: ([(tile OBUs, tile
        properties)], the item's properties, the grid (rows, columns,
        output width, output height), or None for an ``av01`` item, whose
        one tile is itself)."""
        if self.primary is None:
            raise self.bad("no primary item (pitm)")
        item = self.items.get(self.primary)
        if item is None or "type" not in item:
            raise self.bad("the primary item has no infe")
        if item["type"] not in (b"av01", b"grid"):
            raise self.bad(f"a primary item of type {item['type']!r}")
        if "extents" not in item:
            raise self.bad("the primary item has no location")
        props = self.properties(item)
        for kind, what in ((b"irot", "a rotation (irot)"),
                           (b"imir", "a mirroring (imir)"),
                           (b"clap", "a clean aperture (clap)")):
            if kind in props:
                raise self.unported(what)
        if b"ispe" not in props:
            raise self.bad("the primary item has no ispe")
        tiles, grid = self.tiles(self.primary, item, props)
        if b"av1C" not in props:
            raise self.bad("the primary item has no av1C")
        # libavif takes one colr of each kind (nclx, ICC) and refuses more
        kinds = [colr[:4] for colr in self.colrs(item)]
        if kinds.count(b"nclx") > 1 or \
                kinds.count(b"prof") + kinds.count(b"rICC") > 1:
            raise self.bad("more than one colr of a kind")
        return tiles, props, grid

    def colrs(self, item: dict):
        """The payloads of the colr properties associated with an item."""
        return [self.props[idx - 1][1] for _, idx in item.get("assoc", [])
                if 0 < idx <= len(self.props) and
                self.props[idx - 1][0] == b"colr"]

    def tiles(self, iid: int, item: dict, props: dict):
        """([(OBUs, properties)] of an image item's tiles, its grid or
        None).  A ``grid`` item (ISO/IEC 23008-12 6.6.2.3) as libavif 1.4.2
        reads it: the ImageGrid payload (version 0, 16- or 32-bit sizes,
        nothing after them, a size not 0 and within libavif's limits), its
        ``dimg`` tiles in reference order, as many as rows x columns, each
        an ``av01`` item without an unknown essential property; the first
        tile's av1C is the grid's (added to ``props``)."""
        if item["type"] != b"grid":
            return [(self.item_data(item), props)], None
        data = self.item_data(item)
        if len(data) < 4 or data[0] != 0:
            raise self.bad("a grid of another version")
        rows, cols = data[2] + 1, data[3] + 1
        n = 4 if data[1] & 1 else 2
        if len(data) != 4 + 2 * n:
            raise self.bad("an ImageGrid payload of another length")
        out_w = int.from_bytes(data[4:4 + n], "big")
        out_h = int.from_bytes(data[4 + n:4 + 2 * n], "big")
        if not out_w or not out_h:
            raise self.bad("a grid of no size")
        if out_w * out_h > 16384 * 16384 or max(out_w, out_h) > 32768:
            raise self.bad("a grid larger than libavif's limits")
        # each dimg target's last reference names its grid and place
        place = {}
        for kind, src, dst in self.refs:
            if kind == b"dimg":
                for k, t in enumerate(dst):
                    place[t] = (src, k)
        order = {k: t for t, (src, k) in place.items() if src == iid}
        count = sum(1 for src, _ in place.values() if src == iid)
        if count != rows * cols or sorted(order) != list(range(count)):
            raise self.bad(f"a {cols}x{rows} grid of {count} tiles")
        ispe = props.get(b"ispe")
        if ispe is not None and ispe[4:12] != struct.pack(">II", out_w,
                                                           out_h):
            raise self.bad("a grid whose ispe is not its output size")
        tiles = []
        for k in range(count):
            tile = self.items.get(order[k], {})
            if tile.get("type") != b"av01":
                raise self.bad("a grid tile that is not an av01 item")
            tprops = self.properties(tile, skip=True)
            if tprops is None:
                raise self.bad("a grid tile with an unknown essential "
                               "property")
            if "extents" not in tile:
                raise self.bad("a grid tile without a location")
            if b"ispe" not in tprops or len(tprops[b"ispe"]) < 12:
                raise self.bad("a grid tile without its ispe")
            tiles.append((self.item_data(tile), tprops))
        if b"av1C" not in tiles[0][1]:
            raise self.bad("a grid whose first tile has no av1C")
        av1c = props.setdefault(b"av1C", tiles[0][1][b"av1C"])
        for _, tprops in tiles:
            # MIAF 7.3.9: the tiles' av1C fields (profile, level, tier,
            # depth, monochrome, subsampling, sample position) agree
            tav1c = tprops.get(b"av1C", b"")
            if len(tav1c) < 4 or tav1c[1:3] != av1c[1:3]:
                raise self.bad("grid tiles of differing or missing av1C")
            if tprops[b"ispe"][4:12] != tiles[0][1][b"ispe"][4:12]:
                raise self.bad("grid tiles of differing sizes (ispe)")
        return tiles, (rows, cols, out_w, out_h)

    def properties(self, item: dict, skip: bool = False):
        """An item's properties by type (the first of a type), with
        libavif's checks of their associations; with ``skip``, None where
        libavif skips the item instead (an unknown essential property)."""
        props = {}
        for essential, idx in item.get("assoc", []):
            if idx == 0:
                continue
            if idx > len(self.props):
                raise self.bad("a property index past ipco's boxes")
            kind, payload = self.props[idx - 1]
            if kind in _AVIF_VERSIONS and (not payload or payload[0] not in
                                           _AVIF_VERSIONS[kind]):
                raise self.bad(f"a {kind.decode('latin-1')} box of an "
                               f"unknown version")
            if kind in (b"irot", b"imir") and not essential:
                raise self.bad(f"a transformative property "
                               f"{kind.decode('latin-1')!r} not marked "
                               f"essential")
            if kind not in _AVIF_KNOWN_PROPERTIES:
                if essential:
                    if skip:
                        return None
                    raise self.bad(f"an unknown essential property "
                                   f"{kind.decode('latin-1')!r}")
                continue
            props.setdefault(kind, payload)
        return props

    def alpha_item(self):
        """The tiles, properties and grid (as ``primary_image`` gives them)
        of the primary item's alpha, or None (its id kept in ``alpha``):
        libavif's alpha item is the first item whose ``auxl`` reference
        (its last target) names the primary item and whose
        ``auxC`` names the alpha URN, among the items it does not skip
        (no data, an unknown essential property, a type other than av01
        or grid, a thumbnail); other auxiliary items are not read.  cv2
        reads 3 channels and drops the alpha, but refuses a file whose
        alpha item is malformed or does not decode."""
        targets = {}
        for kind, src, dst in self.refs:
            if dst and kind in (b"auxl", b"thmb"):
                targets.setdefault(src, {})[kind] = dst[-1]
            if kind == b"prem" and dst and src == self.primary:
                # libavif then unpremultiplies the colour by the alpha
                raise self.unported("a premultiplied alpha (prem)")
        for iid, item in self.items.items():
            refs = targets.get(iid, {})
            if refs.get(b"auxl") != self.primary or b"thmb" in refs:
                continue
            if not sum(n for _, n in item.get("extents", ())):
                continue
            if item.get("type") not in (b"av01", b"grid"):
                continue
            props = self.properties(item, skip=True)
            if props is None:
                continue
            auxc = props.get(b"auxC")
            if auxc is None:
                continue
            if len(auxc) < 4 or auxc[0] != 0 or b"\0" not in auxc[4:]:
                raise self.bad("an auxC box of another version or without "
                               "its terminating 0")
            if auxc[4:].split(b"\0")[0] not in _AVIF_ALPHA_URNS:
                continue
            tiles, grid = self.tiles(iid, item, props)
            self.alpha = iid
            if b"av1C" not in props:
                raise self.bad("the alpha item has no av1C")
            for kind in (b"irot", b"imir", b"clap"):
                if kind in props:
                    raise self.bad(f"a transformative property "
                                   f"{kind.decode('latin-1')!r} on the alpha "
                                   f"item")
            return tiles, props, grid
        return None


def _avif_nclx(props: dict):
    """(matrix, full range) from an nclx colr property, or None."""
    colr = props.get(b"colr")
    if colr is None or colr[:4] != b"nclx" or len(colr) < 11:
        return None
    _, _, matrix = struct.unpack_from(">HHH", colr, 4)
    return matrix, bool(colr[10] >> 7)


def _avif_check_properties(heif: _Heif, props: dict) -> bool:
    """libavif's checks of the properties: colr's reserved bits, av1C's
    marker and version, pixi's channels and depths against av1C's.
    → av1C's monochrome flag (libavif then gives cv2 a gray image)."""
    colr = props.get(b"colr")
    if colr is not None and colr[:4] == b"nclx" and len(colr) >= 11 and \
            colr[10] & 0x7F:
        raise heif.bad("colr's reserved bits are not 0")
    av1c = props[b"av1C"]
    if len(av1c) < 4 or av1c[0] != 0x81:
        raise heif.bad("an av1C box of another marker or version")
    av1c_depth = 12 if av1c[2] & 0x20 else 10 if av1c[2] & 0x40 else 8
    pixi = props.get(b"pixi")
    if pixi is not None:
        if len(pixi) < 5 or pixi[4] not in (1, 3) or \
                len(pixi) < 5 + pixi[4]:
            raise heif.bad("a pixi box of other than 1 or 3 channels")
        if any(x != av1c_depth for x in pixi[5:5 + pixi[4]]):
            raise heif.bad(f"pixi's depths {list(pixi[5:5 + pixi[4]])} "
                           f"are not av1C's {av1c_depth} bits")
    return bool(av1c[2] & 0x10)


def _up2_linear(c: np.ndarray, width: int) -> np.ndarray:
    """libyuv's ScaleRowUp2_Linear_Any: each row of c twice as wide, as
    wide as ``width``, with the 3:1 taps and the edge samples copied."""
    out = np.empty(c.shape[:-1] + (width,), np.int32)
    out[..., 0] = c[..., 0]
    n = ((width - 1) & ~1) // 2
    if n:
        a, b = c[..., :n], c[..., 1:n + 1]
        out[..., 1:1 + 2 * n:2] = (3 * a + b + 2) >> 2
        out[..., 2:2 + 2 * n:2] = (a + 3 * b + 2) >> 2
    out[..., width - 1] = c[..., (width - 1) // 2]
    return out


def upsample_420(c: np.ndarray, width: int, height: int) -> np.ndarray:
    """A 4:2:0 chroma plane at full size as libyuv 1924's
    I420ToARGBMatrixBilinear upsamples it (what libavif's default
    ``AVIF_CHROMA_UPSAMPLING_AUTOMATIC`` reaches): the first row, and the
    last of an even height, from one chroma row (3:1 across), every other
    pair of rows from two (9:3:3:1), the edge columns 3:1 down only."""
    c = c.astype(np.int32)
    out = np.empty((height, width), np.int32)
    out[0] = _up2_linear(c[0], width)
    pairs = (height - 1) // 2
    if pairs:
        s, t = c[:pairs], c[1:pairs + 1]
        n = ((width - 1) & ~1) // 2
        d = np.empty((pairs, width), np.int32)
        e = np.empty((pairs, width), np.int32)
        d[:, 0] = (3 * s[:, 0] + t[:, 0] + 2) >> 2
        e[:, 0] = (s[:, 0] + 3 * t[:, 0] + 2) >> 2
        if n:
            a, b = s[:, :n], s[:, 1:n + 1]
            p, q = t[:, :n], t[:, 1:n + 1]
            d[:, 1:1 + 2 * n:2] = (9 * a + 3 * b + 3 * p + q + 8) >> 4
            d[:, 2:2 + 2 * n:2] = (3 * a + 9 * b + p + 3 * q + 8) >> 4
            e[:, 1:1 + 2 * n:2] = (3 * a + b + 9 * p + 3 * q + 8) >> 4
            e[:, 2:2 + 2 * n:2] = (a + 3 * b + 3 * p + 9 * q + 8) >> 4
        k = (width - 1) // 2
        d[:, width - 1] = (3 * s[:, k] + t[:, k] + 2) >> 2
        e[:, width - 1] = (s[:, k] + 3 * t[:, k] + 2) >> 2
        out[1:1 + 2 * pairs:2] = d
        out[2:2 + 2 * pairs:2] = e
    if height % 2 == 0 and height > 1:
        out[height - 1] = _up2_linear(c[pairs], width)
    return out


def yuv_to_rgb_jpeg(y: np.ndarray, u: np.ndarray, v: np.ndarray
                    ) -> np.ndarray:
    """8-bit full-range BT.601 YUV (chroma at full size) → (H, W, 3) uint8
    RGB in libyuv 1924's row arithmetic (``YuvPixel`` with
    kYuvJPEGConstants: Y scaled by 0x0101 · 16320 >> 16, U and V in 1/64,
    a 6-bit shift and a clamp)."""
    k = _YUV_JPEG
    y = y.astype(np.int32)
    u = u.astype(np.int32)
    v = v.astype(np.int32)
    y1 = ((y * 0x0101).astype(np.int64) * k["yg"] >> 16).astype(np.int32)
    b = y1 + u * k["ub"] - (k["ub"] * 128 - k["yb"])
    g = y1 + (k["ug"] * 128 + k["vg"] * 128 + k["yb"]) - (u * k["ug"] +
                                                          v * k["vg"])
    r = y1 + v * k["vr"] - (k["vr"] * 128 - k["yb"])
    return np.clip(np.stack([r, g, b], -1) >> 6, 0, 255).astype(np.uint8)


def avif_gray(y: np.ndarray, depth: int) -> np.ndarray:
    """A gray AVIF (av1C's monochrome flag) → (H, W, 3) uint8 as cv2 5.0.0
    reads it: OpenCV copies the luma plane itself, whatever colr says, and
    converts samples past 8 bits with ``convertTo``'s scale of 2^(8 - depth)
    (rounded half to even, saturated)."""
    y = y.astype(np.int64)
    if depth > 8:
        s = depth - 8
        q, r, half = y >> s, y & ((1 << s) - 1), 1 << (s - 1)
        y = np.minimum(q + ((r > half) | ((r == half) & (q & 1 == 1))), 255)
    return np.repeat(y.astype(np.uint8)[..., None], 3, -1)


def avif_planes_to_rgb(planes, depth: int, subx: int, suby: int,
                       matrix: int, full_range: bool, path="image"):
    """Decoded AV1 planes → (H, W, 3) uint8 RGB as cv2 5.0.0 gets them:
    OpenCV asks libavif 1.4.2 for 8-bit BGR; libavif cuts samples past 8
    bits to their top 8 and converts with libyuv (BT.601 and BT.470BG full
    range; 4:2:0 and 4:2:2 chroma upsampled bilinearly), or takes its own
    identity path (GBR, matrix 0, 4:4:4: samples past 8 bits scaled by 255
    / max and rounded).  A monochrome frame under a colour av1C: its luma
    as gray at 8 bits, as libyuv's I400 conversion gives it."""
    if len(planes) == 1:
        if depth > 8 or not full_range:
            raise RuntimeError(f"{path}: an AVIF image of a monochrome frame "
                               f"under a colour av1C at {depth} bits or "
                               f"limited range, which the port does not read "
                               f"yet (cv2 does)")
        return avif_gray(planes[0], 8)
    y, u, v = planes
    height, width = y.shape
    if not full_range:
        raise RuntimeError(f"{path}: an AVIF image of limited-range YUV, "
                           f"which the port does not read yet (cv2 does)")
    if matrix == 0:
        if subx or suby:
            raise RuntimeError(f"{path}: an AVIF file cv2 does not read: "
                               f"the identity matrix with subsampled chroma")
        gbr = np.stack([v, y, u], -1).astype(np.int64)
        if depth > 8:        # libavif's float path: round(x / max · 255)
            top = (1 << depth) - 1
            gbr = (gbr * 510 + top) // (2 * top)
        return gbr.astype(np.uint8)
    if depth > 8:
        s = depth - 8
        y, u, v = (np.minimum(p >> s, 255) for p in (y, u, v))
    if matrix not in (5, 6):
        raise RuntimeError(f"{path}: an AVIF image of matrix coefficients "
                           f"{matrix}, which the port does not read yet "
                           f"(cv2 does)")
    if subx and suby:
        u = upsample_420(u, width, height)
        v = upsample_420(v, width, height)
    elif subx:          # 4:2:2: libyuv's I422ToARGBMatrixLinear, rows alone
        u = _up2_linear(u.astype(np.int32), width)
        v = _up2_linear(v.astype(np.int32), width)
    return yuv_to_rgb_jpeg(y, u, v)


def decode_av1(obu: bytes, path="image", grain: bool = True):
    """The OBUs of an AV1 still image → ([Y, U, V] uint16 planes, or [Y]
    for a monochrome frame, info): info is (width, height, bit depth,
    subsampling x, subsampling y, monochrome, colour primaries, transfer,
    matrix, full range) from the sequence header, then the tools the frame
    used (tile columns and rows, 128x128 superblocks, CDEF, quantizer
    matrices, lossless, delta q, filter intra enabled, screen content
    tools, intra block copy allowed), the palette and intra block copy
    blocks decoded and whether film grain was applied; then where the
    frame header lies (its OBU payload's offset in ``obu``, the bit of its
    film grain fields, its bytes).  With ``grain`` False the planes are
    the frame before its film grain."""
    import ctypes

    lib = _load_avif_codec()
    err = ctypes.create_string_buffer(_AVIF_ERRLEN)
    handle = lib.av1_decode(obu, len(obu), 0 if grain else 1, err,
                            _AVIF_ERRLEN)
    if not handle:
        msg = err.value.decode(errors="replace")
        if msg.startswith("unported: "):
            raise RuntimeError(f"{path}: an AVIF image with {msg[10:]}, "
                               f"which the port does not read yet (cv2 "
                               f"does)")
        raise RuntimeError(f"{path}: AV1 data cv2 does not read: {msg}")
    try:
        info = (ctypes.c_longlong * 26)()
        lib.av1_info(handle, info)
        info = list(info)
        width, height, _, subx, suby, mono = info[:6]
        planes = []
        for p in range(1 if mono else 3):
            sx, sy = (subx, suby) if p else (0, 0)
            plane = np.empty(((height + sy) >> sy, (width + sx) >> sx),
                             np.uint16)
            lib.av1_plane(handle, p, plane.ctypes.data)
            planes.append(plane)
    finally:
        lib.av1_free(handle)
    return planes, info


def _avif_assemble(heif: _Heif, tiles, grid, path, alpha: bool = False):
    """The decoded frame of an image item: its one tile's, or a grid's
    tiles placed into one frame as libavif 1.4.2 places them → (planes,
    info of the first tile with the item's size).  Each tile's frame must
    have its ispe's size (libavif would scale it); a grid's tiles must
    agree in size, depth, chroma format, range and CICP, cover the grid
    with the last row and column overlapping its edge (MIAF 7.3.11.4.2),
    be at least 64x64 and even where chroma is subsampled.  A lone alpha
    frame of another size than its item's is fitted to it by libavif, and
    not checked here (cv2 drops the alpha)."""
    decoded = []
    for obu, props in tiles:
        planes, info = decode_av1(obu, path)
        ispe = props.get(b"ispe")
        if ispe is not None and len(ispe) < 12:
            raise heif.bad("an ispe box cut short")
        if ispe is not None and not (alpha and grid is None) and tuple(
                info[:2]) != struct.unpack_from(">II", ispe, 4):
            # libavif sizes its image by ispe and scales the frame to it
            raise heif.unported(f"a {info[0]}x{info[1]} frame in an item "
                                f"whose ispe differs")
        decoded.append((planes, info))
    if grid is None:
        return decoded[0]
    rows, cols, out_w, out_h = grid
    planes0, info0 = decoded[0]
    for _, info in decoded[1:]:
        if info[:6] != info0[:6] or info[6:10] != info0[6:10]:
            raise heif.bad("a grid of tiles that differ in size, depth, "
                           "chroma, range or CICP")
    tw, th, _, subx, suby = info0[:5]
    if tw * cols < out_w or th * rows < out_h:
        raise heif.bad("grid tiles that do not cover the image")
    if tw * (cols - 1) >= out_w or th * (rows - 1) >= out_h:
        raise heif.bad("grid tiles of a last row or column past the image")
    if tw < 64 or th < 64:
        raise heif.bad(f"{tw}x{th} grid tiles, under MIAF's 64")
    if (subx and (out_w % 2 or tw % 2)) or (suby and (out_h % 2 or th % 2)):
        raise heif.bad("odd grid sides where chroma is subsampled")
    out = []
    for p in range(len(planes0)):
        sx, sy = (subx, suby) if p else (0, 0)
        full = np.empty(((out_h + sy) >> sy, (out_w + sx) >> sx), np.uint16)
        for k, (planes, _) in enumerate(decoded):
            x, y = (k % cols) * tw, (k // cols) * th
            w, h = min(tw, out_w - x), min(th, out_h - y)
            full[y >> sy:(y >> sy) + ((h + sy) >> sy),
                 x >> sx:(x >> sx) + ((w + sx) >> sx)] = \
                planes[p][:(h + sy) >> sy, :(w + sx) >> sx]
        out.append(full)
    return out, [out_w, out_h] + list(info0[2:])


def _decode_avif_bytes(data: bytes, path):
    heif = _Heif(data, path)
    heif.parse()
    tiles, props, grid = heif.primary_image()
    ispe = props[b"ispe"]
    if len(ispe) < 12:
        raise heif.bad("an ispe box cut short")
    gray = _avif_check_properties(heif, props)
    alpha = heif.alpha_item()
    if alpha is not None:
        _avif_check_properties(heif, alpha[1])
        # an alpha without ispe takes the colour's (libavif's non-standard
        # rule); its size must be the colour item's
        aispe = alpha[1].get(b"ispe", ispe)
        if len(aispe) < 12:
            raise heif.bad("an ispe box cut short")
        if aispe[4:12] != ispe[4:12]:
            raise heif.bad("an alpha item of another size than the colour")
    heif.signature_check([heif.items[i] for i in (heif.primary, heif.alpha)
                          if i is not None and
                          heif.items[i]["type"] == b"grid"])
    planes, info = _avif_assemble(heif, tiles, grid, path)
    width, height, depth, subx, suby = info[:5]
    if alpha is not None:
        # libavif decodes the alpha too (its frame fitted to the item's
        # size), and refuses one that does not decode or whose depth is not
        # the colour's
        _, ainfo = _avif_assemble(heif, alpha[0], alpha[2], path, True)
        if ainfo[2] != depth:
            raise heif.bad(f"a {ainfo[2]}-bit alpha frame for a {depth}-bit "
                           f"image")
        if alpha[2] is not None and tuple(ainfo[:2]) != (width, height):
            raise heif.bad("an alpha grid of another size than the colour")
    if gray:
        if alpha is not None:
            # OpenCV's reader asks for 2 channels and fails
            raise heif.bad("a gray image with an alpha item")
        return avif_gray(planes[0], depth)
    nclx = _avif_nclx(props)
    matrix, full = nclx if nclx is not None else (info[8], bool(info[9]))
    return avif_planes_to_rgb(planes, depth, subx, suby, matrix, full, path)


def read_avif(path) -> np.ndarray:
    """An AVIF file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (cv2 5.0.0 with libavif 1.4.2,
    libaom 3.14.1 and libyuv 1924): the container parsed here as libavif
    parses a still image, the AV1 key frame decoded by the port's own
    decoder (``csrc/avif_codec.cpp``), the YUV → RGB of libavif and libyuv.
    Reads what cv2's and Pillow's writers make: 8, 10 and 12 bits, 4:2:0,
    4:2:2, 4:4:4 and 4:0:0 (gray: the luma as OpenCV copies it), lossless
    too, any tiling, 64x64 or 128x128 superblocks, CDEF, quantizer
    matrices, the screen content tools (palette, intra block copy), film
    grain (synthesised as libaom's ``av1_add_film_grain`` does), an alpha
    item (decoded and checked as libavif does, then dropped as cv2's
    3-channel read drops it), and grid items (colour and alpha) with
    libavif's grid rules.  Raises ``RuntimeError`` naming the file where
    cv2 returns None (OpenCV's own 500-byte signature test included), and
    naming the kind for what the port does not read yet (image sequences,
    rotations, mirrors, clean apertures, a premultiplied alpha, loop
    restoration, superres, segmentation, delta loop filter, full sequence
    headers, matrices other than BT.601 and identity, limited range)."""
    with open(path, "rb") as f:
        data = f.read()
    return _decode_avif_bytes(data, path)


def read_image(fn: str) -> np.ndarray:
    """An image file → (H, W, 3) uint8 RGB, what ``cv2.imread`` then
    ``COLOR_BGR2RGB`` gives the JAX package.  The format is the file's
    signature, not its extension (as for ``cv2.imread``): PNG, JPEG, TIFF
    and BigTIFF (``II*\\0``, ``MM\\0*``, ``II+\\0``, ``MM\\0+``), BMP
    (``BM``), PNM (``P1``-``P6``), WebP (``RIFF....WEBP``), GIF (``GIF``),
    Radiance HDR (``#?RADIANCE``, ``#?RGBE``), PFM (``PF``, ``Pf``), PAM
    (``P7``), Sun raster, JPEG 2000 (the JP2 signature box, or a raw
    codestream's ``FF 4F FF 51``) and AVIF (an ``ftyp`` box with the
    ``avif`` or ``avis`` brand) through the port's own readers (AVIF: every
    chroma format, the screen content tools, film grain and the alpha item
    that cv2's and Pillow's writers make, and grids; ``read_avif``).  A kind
    of AVIF the port does not read yet (sequences and the rarer kinds
    ``read_avif`` lists) raises ``RuntimeError`` naming the file and the
    kind; any other file raises naming the file."""
    with open(fn, "rb") as f:
        head = f.read(512)
    if head.startswith(PNG_SIGNATURE):
        return read_png(fn)
    if head.startswith(JPEG_SIGNATURE):
        return read_jpeg(fn)
    if head[:4] in TIFF_SIGNATURES:
        return read_tiff(fn)
    if head.startswith(b"BM"):
        return read_bmp(fn)
    if head[:4] == WEBP_SIGNATURE[0] and head[8:12] == WEBP_SIGNATURE[1]:
        return read_webp(fn)
    if head[:1] == b"P" and head[2:3].isspace():
        if head[1:2] in (b"1", b"2", b"3", b"4", b"5", b"6"):
            return read_pnm(fn)
        if head[1:2] in (b"F", b"f"):
            return read_pfm(fn)
        if head[1:2] == b"7":
            return read_pam(fn)
    if head[:3] == b"GIF":
        return read_gif(fn)
    if head.startswith(HDR_SIGNATURES):
        return read_hdr(fn)
    if head[:4] == SUNRAS_SIGNATURE:
        return read_sunras(fn)
    if head.startswith(JP2_SIGNATURE) or head.startswith(J2K_SIGNATURE):
        return read_jpeg2000(fn)
    if is_avif(head):
        return read_avif(fn)
    raise RuntimeError(f"{fn}: not an image format that cv2 or the port "
                       f"reads")
