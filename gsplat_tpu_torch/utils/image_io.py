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
for Deflate, the JPEG codec for JPEG strips; the directory, YCbCr and
CIELab are read here), BMP and PNM (numpy).

WebP (``csrc/webp_codec.cpp`` for the VP8L and VP8 bitstreams and the ALPH
chunk; the RIFF container, libwebp's demuxer rules and EXIF are parsed
here): lossless, lossy, alpha, extended and animated files; ``write_webp``
writes lossless VP8L with the port's own small encoder.

GIF and Radiance HDR (``csrc/gif_hdr_codec.cpp`` for GIF's LZW, the GIF
writer's Floyd-Steinberg dither onto its fixed 3-3-2 palette and HDR's
run-length scanlines; the blocks, headers and colours here), PFM, PAM and
Sun raster (numpy).

JPEG 2000 (``csrc/jpeg2000_codec.cpp`` for the codestream: OpenJPEG 2.5.3's
decoding, every Part-1 option, HT code-blocks and the Part 2 and 15
markers it reads; the JP2 and JPH boxes, palettes, channel
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


def _decode_jpeg_bytes(data: bytes, path, transform: int = -1,
                       kinds: dict | None = None):
    """JPEG bytes → ((H, W, 3) uint8 RGB in the stored orientation, EXIF
    orientation, warning or None).  ``transform``: -1 the color space the
    markers give (libjpeg's default), 0 the components as they are, 1
    YCbCr (what libtiff asks libjpeg for in a TIFF).  ``kinds``, where
    given, gets ``subsampled_lossless`` (1 for a lossless frame of
    subsampled components)."""
    import ctypes

    lib = _load_jpeg_codec()
    err = ctypes.create_string_buffer(_ERRLEN)
    info = (ctypes.c_int * 5)()
    if lib.jpeg_info(data, len(data), info, err, _ERRLEN) != 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    width, height, _, orientation = info[:4]
    if kinds is not None:
        kinds["subsampled_lossless"] = info[4]
    img = np.empty((height, width, 3), np.uint8)
    rc = lib.jpeg_decode(data, len(data), transform,
                         img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         img.size, err, _ERRLEN)
    if rc < 0:
        raise ValueError(f"{path}: {err.value.decode()}")
    return img, orientation, (err.value.decode() if rc == 1 else None)


def read_jpeg(path, info: dict | None = None) -> np.ndarray:
    """A JPEG file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (libjpeg-turbo's default
    decompression, EXIF orientation applied; a CMYK or YCCK file through
    OpenCV's CMYK → BGR; a lossless frame of subsampled components
    upsampled by replication).  A file whose data ends early decodes as
    libjpeg decodes it, with a ``RuntimeWarning`` that names the file.
    Raises ``ValueError`` naming the file for what cv2 does not read
    either (hierarchical frames, 12-bit samples, 2 components, lossless
    grayscale, arithmetic-coded lossless, lossless restart intervals that
    split an MCU row) and for malformed data.  ``info``, where given, gets
    ``subsampled_lossless`` (1 for a lossless frame of subsampled
    components)."""
    import warnings

    with open(path, "rb") as f:
        data = f.read()
    img, orientation, warning = _decode_jpeg_bytes(data, path, kinds=info)
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
    for fn in (lib.tiff_lzw_decode, lib.tiff_lzw_decode_compat,
               lib.tiff_packbits_decode, lib.tiff_lzw_encode):
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


def _tiff_old_lzw(raw: bytes) -> bool:
    """Whether libtiff's LZWPreDecode takes an LZW strip or tile for
    old-style codes: its first byte 0 and bit 0 of its second set."""
    return len(raw) >= 2 and raw[0] == 0 and raw[1] & 1 == 1


def _tiff_chunk(lib, raw: bytes, comp: int, nbytes: int, path,
                old_lzw: bool = False) -> bytes:
    """One strip or tile, decompressed to (at least) its nbytes
    (``old_lzw``: LZW in old-style codes, libtiff's LZWDecodeCompat)."""
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
        fn = lib.tiff_packbits_decode if comp != 5 else \
            lib.tiff_lzw_decode_compat if old_lzw else lib.tiff_lzw_decode
        got = fn(raw, len(raw), buf.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), nbytes)
        if got < 0:
            raise ValueError(f"{path}: corrupt LZW TIFF data")
        out = buf[:got].tobytes()
    if len(out) < nbytes:
        raise ValueError(f"{path}: a TIFF strip or tile holds "
                         f"{len(out)} bytes, not {nbytes}")
    return out[:nbytes]


def _tiff_raw_tile_check(count: int, size: int, reverse: bool, path):
    """libtiff reads an uncompressed tile only where its byte count is the
    tile's size, and with FillOrder 2 (read into a buffer of whole KiB,
    not mapped) only where that size is whole KiB; cv2 refuses the rest.
    (A FillOrder 2 tile short of whole KiB that rounds up to its size cv2
    reads as something else than its samples; the port refuses it too.)"""
    if count != size or (reverse and size % 1024):
        raise ValueError(f"{path}: an uncompressed TIFF tile of {count} "
                         f"bytes{' (FillOrder 2)' if reverse else ''} for "
                         f"{size} is not supported (nor by cv2: libtiff "
                         f"refuses it)")


def _tiff_jpeg_chunk(raw: bytes, tables, transform: int, path):
    """A strip or tile of a JPEG-compressed TIFF (compression 7): its JPEG
    stream after the JPEGTables' tables, decoded as libtiff asks libjpeg
    (``transform`` 1: YCbCr → RGB; 0: the components as they are)."""
    if tables is not None and len(tables) > 4 and raw[:2] == JPEG_SIGNATURE:
        raw = bytes(tables[:-2]) + raw[2:]
    return _decode_jpeg_bytes(raw, path, transform)[0]


def read_tiff(path, info: dict | None = None) -> np.ndarray:
    """The first image of a TIFF or BigTIFF → (H, W, 3) uint8 RGB, what
    ``cv2.imread(path)[..., ::-1]`` gives (OpenCV's ``TiffDecoder``, which
    reads 8-bit output through libtiff's RGBA interface): II or MM, strips
    or tiles, chunky or planar; no compression, LZW (old-style codes too),
    Deflate, PackBits or JPEG, the horizontal predictor at 8 and 16 bits;
    bilevel, 8- and 16-bit gray (white or black is zero, 16 bits cut to
    the high byte; extra samples too), RGB at 8 or 16 bits (16 bits
    rounded to 8 as libtiff rounds them, an unassociated alpha multiplied
    in, the alpha then dropped), palettes of 1-8 bits, 8-bit CMYK, 8-bit
    YCbCr (subsampled 1, 2 or 4 across, under the predictor as libtiff
    undoes it, its ReferenceBlackWhite and YCbCrCoefficients) and 8- and
    16-bit CIELab through libtiff's tables; the orientation tag applied.
    Raises ``ValueError`` naming the file and the tag for the rest, most
    of which cv2 does not read either (2- and 4-bit gray, float samples,
    more than 4 samples, 16-bit YCbCr, YCbCr or CIELab with extra samples,
    old-style JPEG; orientations 5-8 of a non-square image, which cv2
    fails on; ROADMAP §3).  ``info``, where given, gets the
    counts of the kinds the file took: ``cielab16`` (1 for 16-bit CIELab),
    ``ycbcr_predictor_chunks`` (strips or tiles of subsampled YCbCr whose
    differences were undone), ``ycbcr_predictor_skipped`` (those libtiff
    leaves differenced: not whole rows of its row size, or rows not of
    whole pixels), ``old_lzw_chunks`` (strips or tiles decoded as
    old-style LZW)."""
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

    def refuse(what, why=""):
        return ValueError(f"{path}: TIFF {what} is not supported{why}")

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
    if comp == 6:
        raise refuse("old-style JPEG (tag 259 = 6)", " (nor by cv2: its "
                     "libtiff has no OJPEG codec)")
    if comp not in _TIFF_COMPRESSIONS:
        raise refuse(f"tag 259 (Compression {comp})")
    if comp in (1, 32773):     # libtiff applies a predictor only to LZW,
        predictor = 1          # Deflate (and JPEG's own) data
    if predictor not in (1, 2) or (predictor == 2 and bps not in (8, 16)):
        raise refuse(f"tag 317 (Predictor {predictor} at {bps} bits)")
    if tag(266, 1) not in (1, 2):
        raise refuse(f"tag 266 (FillOrder {tag(266)})")
    if spp > 4:
        raise refuse(f"{spp} samples a pixel (tag 277)", " (nor by cv2: "
                     "OpenCV reads at most 4)")
    if photo in (0, 1):
        if bps not in (1, 8, 16) or (spp > 1 and bps == 1):
            raise refuse(f"{bps}-bit gray of {spp} samples (tags 258, 277)",
                         " (nor by cv2: libtiff's RGBA interface has no "
                         "routine for it)")
    elif photo == 2:
        if spp < 3 or bps not in (8, 16):
            raise refuse(f"RGB with {spp} samples of {bps} bits (tags "
                         f"277, 258)")
    elif photo == 3:
        # extra samples: chunky 8-bit ones alone (TIFFRGBAImageOK, and no
        # routine for separate planes)
        if bps not in (1, 4, 8) or 320 not in tags or \
                (spp > 1 and (bps != 8 or planar != 1)):
            raise refuse(f"palette of {bps} bits and {spp} samples, planar "
                         f"{planar} (tags 258, 277, 284, 320; cv2 reads no "
                         f"2-bit one either)")
    elif photo == 5:
        if spp < 4 or bps != 8 or tag(332, 1) != 1:
            raise refuse(f"separated (tag 262 = 5) with {spp} samples of "
                         f"{bps} bits")
    elif photo in (6, 8) and comp != 7:
        what = "YCbCr" if photo == 6 else "CIELab"
        # what libtiff refuses: chunky YCbCr of other than 3 samples its
        # strip size (TIFFVStripSize64), CIELab of other than 3 samples or
        # 8 or 16 bits its RGBA check (TIFFRGBAImageOK), the rest its RGBA
        # setup, which has no routine for them (TIFFRGBAImageBegin)
        by = "TIFFRGBAImageBegin"
        if photo == 6 and planar == 1 and spp != 3:
            by = "TIFFVStripSize64"
        elif photo == 8 and (spp != 3 or bps not in (8, 16)):
            by = "TIFFRGBAImageOK"
        if spp != 3 or bps != 8 and (photo == 6 or bps != 16) or \
                (planar != 1 and photo == 8):
            raise refuse(f"{what} (tag 262 = {photo}) with {spp} samples "
                         f"of {bps} bits, planar {planar}",
                         f" (nor by cv2: libtiff's {by} refuses it)")
    elif not (photo == 6 and comp == 7):
        raise refuse(f"tag 262 (Photometric {photo})", " (nor by cv2: "
                     "libtiff's TIFFRGBAImageOK refuses it)" if photo in
                     (9, 10) else "")
    if comp == 7 and (bps != 8 or photo not in (1, 2, 6) or planar != 1):
        raise refuse(f"JPEG compression with tag 262 = {photo}, 258 = "
                     f"{bps}, 284 = {planar}")
    # YCbCr's chroma subsampling (tag 530, default 2, 2): libtiff's RGBA
    # interface reads 1, 2 or 4 across by at most as many down
    sub = tuple(tags.get(530, (2, 2))[:2]) if photo == 6 and comp != 7 \
        else (1, 1)
    if sub not in ((1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4), (1, 2)) \
            or (sub != (1, 1) and planar != 1):
        raise refuse(f"YCbCr subsampling {sub} (tag 530), planar {planar}")
    tiled = 322 in tags
    if tiled:
        cw, ch = tag(322), tag(323)
        offsets, sizes = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(tag(278, 2 ** 32 - 1), height)
        offsets, sizes = tags.get(273), tags.get(279)
    if offsets is None or sizes is None or cw <= 0 or ch <= 0:
        raise ValueError(f"{path}: TIFF without strip or tile offsets")
    nplanes = spp if planar == 2 else 1
    cspp = 1 if planar == 2 else spp               # samples in a chunk
    across, down = -(-width // cw), -(-height // ch)
    if len(offsets) < across * down * nplanes or len(sizes) < len(offsets):
        raise ValueError(f"{path}: TIFF with too few strips or tiles")
    row_bytes = (cw * cspp * bps + 7) // 8
    wide = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)
    samples = np.zeros((height, width, spp), np.uint16 if bps == 16
                       else np.uint8)
    lib = _load_tiff_codec() if comp in (5, 32773) else None
    transform = 1 if photo == 6 else 0
    reverse = tag(266, 1) == 2 and comp != 7
    counts = dict(cielab16=int(photo == 8 and bps == 16),
                  ycbcr_predictor_chunks=0, ycbcr_predictor_skipped=0,
                  old_lzw_chunks=0)

    def chunk(k):
        raw = data[offsets[k]:offsets[k] + sizes[k]]
        if reverse:
            raw = np.unpackbits(np.frombuffer(raw, np.uint8))
            raw = np.packbits(raw.reshape(-1, 8)[:, ::-1]).tobytes()
        return raw
    # libtiff's LZW codec takes the style of the first chunk it decodes
    # (LZWPreDecode, the first strip or tile of plane 0) for the whole
    # file: old-style codes there, LZWDecodeCompat for every chunk
    old = comp == 5 and _tiff_old_lzw(chunk(0))
    counts["old_lzw_chunks"] = across * down * nplanes if old else 0
    k = 0
    for plane in range(nplanes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * ch, tx * cw
                rows = ch if tiled else min(ch, height - y0)
                raw = chunk(k)
                if tiled and comp == 1:
                    _tiff_raw_tile_check(sizes[k], _ycbcr_unit_bytes(
                        rows, cw, sub) if sub != (1, 1) else rows * row_bytes,
                        reverse, path)
                if comp == 7:
                    block = _tiff_jpeg_chunk(raw, tags.get(347), transform,
                                             path)
                    if photo == 1:
                        block = block[..., :1]
                elif sub != (1, 1):
                    full = _ycbcr_unit_bytes(rows, cw, sub)
                    n, rowsize = _ycbcr_decoded(rows, cw, sub, tiled, full)
                    buf = _tiff_chunk(lib, raw, comp, n, path, old)
                    if predictor == 2:
                        whole = n % rowsize == 0 and rowsize % 3 == 0
                        if whole:          # horAcc8, 3 bytes back
                            buf = np.cumsum(np.frombuffer(buf, np.uint8)
                                            .reshape(n // rowsize, -1, 3),
                                            axis=1, dtype=np.uint8).tobytes()
                        counts["ycbcr_predictor_chunks" if whole else
                               "ycbcr_predictor_skipped"] += 1
                    block = _ycbcr_units(buf + bytes(full - n), rows, cw,
                                         sub, min(cw, width - x0) if tiled
                                         else cw)
                else:
                    buf = _tiff_chunk(lib, raw, comp, rows * row_bytes, path,
                                      old)
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
                k += 1
                h = min(rows, height - y0, block.shape[0])
                w = min(cw, width - x0, block.shape[1])
                sl = slice(plane, plane + 1) if planar == 2 else slice(None)
                samples[y0:y0 + h, x0:x0 + w, sl] = block[:h, :w]
    if info is not None:
        info.update(counts)
    if photo == 6 and comp != 7:
        img = tiff_ycbcr_to_rgb(samples, _tiff_floats(tags.get(529)),
                                _tiff_floats(tags.get(532)))
    elif photo == 8:
        img = tiff_cielab_to_rgb(samples, _tiff_floats(tags.get(318)), bps)
    else:
        img = _tiff_rgb(samples, photo, bps, extra, tags.get(320), path,
                        planar)
    orientation = tag(274, 1)
    if orientation > 4 and width != height:
        raise ValueError(f"{path}: TIFF orientation {orientation} (tag 274) "
                         f"of a non-square image: cv2 fails on it")
    return _apply_orientation(img, orientation if 1 <= orientation <= 8
                              else 1)


def _tiff_rgb(px: np.ndarray, photo: int, bps: int, extra, colormap,
              path, planar: int = 1) -> np.ndarray:
    """Decoded samples (H, W, spp) → RGB as libtiff's TIFFRGBAImage gives
    them to OpenCV.  Gray in separate planes with extra samples is read as
    RGB of three equal planes (gtStripSeparate, PickSeparateCase): neither
    cut to the high byte nor inverted for white-is-zero, its alpha the
    second plane."""
    if photo in (0, 1) and planar == 2 and px.shape[2] > 1:
        px = np.concatenate([np.repeat(px[..., :1], 3, 2), px[..., 1:2]], 2)
        return _tiff_rgb(px, 2, bps, extra, colormap, path)
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


def _ycbcr_unit_bytes(rows: int, cols: int, sub) -> int:
    """The bytes of a chunk of subsampled 8-bit YCbCr: one data unit of
    hs · vs luma samples, Cb and Cr for each hs x vs block."""
    hs, vs = sub
    return -(-rows // vs) * -(-cols // hs) * (hs * vs + 2)


def _ycbcr_decoded(rows: int, cols: int, sub, tiled: bool, full: int):
    """(the bytes libtiff decodes of a chunk of subsampled 8-bit YCbCr,
    the row size its predictor works in).  A tile: all of it, in rows of
    TIFFTileRowSize (the tile's width times 3).  A strip: nrowsub ·
    TIFFScanlineSize, where nrowsub is its rows rounded up to the vertical
    subsampling and TIFFScanlineSize a row of sample blocks over the
    vertical subsampling, rounded down (gtStripContig's read size; short
    of the strip where the row of blocks is not a multiple of it, the rest
    of libtiff's buffer zero), in rows of TIFFScanlineSize."""
    hs, vs = sub
    if tiled:
        return full, cols * 3
    scan = -(-cols // hs) * (hs * vs + 2) // vs
    return min(full, -(-rows // vs) * vs * scan), scan


def _ycbcr_units(buf: bytes, rows: int, cols: int, sub, shown: int
                 ) -> np.ndarray:
    """A chunk of subsampled YCbCr data units, ``cols`` wide, of which
    ``shown`` columns lie in the image → (rows, shown, 3) samples, each
    block's Cb and Cr over all its pixels, as libtiff's
    ``putcontig8bitYCbCrXYtile`` routines read them: each row of blocks
    the shown blocks, then a skip of the (cols - shown) // hs blocks left
    (gtTileContig's fromskew), which the 4x4 routine counts at 10 bytes a
    block (``(fromskew / 4) * (4 * 2 + 2)``), not 18."""
    hs, vs = sub
    unit = hs * vs + 2
    by, bx = -(-rows // vs), -(-shown // hs)
    skip = (cols - shown) // hs * (10 if sub == (4, 4) else unit)
    at = np.arange(by)[:, None] * (bx * unit + skip) + np.arange(bx * unit)
    units = np.frombuffer(buf, np.uint8)[at].reshape(by, bx, unit)
    y = units[..., :hs * vs].reshape(by, bx, vs, hs).transpose(
        0, 2, 1, 3).reshape(by * vs, bx * hs)
    chroma = np.repeat(np.repeat(units[..., hs * vs:], vs, 0), hs, 1)
    return np.dstack([y[..., None], chroma])[:rows, :shown]


def _tiff_floats(values):
    """A RATIONAL tag's values as libtiff reads them into floats (each
    numerator over its denominator in double, then float; 0 over 0 is
    0), or None where the tag is absent."""
    if values is None:
        return None
    out = []
    for num, den in zip(values[::2], values[1::2]):
        out.append(np.float32(num / den if den else 0.0))
    return out


def _fix16(x: np.float32) -> int:
    """libtiff's FIX: a float times 2^16 (in float), plus 0.5 in double,
    truncated."""
    return int(float(np.float32(x) * np.float32(65536)) + 0.5)


def _code2v(c, rb, rw, cr) -> np.ndarray:
    """libtiff's Code2V: (c - (int) RB) · CR / (RW - RB) in float, as
    int32 after the clamp to ±4096 (CLAMPw)."""
    f32 = np.float32
    span = f32(rw) - f32(rb)
    v = (np.asarray(c, np.int64) - int(f32(rb))).astype(np.float32) * \
        f32(cr) / (span if span != 0 else f32(1))
    v = np.where(v < f32(-4096), f32(-4096), np.where(v > f32(4096),
                                                      f32(4096), v))
    return np.trunc(v).astype(np.int64)


def tiff_ycbcr_tables(luma=None, ref_bw=None) -> dict:
    """The fixed-point tables of libtiff 4.7.1's ``TIFFYCbCrToRGBInit`` for
    YCbCrCoefficients ``luma`` (tag 529, default 0.299, 0.587, 0.114) and
    ReferenceBlackWhite ``ref_bw`` (tag 532, default 0, 255, 128, 255, 128,
    255): ``Y_tab``, ``Cr_r_tab``, ``Cb_b_tab``, ``Cr_g_tab`` and
    ``Cb_g_tab``, each indexed by the 8-bit sample."""
    f32 = np.float32
    lr, lg, lb = (f32(x) for x in (luma or (0.299, 0.587, 0.114)))
    rbw = [f32(x) for x in (ref_bw or (0, 255, 128, 255, 128, 255))]

    def clamp2(f):
        return min(max(f, f32(0)), f32(2))
    f1 = f32(2) - f32(2) * lr
    f2 = lr * f1 / lg
    f3 = f32(2) - f32(2) * lb
    f4 = lb * f3 / lg
    d1, d2 = _fix16(clamp2(f1)), -_fix16(clamp2(f2))
    d3, d4 = _fix16(clamp2(f3)), -_fix16(clamp2(f4))
    x = np.arange(256) - 128
    cr = _code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127)
    cb = _code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127)
    half = 1 << 15
    return dict(Y_tab=_code2v(x + 128, rbw[0], rbw[1], 255),
                Cr_r_tab=(d1 * cr + half) >> 16,
                Cb_b_tab=(d3 * cb + half) >> 16,
                Cr_g_tab=d2 * cr, Cb_g_tab=d4 * cb + half)


def tiff_ycbcr_to_rgb(px: np.ndarray, luma=None, ref_bw=None) -> np.ndarray:
    """8-bit YCbCr samples (H, W, 3), unsubsampled, → RGB as libtiff's
    RGBA interface gives them to OpenCV (``putcontig8bitYCbCr11tile``:
    ``TIFFYCbCrtoRGB`` over ``tiff_ycbcr_tables``)."""
    t = tiff_ycbcr_tables(luma, ref_bw)
    y, cb, cr = (px[..., k].astype(np.int64) for k in range(3))
    yv = t["Y_tab"][y]
    rgb = np.stack([yv + t["Cr_r_tab"][cr],
                    yv + ((t["Cb_g_tab"][cb] + t["Cr_g_tab"][cr]) >> 16),
                    yv + t["Cb_b_tab"][cb]], -1)
    return np.clip(rgb, 0, 255).astype(np.uint8)


# libtiff's display_sRGB (tif_getimage.c): the XYZ → RGB matrix (light
# output 100 at reference white, 1 for a black pixel, gamma 2.4); its
# tables run over 1500 steps
_SRGB_MATRIX = ((3.2410, -1.5374, -0.4986), (-0.9692, 1.8760, 0.0416),
                (0.0556, -0.2040, 1.0570))
_CIELAB_RANGE = 1500
_CIELAB_TABLE = None


def _cielab_table() -> np.ndarray:
    """``TIFFCIELabToRGBInit``'s Yr2r (the same for the three guns of
    display_sRGB): 255 · (i / 1500)^(1 / 2.4), the power in double, cast to
    float, times 255 in float."""
    global _CIELAB_TABLE
    if _CIELAB_TABLE is None:
        import math
        gamma = 1.0 / float(np.float32(2.4))
        _CIELAB_TABLE = np.array(
            [np.float32(255) * np.float32(math.pow(i / _CIELAB_RANGE, gamma))
             for i in range(_CIELAB_RANGE + 1)], np.float32)
    return _CIELAB_TABLE


def tiff_cielab_to_rgb(px: np.ndarray, white=None, bps: int = 8
                       ) -> np.ndarray:
    """CIELab samples (H, W, 3: L unsigned, a and b signed) of ``bps`` 8 or
    16 bits → RGB as libtiff 4.7.1's RGBA interface gives them to OpenCV
    (``putcontig8bitCIELab8``, ``putcontig8bitCIELab16``):
    ``TIFFCIELab16ToXYZ`` on L, a and b (8 bits: through
    ``TIFFCIELabToXYZ``, on L · 257, a · 256, b · 256) against the white
    point of tag 318 (default D50), then ``TIFFXYZToRGB`` with
    display_sRGB's matrix, clip and gamma table, all in float."""
    f32 = np.float32
    if white is None:   # libtiff's default: D50 as chromaticities
        x0, y0, z0 = f32(96.4250), f32(100.0), f32(82.4680)
        white = (x0 / (x0 + y0 + z0), y0 / (x0 + y0 + z0))
    wx, wy = f32(white[0]), f32(white[1])
    ref_y = f32(100)
    ref_x = wx / wy * ref_y
    ref_z = (f32(1) - wx - wy) / wy * ref_y
    if bps == 16:
        lum = px[..., 0].astype(np.float32)
        a, b = (px[..., k].astype(np.int16).astype(np.float32)
                for k in (1, 2))
    else:
        lum = (px[..., 0].astype(np.int64) * 257).astype(np.float32)
        a, b = ((px[..., k].astype(np.int8).astype(np.int64) * 256).astype(
            np.float32) for k in (1, 2))
    L = lum * f32(100) / f32(65535)
    low = L < f32(8.856)
    y_low = L * ref_y / f32(903.292)
    cby = np.where(low, f32(7.787) * (y_low / ref_y) + f32(16) / f32(116),
                   (L + f32(16)) / f32(116))
    Y = np.where(low, y_low, ref_y * cby * cby * cby)

    def cube(t, ref):
        return np.where(t < f32(0.2069), ref * (t - f32(0.13793)) / f32(7.787),
                        ref * t * t * t)
    X = cube(a / f32(256) / f32(500) + cby, ref_x)
    Z = cube(cby - b / f32(256) / f32(200), ref_z)
    table = _cielab_table()
    # the light output runs from 1 (a black pixel's residual) to 100
    step = (f32(100) - f32(1)) / f32(_CIELAB_RANGE)
    out = []
    for row in _SRGB_MATRIX:
        m = [f32(v) for v in row]
        lum_c = m[0] * X + m[1] * Y + m[2] * Z
        lum_c = np.minimum(np.maximum(lum_c, f32(1)), f32(100))
        i = np.minimum(((lum_c - f32(1)) / step).astype(np.int64),
                       _CIELAB_RANGE)
        v = table[i]
        out.append(np.minimum((v + f32(0.5)).astype(np.int64), 255))
    return np.stack(out, -1).astype(np.uint8)


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
    """The codec's refusal: OpenJPEG's reason, or an allocation past the
    port's limits (its message starts ``limit: ``)."""
    msg = err.value.decode(errors="replace")
    if msg.startswith("limit: "):
        return RuntimeError(f"{path}: a JPEG 2000 codestream with {msg[7:]}"
                            f", past what the port allocates")
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
    """A JPEG 2000 file (JP2, JPH or a raw codestream) → (H, W, 3) uint8
    RGB, bit for bit what ``cv2.imread(path)[..., ::-1]`` gives (cv2 5.0.0
    with OpenJPEG 2.5.3; the port's own decoder in
    ``csrc/jpeg2000_codec.cpp``, the JP2 boxes parsed here): every
    progression, code-block style and transform of Part 1, tiles and
    tile-parts, layers cut by a rate, ROI, palettes (pclr/cmap) and channel
    definitions (cdef); HT code-blocks and the CAP and CPF markers of Part
    15; Part 2's CBD, MCT, MCC and MCO as OpenJPEG applies them; a gray
    image copied into three channels, sYCC through cv2's YUV → BGR, samples
    past 8 bits cut to their top 8, alpha dropped.  Raises ``RuntimeError``
    naming the file where cv2 returns None (a file cut short, signed or
    offset or subsampled components, a raw gray codestream, 2 or more than
    4 components, fewer than 8 bits, CMYK or e-sYCC, a corrupt box or
    codestream, what OpenJPEG refuses of HT and Part 2)."""
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
# libyuv 1924's YuvConstants that libavif 1.4.2 converts with, by kind and
# full range: (ub, ug, vg, vr, yg, yb), the U and V weights in 1/64 and the
# Y gain and bias of its 6-bit fixed point (kYuvJPEGConstants,
# kYuvI601Constants, kYuvF709Constants, kYuvH709Constants,
# kYuvV2020Constants, kYuv2020Constants)
_LIBYUV_CONSTANTS = {
    ("601", True): (113, 22, 46, 90, 16320, 32),
    ("601", False): (128, 25, 52, 102, 18997, -1160),
    ("709", True): (119, 12, 30, 101, 16320, 32),
    ("709", False): (128, 14, 34, 115, 18997, -1160),
    ("2020", True): (120, 11, 37, 94, 16320, 32),
    ("2020", False): (128, 12, 42, 107, 19003, -1160),
}
# libavif's choice of table by matrix coefficients, and for chroma-derived
# NCL (12) by colour primaries; other matrices take libavif's own path
_LIBYUV_MATRICES = {1: "709", 2: "601", 5: "601", 6: "601", 9: "2020"}
_LIBYUV_PRIMARIES = {1: "709", 2: "709", 5: "601", 6: "601", 9: "2020"}
# libavif 1.4.2's avifColorPrimariesTables (rX rY gX gY bX bY wX wY, as
# float literals) and matrixCoefficientsTables (kr kb): what its own
# conversion derives its coefficients from (avifCalcYUVCoefficients)
_AVIF_PRIMARIES = {
    1: "0.64 0.33 0.3 0.6 0.15 0.06 0.3127 0.329",
    4: "0.67 0.33 0.21 0.71 0.14 0.08 0.31 0.316",
    5: "0.64 0.33 0.29 0.6 0.15 0.06 0.3127 0.329",
    6: "0.63 0.34 0.31 0.595 0.155 0.07 0.3127 0.329",
    7: "0.63 0.34 0.31 0.595 0.155 0.07 0.3127 0.329",
    8: "0.681 0.319 0.243 0.692 0.145 0.049 0.31 0.316",
    9: "0.708 0.292 0.17 0.797 0.131 0.046 0.3127 0.329",
    10: "1 0 0 1 0 0 0.3333 0.3333",
    11: "0.68 0.32 0.265 0.69 0.15 0.06 0.314 0.351",
    12: "0.68 0.32 0.265 0.69 0.15 0.06 0.3127 0.329",
    22: "0.63 0.34 0.295 0.605 0.155 0.077 0.3127 0.329"}
_AVIF_KR_KB = {1: "0.2126 0.0722", 4: "0.3 0.11", 5: "0.299 0.114",
               6: "0.299 0.114", 7: "0.212 0.087", 9: "0.2627 0.0593"}
# an item's first colr of each kind, as libavif keeps them apart
_NCLX, _ICC = (b"colr", b"nclx"), (b"colr", b"ICC")
# transformative properties, which must be marked essential (MIAF 7.3.9)
_AVIF_TRANSFORMS = (b"clap", b"irot", b"imir")
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
    i = ctypes.c_int
    lib.av1_lr_wiener.restype = lib.av1_lr_sgr.restype = None
    lib.av1_lr_wiener.argtypes = [vp, i, vp, i, i, i, vp, i]
    lib.av1_lr_sgr.argtypes = [vp, i, vp, i, i, i, i, vp, i]
    lib.av1_inter_convolve.restype = None
    lib.av1_inter_convolve.argtypes = [vp, i, vp, i, i, i, i, i, i, i, i, i]
    for name, args in (
            ("av1_warp", [vp, vp, vp] + [i] * 3 + [vp] + [i] * 9),
            ("av1_shear", [vp, vp]),
            ("av1_projection", [i, vp, vp] + [i] * 6 + [vp, vp]),
            ("av1_select_samples", [i, i, vp, vp, i, i, i]),
            ("av1_mv_projection", [i] * 4 + [vp]),
            ("av1_obmc_blend", [vp, i, vp, i, i, i, i]),
            ("av1_interintra_blend", [vp, i, vp, i] + [i] * 7),
            ("av1_wedge_mask", [i, i, i, vp]),
            ("av1_refsubexpfin", [vp, ll, i, i, vp]),
            ("av1_comp_average", [vp, i, vp, vp] + [i] * 6),
            ("av1_comp_mask_blend", [vp, i, vp, vp, i, vp] + [i] * 6),
            ("av1_diffwtd_mask", [vp, i, vp, vp] + [i] * 4),
            ("av1_dist_weights", [i] * 4 + [vp]),
            ("av1_ref_contexts", [i] * 10 + [vp]),
            ("av1_scale_convolve", [vp, i, vp] + [i] * 11),
            ("av1_scale_factors", [i] * 4 + [vp]),
            ("av1_scaled_position", [i, i])):
        getattr(lib, name).argtypes = args
    lib.av1_scale_convolve.restype = None
    lib.av1_scale_factors.restype = lib.av1_scaled_position.restype = i
    lib.av1_warp.restype = lib.av1_obmc_blend.restype = None
    lib.av1_mv_projection.restype = lib.av1_wedge_mask.restype = None
    lib.av1_interintra_blend.restype = None
    for name in ("av1_comp_average", "av1_comp_mask_blend",
                 "av1_diffwtd_mask", "av1_dist_weights", "av1_ref_contexts"):
        getattr(lib, name).restype = None
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
    1.4.2 parses them: ``ftyp``, ``meta`` (``hdlr``, ``pitm``, ``iloc``,
    ``iinf``, ``iprp``, ``iref``, ``idat``), ``moov`` (an image sequence's
    tracks) and ``mdat``.  ``source`` is what libavif's
    ``AVIF_DECODER_SOURCE_AUTO`` reads: ``"item"`` (the primary item) or
    ``"tracks"`` (the colour track's first sample)."""

    def __init__(self, data: bytes, path):
        self.data, self.path = data, path
        self.items = {}       # id -> dict(type, extents, method, assoc)
        self.props = []       # ipco's boxes: (type, payload)
        self.primary = None
        self.idat = b""
        self.refs = []        # (type, from, [to])
        self.alpha = None     # the alpha item's id, once found
        self.prem_by = None   # the item the primary item's prem names
        self.tracks = []      # moov's trak boxes, as parse_trak reads them
        self.source = "item"
        self.cut = None       # a top-level box cut at the end of the file

    def bad(self, why: str) -> RuntimeError:
        return RuntimeError(f"{self.path}: an AVIF file cv2 does not read: "
                            f"{why}")

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
            if top and kind not in (b"meta", b"moov") and \
                    pos + size > end >= pos + hdr:
                size = end - pos
                self.cut = kind
            if size < hdr or pos + size > end:
                raise self.bad(f"a {kind.decode('latin-1')!r} box past the "
                               f"end of its parent")
            yield kind, pos + hdr, pos + size
            pos += size

    def parse(self):
        """libavif's ``avifParse``: ``ftyp`` first; then ``meta`` where the
        brands hold ``avif`` and ``moov`` where they hold ``avis``, the
        parse ending once it has what the brands need (a box it skips may
        not run past the end before then); then the source by the major
        brand: ``avis`` the tracks, ``avif`` the item, any other the tracks
        where ``moov`` held any."""
        d = self.data
        seen_ftyp = seen_meta = seen_moov = False
        needs_meta = needs_moov = False
        major = None
        for kind, s, e in self.boxes(0, len(d), top=True):
            if not seen_ftyp:
                if kind != b"ftyp":
                    raise self.bad("the first box is not ftyp")
                seen_ftyp = True
                major = d[s:s + 4]
                brands = [major] + [d[i:i + 4] for i in range(s + 8, e - 3, 4)]
                if not any(b in AVIF_BRANDS for b in brands):
                    raise self.bad("no avif brand in ftyp")
                needs_meta = b"avif" in brands
                needs_moov = b"avis" in brands
            elif kind == b"meta":
                if seen_meta:
                    raise self.bad("a second meta box")
                self.parse_meta(s, e)
                seen_meta = True
            elif kind == b"moov":
                if seen_moov:
                    raise self.bad("a second moov box")
                self.parse_moov(s, e)
                seen_moov = True
            elif needs_moov and not seen_moov and self.cut == kind:
                # a box libavif skips runs past the end before moov
                raise self.bad(f"a {kind.decode('latin-1')!r} box past the "
                               f"end of the file before moov")
            if (not needs_meta or seen_meta) and (not needs_moov or seen_moov):
                break                 # libavif reads no further
        if needs_moov and not seen_moov:
            raise self.bad("an avis file without moov")
        if needs_meta and not seen_meta:
            raise self.bad("no meta box")
        if major == b"avis" or (major != b"avif" and self.tracks):
            self.source = "tracks"
        elif not seen_meta:
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

    # ------------------------------------------------ an image sequence

    def parse_moov(self, s: int, e: int):
        """``moov`` as libavif's ``avifParseMovieBox``: an ``mvhd`` of
        version 0 or 1, and each ``trak``."""
        d = self.data
        seen_mvhd = False
        for kind, bs, be in self.boxes(s, e):
            if kind == b"mvhd":
                if be == bs or d[bs] > 1:
                    raise self.bad("an mvhd box of an unknown version")
                seen_mvhd = True
            elif kind == b"trak":
                self.parse_trak(bs, be)
        if not seen_mvhd:
            raise self.bad("a moov box without mvhd")

    def parse_trak(self, s: int, e: int):
        """A ``trak`` as libavif's ``avifParseTrackBox``: one ``tkhd`` (its
        id and its size, 16.16 fixed point, neither side 0), ``mdia``,
        ``tref`` (``auxl`` and ``prem``: the first track each names),
        ``edts`` and a ``meta`` parsed with an item file's rules."""
        d = self.data
        track = dict(id=None, aux_for=0, prem_by=0, stbl=None)
        seen_edts = False
        for kind, bs, be in self.boxes(s, e):
            if kind == b"tkhd":
                if track["id"] is not None:
                    raise self.bad("a trak box with two tkhd boxes")
                rd = self.reader(bs, be)
                version = rd(1)
                rd(3)
                if version > 1:
                    raise self.bad(f"a tkhd box of version {version}")
                n = 8 if version == 1 else 4
                rd(n)
                rd(n)
                track["id"] = rd(4)
                rd(4)
                track["duration"] = rd(n)
                rd(52)
                track["width"], track["height"] = rd(4) >> 16, rd(4) >> 16
                if not track["width"] or not track["height"]:
                    raise self.bad("a track of no size")
                if track["width"] * track["height"] > 16384 * 16384 or \
                        max(track["width"], track["height"]) > 32768:
                    raise self.bad("a track larger than libavif's limits")
            elif kind == b"mdia":
                self.parse_mdia(track, bs, be)
            elif kind == b"tref":
                for rkind, rs, re_ in self.boxes(bs, be):
                    if rkind in (b"auxl", b"prem"):
                        if re_ - rs < 4:
                            raise self.bad("a track reference cut short")
                        track["aux_for" if rkind == b"auxl" else "prem_by"] = \
                            int.from_bytes(d[rs:rs + 4], "big")
            elif kind == b"edts":
                if seen_edts:
                    raise self.bad("a trak box with two edts boxes")
                seen_edts = True
                repeating = self.parse_edts(bs, be)
            elif kind == b"meta":
                _Heif(d, self.path).parse_meta(bs, be)
        if track["id"] is None:
            raise self.bad("a trak box without tkhd")
        if seen_edts and repeating and track["duration"] == 0:
            # libavif counts the repetitions over the track's duration
            raise self.bad("a repeating track of duration 0")
        self.tracks.append(track)

    def parse_edts(self, s: int, e: int):
        """``edts`` holds one ``elst``; a repeating one (flag 1) one entry
        whose segment_duration is not 0.  → whether it repeats."""
        seen = repeating = False
        for kind, bs, be in self.boxes(s, e):
            if kind != b"elst":
                continue
            if seen:
                raise self.bad("an edts box with two elst boxes")
            seen = True
            rd = self.reader(bs, be)
            version, flags = rd(1), rd(3)
            repeating = bool(flags & 1)
            if not repeating:
                continue
            if rd(4) != 1:
                raise self.bad("a repeating elst of other than one entry")
            if version > 1:
                raise self.bad(f"an elst box of version {version}")
            if not rd(8 if version == 1 else 4):
                raise self.bad("an elst segment_duration of 0")
        if not seen:
            raise self.bad("an edts box without elst")
        return repeating

    def parse_mdia(self, track: dict, s: int, e: int):
        """``mdia``: ``mdhd`` of version 0 or 1, ``minf``'s ``stbl``."""
        d = self.data
        for kind, bs, be in self.boxes(s, e):
            if kind == b"mdhd":
                if be == bs or d[bs] > 1:
                    raise self.bad("an mdhd box of an unknown version")
            elif kind == b"minf":
                for mkind, ms, me in self.boxes(bs, be):
                    if mkind == b"stbl":
                        if track["stbl"] is not None:
                            raise self.bad("a track with two stbl boxes")
                        track["stbl"] = self.parse_stbl(ms, me)

    def parse_stbl(self, s: int, e: int) -> dict:
        """The sample table as libavif's ``avifParseSampleTableBox`` reads
        it (every full box of version 0): ``stco``/``co64`` chunk offsets,
        ``stsc`` (first chunks from 1, increasing), ``stsz``, ``stss``,
        ``stts`` and ``stsd``'s sample entries with an ``av01`` entry's
        properties after its 78-byte VisualSampleEntry."""
        d = self.data
        t = dict(chunks=[], stsc=[], size=0, sizes=[], entries=[])
        for kind, bs, be in self.boxes(s, e):
            if kind not in (b"stco", b"co64", b"stsc", b"stsz", b"stss",
                            b"stts", b"stsd"):
                continue
            rd = self.reader(bs, be)
            if rd(1) != 0:
                raise self.bad(f"a {kind.decode('latin-1')} box of an "
                               f"unknown version")
            rd(3)
            if kind in (b"stco", b"co64"):
                n = 8 if kind == b"co64" else 4
                t["chunks"] += [rd(n) for _ in range(rd(4))]
            elif kind == b"stsc":
                for i in range(rd(4)):
                    first, per, _ = rd(4), rd(4), rd(4)
                    if (i == 0 and first != 1) or \
                            (i and first <= t["stsc"][-1][0]):
                        raise self.bad("stsc's first chunks do not start at "
                                       "1 and increase")
                    t["stsc"].append((first, per))
            elif kind == b"stsz":
                t["size"], count = rd(4), rd(4)
                if not t["size"]:
                    t["sizes"] = [rd(4) for _ in range(count)]
            elif kind == b"stss":       # sample numbers, each read
                rd(4 * rd(4))
            elif kind == b"stts":       # (count, delta) pairs, each read
                rd(8 * rd(4))
            else:
                pos = bs + 8
                count = int.from_bytes(d[bs + 4:bs + 8], "big")
                entries = list(self.boxes(pos, be))
                if len(entries) < count:
                    raise self.bad(f"stsd counts {count} entries and holds "
                                   f"{len(entries)}")
                for ekind, es, ee in entries[:count]:
                    props = None
                    if ekind == b"av01":
                        if ee - es < 78:
                            raise self.bad("an av01 sample entry cut short")
                        props = {}
                        for pkind, ps, pe in self.boxes(es + 78, ee):
                            self.check_property(pkind, d[ps:pe])
                            _avif_add_property(props, pkind, d[ps:pe])
                    t["entries"].append((ekind, props))
        return t

    def samples(self, track: dict):
        """The (offset, size) of each sample of a track, as libavif's
        ``avifCodecDecodeInputFillFromSampleTable`` lays them out: chunk by
        chunk, each chunk's count the last ``stsc`` entry whose first chunk
        is at most its number (0 refused), sizes from ``stsz``; a sample
        past the end of the file or of size 0 refused.  libavif takes the
        first sample as a sync sample whatever ``stss`` says."""
        t = track["stbl"]
        out = []
        for k, off in enumerate(t["chunks"]):
            per = 0
            for first, n in reversed(t["stsc"]):
                if first <= k + 1:
                    per = n
                    break
            if not per:
                raise self.bad("a chunk of no samples")
            for _ in range(per):
                if t["size"]:
                    size = t["size"]
                elif len(out) < len(t["sizes"]):
                    size = t["sizes"][len(out)]
                else:
                    raise self.bad("a sample table cut short")
                if off + size > len(self.data):
                    raise self.bad("a sample past the end of the file")
                out.append((off, size))
                off += size
        if any(size == 0 for _, size in out):
            raise self.bad("a sample of size 0")
        return out

    def usable(self, track: dict) -> bool:
        """A track libavif's decoder takes: a sample table with chunks and
        an ``av01`` sample entry."""
        t = track["stbl"]
        return bool(track["id"] and t and t["chunks"] and
                    any(k == b"av01" for k, _ in t["entries"]))

    def track_image(self, track: dict):
        """(first sample's OBUs, its av01 entry's properties) of a track."""
        props = next(p for k, p in track["stbl"]["entries"] if k == b"av01")
        off, size = self.samples(track)[0]
        return self.data[off:off + size], props

    def colour_track(self):
        """The colour track (libavif's: the first usable track that is not
        auxiliary) and its alpha track (the first usable track whose
        ``auxl`` names it) or None, each with every sample laid out; the
        alpha is premultiplied where the colour track's ``prem`` names
        it."""
        colour = next((t for t in self.tracks if self.usable(t) and
                       not t["aux_for"]), None)
        if colour is None:
            raise self.bad("no AV1 colour track")
        alpha = next((t for t in self.tracks if self.usable(t) and
                      t["aux_for"] == colour["id"]), None)
        # libavif lays out every sample of both tracks before decoding
        for t in (colour, alpha):
            if t is not None:
                self.samples(t)
        return colour, alpha

    def signature_check(self, grids):
        """Raises where OpenCV's own signature test refuses the file:
        cv2's ``AvifDecoder::checkSignature`` runs libavif's
        ``avifDecoderParse`` over the file's first 500 bytes alone and takes
        the file if that parse succeeds or runs out of data.  It fails
        where a top-level box header before ``meta`` is cut by the 500th
        byte or lies past it (a box before ``meta`` running past it), and,
        where the whole ``meta`` lies in those bytes, where the payload of
        a grid item libavif reads then (``grids``: the primary and alpha
        grid items) begins past them.  An image sequence's parse goes on to
        ``moov`` as the brands ask (Pillow's ``moov`` runs past the 500th
        byte, and the parse runs out of data)."""
        d = self.data[:500]
        n = len(d)
        pos = 0
        needs, seen = set(), set()
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
            if kind in (b"ftyp", b"meta", b"moov") and (size == 0 or
                                                        pos + size > n):
                return                    # libavif runs out of data
            if pos == 0:
                brands = [d[i:i + 4] for i in range(8, size - 3, 4)]
                needs = {b"meta"} if b"avif" in brands else set()
                needs |= {b"moov"} if b"avis" in brands else set()
            elif kind in (b"meta", b"moov"):
                seen.add(kind)
                if needs <= seen:
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
                # libavif reads an item's data from the file (0) or idat
                # (1) alone: construction method 2 (from another item)
                # and the reserved ones are refused
                raise self.bad(f"an iloc construction method {method}")
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

    def check_property(self, kind: bytes, payload: bytes):
        """libavif's parse of a property box, which refuses the file
        whether or not an item uses the box: the versions it knows, colr's
        nclx (its reserved bits 0), irot's and imir's reserved bits (0) and
        clap's eight fields."""
        name = kind.decode("latin-1")
        if kind in _AVIF_VERSIONS and (not payload or payload[0] not in
                                       _AVIF_VERSIONS[kind]):
            raise self.bad(f"a {name} box of an unknown version")
        if kind == b"colr" and payload[:4] == b"nclx" and (
                len(payload) < 11 or payload[10] & 0x7F):
            raise self.bad("an nclx colr cut short or with reserved bits "
                           "set")
        if kind in (b"irot", b"imir") and (not payload or payload[0] & (
                0xFC if kind == b"irot" else 0xFE)):
            raise self.bad(f"an {name} box cut short or with reserved bits "
                           f"set")
        if kind == b"clap" and len(payload) < 32:
            raise self.bad("a clap box cut short")

    def parse_iprp(self, s: int, e: int):
        d = self.data
        for kind, bs, be in self.boxes(s, e):
            if kind == b"ipco":
                self.props = [(k, d[ps:pe]) for k, ps, pe
                              in self.boxes(bs, be)]
                for k, payload in self.props:
                    self.check_property(k, payload)
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
        # libavif refuses a transformative property not marked essential,
        # whichever item it is associated with
        for item in self.items.values():
            for essential, idx in item.get("assoc", ()):
                kind = self.props[idx - 1][0] if 0 < idx <= len(
                    self.props) else None
                if kind in _AVIF_TRANSFORMS and not essential:
                    raise self.bad(f"a transformative property "
                                   f"{kind.decode('latin-1')!r} not marked "
                                   f"essential")

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
        # its transforms (irot, imir, clap) are parsed and not applied: cv2
        # reads the image as coded
        props = self.properties(item)
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
        """An item's properties by type (the first of a type; of colr, the
        first nclx and the first ICC), with libavif's checks of their
        associations; with ``skip``, None where libavif skips the item
        instead (an unknown essential property)."""
        props = {}
        for essential, idx in item.get("assoc", []):
            if idx == 0:
                continue
            if idx > len(self.props):
                raise self.bad("a property index past ipco's boxes")
            kind, payload = self.props[idx - 1]
            if kind not in _AVIF_KNOWN_PROPERTIES:
                if essential:
                    if skip:
                        return None
                    raise self.bad(f"an unknown essential property "
                                   f"{kind.decode('latin-1')!r}")
                continue
            _avif_add_property(props, kind, payload)
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
            if dst and kind in (b"auxl", b"thmb", b"prem"):
                targets.setdefault(src, {})[kind] = dst[-1]
        # the colour is premultiplied where the primary item's prem names
        # the alpha item (libavif's premByID)
        self.prem_by = targets.get(self.primary, {}).get(b"prem")
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


def _avif_add_property(props: dict, kind: bytes, payload: bytes):
    """Keeps the first property of each type, and of colr the first nclx
    and the first ICC profile (``prof`` or ``rICC``) apart, as libavif reads
    one colr of each kind: an nclx after an ICC colr still sets the
    colour."""
    if kind == b"colr":
        if payload[:4] == b"nclx":
            props.setdefault(_NCLX, payload)
        elif payload[:4] in (b"prof", b"rICC"):
            props.setdefault(_ICC, payload)
    props.setdefault(kind, payload)


def _avif_cicp(props: dict, info) -> tuple:
    """(colour primaries, matrix, full range) libavif converts with: the
    nclx colr's where the item or track has one, else the AV1 sequence
    header's (``decode_av1``'s info)."""
    colr = props.get(_NCLX)
    if colr is None:
        return info[6], info[8], bool(info[9])
    primaries, _, matrix = struct.unpack_from(">HHH", colr, 4)
    return primaries, matrix, bool(colr[10] >> 7)


def _avif_check_properties(heif: _Heif, props: dict) -> bool:
    """libavif's checks of the properties: av1C's marker and version,
    pixi's channels and depths against av1C's.  → av1C's monochrome flag
    (libavif then gives cv2 a gray image)."""
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


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray, constants,
               depth: int = 8) -> np.ndarray:
    """YUV (chroma at full size) → (H, W, 3) uint8 RGB in libyuv 1924's row
    arithmetic with one of its YuvConstants (``_LIBYUV_CONSTANTS``): Y
    widened to 16 bits (``YuvPixel``: y · 0x0101; ``YuvPixel10`` and
    ``YuvPixel12`` for 10- and 12-bit samples: shifted up, their top bits
    below), times the table's gain >> 16 plus its bias; U and V cut to 8
    bits (saturated) less 128, in 1/64; a 6-bit shift and a clamp."""
    ub, ug, vg, vr, yg, yb = constants
    y = y.astype(np.int64)
    y32 = y * 0x0101 if depth == 8 else \
        (y << (16 - depth)) | (y >> (2 * depth - 16))
    u, v = (np.minimum(c.astype(np.int64) >> (depth - 8), 255) - 128
            for c in (u, v))
    y1 = (y32 * yg >> 16) + yb
    rgb = np.stack([y1 + v * vr, y1 - (u * ug + v * vg), y1 + u * ub], -1)
    return np.clip(rgb >> 6, 0, 255).astype(np.uint8)


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


def avif_coefficients(matrix: int, primaries: int) -> tuple:
    """(kr, kg, kb) float32 as libavif 1.4.2's ``avifCalcYUVCoefficients``
    computes them: its table's kr and kb, for chroma-derived NCL (12) the
    H.273 equations 32-37 on its primaries table (an unknown code takes
    BT.709's), in its float operation order; BT.601's for any other code;
    kg = 1 - kr - kb."""
    f = np.float32
    if matrix == 12:
        rx, ry, gx, gy, bx, by, wx, wy = (f(v) for v in _AVIF_PRIMARIES.get(
            primaries, _AVIF_PRIMARIES[1]).split())
        rz, gz, bz, wz = (f(1) - (x + y) for x, y in ((rx, ry), (gx, gy),
                                                      (bx, by), (wx, wy)))
        den = wy * (rx * (gy * bz - by * gz) + gx * (by * rz - ry * bz) +
                    bx * (ry * gz - gy * rz))
        kr = ry * (wx * (gy * bz - by * gz) + wy * (bx * gz - gx * bz) +
                   wz * (gx * by - bx * gy)) / den
        kb = by * (wx * (ry * gz - gy * rz) + wy * (gx * rz - rx * gz) +
                   wz * (rx * gy - gx * ry)) / den
    else:
        kr, kb = (f(v) for v in _AVIF_KR_KB.get(matrix, "0.299 0.114").split())
    return kr, f(1) - kr - kb, kb


def _avif_lut(depth: int, full: bool, chroma: bool) -> np.ndarray:
    """libavif's unormFloatTableY (or UV): (cp - bias) / range in float32
    for every code point."""
    f = np.float32
    if chroma:
        bias, rng = 1 << (depth - 1), (1 << depth) - 1 if full else \
            224 << (depth - 8)
    else:
        bias, rng = (0, (1 << depth) - 1) if full else \
            (16 << (depth - 8), 219 << (depth - 8))
    return (np.arange(1 << depth, dtype=f) - f(bias)) / f(rng)


def _avif_bilinear(lut: np.ndarray, c: np.ndarray, width: int, height: int,
                   subx: int, suby: int) -> np.ndarray:
    """4:2:0 or 4:2:2 chroma at full size as libavif's
    ``avifImageYUVAnyToRGBAnySlow`` upsamples it: its nearest sample and
    the adjacent column, row and diagonal ones (an edge's repeated),
    weighted 9, 3, 3, 1 / 16 in float32 in its order."""
    f = np.float32
    i = np.arange(width)
    j = np.arange(height)
    ci, cj = i >> subx, j >> suby
    adj_c = np.where((i == 0) | ((i == width - 1) & (i % 2 == 1)), 0,
                     np.where(i % 2 == 1, 1, -1))
    if suby:
        adj_r = np.where((j == 0) | ((j == height - 1) & (j % 2 == 1)), 0,
                         np.where(j % 2 == 1, 1, -1))
    else:
        adj_r = np.zeros_like(j)
    t = lut[c.astype(np.int64)]
    a = t[cj[:, None], ci[None, :]]
    b = t[cj[:, None], (ci + adj_c)[None, :]]
    r = t[(cj + adj_r)[:, None], ci[None, :]]
    d = t[(cj + adj_r)[:, None], (ci + adj_c)[None, :]]
    return a * f(9 / 16) + b * f(3 / 16) + r * f(3 / 16) + d * f(1 / 16)


def libavif_builtin_rgb(planes, depth: int, subx: int, suby: int,
                        matrix: int, primaries: int, full: bool,
                        alpha=None, premultiplied: bool = False
                        ) -> np.ndarray:
    """Decoded planes → (H, W, 3) uint8 RGB as libavif 1.4.2 converts them
    on its own path, where libyuv has no constants for the matrix (FCC,
    SMPTE 240, YCgCo, YCgCo-Re, 15, chroma-derived NCL of other primaries,
    the identity matrix at limited range): the code points through its
    float32 lookup tables (``_avif_lut``); 4:4:4 through its fast
    ``avifImageYUV8ToRGB8Color`` / ``YUV16ToRGB8Color`` (a premultiplied
    colour then divided by libyuv's ``ARGBUnattenuate`` with the alpha cut
    to 8 bits as ``avifReformatAlpha`` cuts it), subsampled chroma, YCgCo
    and the identity matrix through ``avifImageYUVAnyToRGBAnySlow`` (its
    bilinear chroma, and its own float division by a premultiplied
    alpha); a monochrome frame through the luma table alone; each value
    stored as (uint8)(0.5 + c · 255), c clamped to [0, 1].  All in float32
    in libavif's operation order."""
    f = np.float32
    top = (1 << depth) - 1
    y = np.minimum(planes[0].astype(np.int64), top)
    height, width = y.shape
    Y = _avif_lut(depth, full, False)[y]
    mode = {0: "identity", 8: "ycgco", 16: "ycgco_re"}.get(matrix, "yuv")
    # the slow path (it divides by a premultiplied alpha itself)
    slow = mode != "yuv" or (len(planes) == 3 and bool(subx or suby))
    if len(planes) == 1:
        R = G = B = Y
    else:
        # the identity matrix's chroma takes the luma table
        lut = _avif_lut(depth, full, mode != "identity")
        u, v = (np.minimum(p.astype(np.int64), top) for p in planes[1:])
        if subx or suby:
            Cb = _avif_bilinear(lut, u, width, height, subx, suby)
            Cr = _avif_bilinear(lut, v, width, height, subx, suby)
        else:
            Cb, Cr = lut[u], lut[v]
        if mode == "identity":
            G, B, R = Y, Cb, Cr
        elif mode == "ycgco":
            t = Y - Cb
            G, B, R = Y + Cb, t - Cr, t + Cr
        elif mode == "ycgco_re":
            # YCgCo-Re (depth 10 into 8-bit RGB): integer lifting on the
            # rounded chroma, clamped to the RGB range
            cg, co = (np.floor(c * f(top) + f(0.5)).astype(np.int64)
                      for c in (Cb, Cr))              # avifRoundf
            t = y - (cg >> 1)
            G = np.clip(t + cg, 0, 255)
            B = np.clip(t - (co >> 1), 0, 255)
            R = np.clip(B + co, 0, 255)
            G, B, R = (x.astype(f) / f(255) for x in (G, B, R))
        else:
            kr, kg, kb = avif_coefficients(matrix, primaries)
            R = Y + (f(2) * (f(1) - kr)) * Cr
            B = Y + (f(2) * (f(1) - kb)) * Cb
            G = Y - ((f(2) * ((kr * (f(1) - kr) * Cr) +
                              (kb * (f(1) - kb) * Cb))) / kg)
    rgb = np.clip(np.stack([R, G, B], -1), f(0), f(1)).astype(f)
    if premultiplied and slow:
        a = np.clip(np.minimum(alpha.astype(np.int64), top).astype(f) /
                    f(top), f(0), f(1))[..., None]
        with np.errstate(divide="ignore", invalid="ignore"):
            rgb = np.where(a == 0, f(0), np.where(
                a < 1, np.minimum(rgb / a, f(1)), rgb)).astype(f)
        premultiplied = False
    out = (f(0.5) + rgb * f(255)).astype(np.uint8)
    if premultiplied:
        out = unattenuate(out, _alpha_to_8(alpha, depth) if depth > 8
                          else alpha)
    return out


def _avif_matrix(matrix: int, primaries: int, full: bool, depth: int,
                 subx: int, suby: int, path):
    """libavif 1.4.2's verdict on a colour image's matrix coefficients:
    libyuv's constants where libavif converts through libyuv, None for
    the identity matrix at full range (GBR, libavif's own rounded path),
    "libavif" where libavif converts on its own built-in path
    (``libavif_builtin_rgb``: FCC, SMPTE 240, YCgCo, 15, YCgCo-Re,
    chroma-derived NCL of other primaries, the identity matrix at limited
    range); raises where cv2 gets no image (reserved and unsupported
    codes, the identity matrix with subsampled chroma, YCgCo at limited
    range, YCgCo-Re other than full-range 10-bit)."""
    refused = matrix in (3, 10, 11, 13, 14) or matrix > 16 or (
        matrix == 16 and (not full or depth != 10)) or (
        matrix == 8 and not full) or (matrix == 0 and (subx or suby))
    if refused:
        why = "the identity matrix with subsampled chroma" if matrix == 0 \
            else f"matrix coefficients {matrix} at {depth} bits, " \
                 f"{'full' if full else 'limited'} range"
        raise RuntimeError(f"{path}: an AVIF file cv2 does not read: {why}")
    if matrix == 0 and full:
        return None
    kind = _LIBYUV_PRIMARIES.get(primaries) if matrix == 12 else \
        _LIBYUV_MATRICES.get(matrix)
    if kind is None:
        return "libavif"
    return _LIBYUV_CONSTANTS[kind, full]


# ------------------------------------------------- libyuv 1924's scaler
# What libavif 1.4.2's avifImageScale runs: ScalePlane (8-bit samples) or
# ScalePlane_12 / ScalePlane_16 (its own; the same values), box filter.
# Each path is ported from libyuv's C rows, with the x86 rows where those
# round otherwise (the 8-bit column filter's 7-bit fraction, the 3/4 and
# 3/8 rows that average two rows first), row by row in libyuv's order.

_K_BOX, _K_BILINEAR, _K_LINEAR, _K_NONE = 3, 2, 1, 0


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fixed_div(num: int, div: int) -> int:
    return _cdiv(num << 16, div)


def _fixed_div1(num: int, div: int) -> int:
    return _cdiv((num << 16) - 0x00010001, div - 1)


def _centerstart(dx: int, s: int) -> int:
    return -((-dx >> 1) + s) if dx < 0 else (dx >> 1) + s


def _scale_filter_reduce(sw: int, sh: int, dw: int, dh: int, f: int) -> int:
    if f == _K_BOX and (dw * 2 >= sw or dh * 2 >= sh):
        f = _K_BILINEAR
    if f == _K_BILINEAR:
        if sh == 1 or dh == sh or dh * 3 == sh:
            f = _K_LINEAR
        if sw == 1:
            f = _K_NONE
    if f == _K_LINEAR and (sw == 1 or dw == sw or dw * 3 == sw):
        f = _K_NONE
    return f


def _scale_slope(sw: int, sh: int, dw: int, dh: int, f: int):
    x = y = dx = dy = 0
    if dw == 1 and sw >= 32768:
        dw = sw
    if dh == 1 and sh >= 32768:
        dh = sh
    if f == _K_BOX:
        dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
    elif f in (_K_BILINEAR, _K_LINEAR):
        if dw <= sw:
            dx = _fixed_div(sw, dw)
            x = _centerstart(dx, -32768)
        elif sw > 1 and dw > 1:
            dx = _fixed_div1(sw, dw)
        if f == _K_LINEAR:
            dy = _fixed_div(sh, dh)
            y = dy >> 1
        elif dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _centerstart(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
    else:
        dx, dy = _fixed_div(sw, dw), _fixed_div(sh, dh)
        x, y = _centerstart(dx, 0), _centerstart(dy, 0)
    return x, y, dx, dy


def _interpolate_row(a: np.ndarray, b: np.ndarray, f: int) -> np.ndarray:
    """InterpolateRow: a · (256 - f) + b · f, rounded, in 8 bits of f."""
    if f == 0:
        return a.copy()
    return (a * (256 - f) + b * f + 128) >> 8


def _filter_cols(row: np.ndarray, dw: int, x: int, dx: int,
                 hbd: bool) -> np.ndarray:
    """ScaleFilterCols: each output blends two samples by its position's
    fraction, 7 bits of it in the 8-bit x86 row (ScaleFilterCols_SSSE3),
    16 in the C rows of 16-bit samples (ScaleFilterCols_16_C)."""
    xs = x + dx * np.arange(dw, dtype=np.int64)
    xi = xs >> 16
    a = row[xi]
    b = row[np.minimum(xi + 1, len(row) - 1)]
    if hbd:
        return a + ((((xs & 0xFFFF) * (b - a)) + 0x8000) >> 16)
    f = (xs >> 9) & 0x7F
    return (a * (128 - f) + b * f + 64) >> 7


def _scale_cols(row: np.ndarray, dw: int, x: int, dx: int) -> np.ndarray:
    return row[(x + dx * np.arange(dw, dtype=np.int64)) >> 16]


def _down34_row(s: np.ndarray, t: np.ndarray, dw: int, kind: int,
                hbd: bool) -> np.ndarray:
    """ScaleRowDown34_0_Box (kind 0: rows 3 : 1) or _1_Box (kind 1: 1 : 1)
    of rows s and t (t is s for a row filtered alone): the C rows filter
    across then down; the x86 rows (the first multiple of 24 outputs of an
    8-bit plane) average the rows first (pavgb) and filter across."""
    out = np.empty(dw, np.int64)
    n = 0 if hbd else dw - dw % 24

    def across(r, m):
        p0, p1, p2, p3 = r[0:4 * m:4], r[1:4 * m:4], r[2:4 * m:4], \
            r[3:4 * m:4]
        return ((p0 * 3 + p1 + 2) >> 2, (p1 + p2 + 1) >> 1,
                (p2 + p3 * 3 + 2) >> 2)
    if n:
        v = (s[:4 * n // 3] + t[:4 * n // 3] + 1) >> 1
        if kind == 0:
            v = (s[:4 * n // 3] + v + 1) >> 1
        for k, a in enumerate(across(v, n // 3)):
            out[k:n:3] = a
    m = (dw - n) // 3
    if m:
        sa = across(s[4 * n // 3:], m)
        ta = across(t[4 * n // 3:], m)
        for k in range(3):
            out[n + k::3] = (sa[k] * 3 + ta[k] + 2) >> 2 if kind == 0 else \
                (sa[k] + ta[k] + 1) >> 1
    return out


def _down38_row(rows, dw: int, hbd: bool) -> np.ndarray:
    """ScaleRowDown38_3_Box (three rows) or _2_Box (two) → dw outputs of 8
    → 3 samples: sums times 65536 / n >> 16; the x86 two-row row (the
    first multiple of 6 outputs of an 8-bit plane) averages its rows first
    (pavgb) and scales sums of 3 and 2 averages."""
    out = np.empty(dw, np.int64)
    n = 0 if hbd or len(rows) == 3 else dw - dw % 6
    if n:
        v = (rows[0] + rows[1] + 1) >> 1
        m = n // 3
        c = [v[k:8 * m:8] for k in range(8)]
        out[0:n:3] = (c[0] + c[1] + c[2]) * (65536 // 3) >> 16
        out[1:n:3] = (c[3] + c[4] + c[5]) * (65536 // 3) >> 16
        out[2:n:3] = (c[6] + c[7]) * (65536 // 2) >> 16
    m = (dw - n) // 3
    if m:
        k0 = 8 * n // 3
        tot = sum(r[k0:] for r in rows)
        c = [tot[k:8 * m:8] for k in range(8)]
        h = len(rows)
        out[n::3] = (c[0] + c[1] + c[2]) * (65536 // (3 * h)) >> 16
        out[n + 1::3] = (c[3] + c[4] + c[5]) * (65536 // (3 * h)) >> 16
        out[n + 2::3] = (c[6] + c[7]) * (65536 // (2 * h)) >> 16
    return out


def _scale_box(src: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """ScalePlaneBox: rows summed over each output's box of source rows,
    then columns over its box, times 65536 / (width · height) >> 16."""
    sh, sw = src.shape
    x, y, dx, dy = _scale_slope(sw, sh, dw, dh, _K_BOX)
    max_y = sh << 16
    out = np.empty((dh, dw), np.int64)
    xs = x + dx * np.arange(dw + 1, dtype=np.int64)
    ix = xs[:-1] >> 16
    for j in range(dh):
        iy = y >> 16
        y = min(y + dy, max_y)
        bh = max((y >> 16) - iy, 1)
        row = src[iy:iy + bh].sum(0)
        cum = np.concatenate([[0], np.cumsum(row)])
        if dx & 0xFFFF:
            minbw = dx >> 16
            tbl = (65536 // (max(minbw, 1) * bh),
                   65536 // (max(minbw + 1, 1) * bh))
            bw = np.maximum((xs[1:] >> 16) - ix, 1)
            scale = np.where(bw - minbw == 0, tbl[0], tbl[1])
            out[j] = (cum[ix + bw] - cum[ix]) * scale >> 16
        else:
            bw = max(dx >> 16, 1)
            x0 = (x >> 16) + bw * np.arange(dw)
            out[j] = (cum[x0 + bw] - cum[x0]) * (65536 // (bw * bh)) >> 16
    return out


def _scale_bilinear_down(src, dw, dh, f, hbd):
    sh, sw = src.shape
    x, y, dx, dy = _scale_slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16
    y = min(y, max_y)
    out = np.empty((dh, dw), np.int64)
    for j in range(dh):
        yi = y >> 16
        if f == _K_LINEAR:
            row = src[yi]
        else:
            row = _interpolate_row(src[yi], src[min(yi + 1, sh - 1)],
                                   (y >> 8) & 255)
        out[j] = _filter_cols(row, dw, x, dx, hbd)
        y = min(y + dy, max_y)
    return out


def _scale_bilinear_up(src, dw, dh, f, hbd):
    sh, sw = src.shape
    x, y, dx, dy = _scale_slope(sw, sh, dw, dh, f)
    max_y = (sh - 1) << 16

    def cols(r):
        return _filter_cols(src[r], dw, x, dx, hbd) if f else \
            _scale_cols(src[r], dw, x, dx)
    y = min(y, max_y)
    yi = y >> 16
    s = yi
    rows = [cols(s)]
    if sh > 1:
        s += 1
    rows.append(cols(s))
    if sh > 2:
        s += 1
    cur, lasty = 0, yi
    out = np.empty((dh, dw), np.int64)
    for j in range(dh):
        yi = y >> 16
        if yi != lasty:
            if y > max_y:
                y = max_y
                yi = y >> 16
                s = yi
            if yi != lasty:
                rows[cur] = cols(s)
                cur ^= 1
                lasty = yi
                if y + 65536 < max_y:
                    s += 1
        a, b = rows[cur], rows[cur ^ 1]
        out[j] = a if f == _K_LINEAR else _interpolate_row(a, b,
                                                           (y >> 8) & 255)
        y += dy
    return out


def libyuv_scale_plane(src: np.ndarray, dw: int, dh: int,
                       hbd: bool) -> np.ndarray:
    """libyuv 1924's ScalePlane (hbd False: 8-bit samples) or ScalePlane_12
    / ScalePlane_16 (hbd) of a plane to dw x dh with the box filter, as
    libavif's avifImageScale calls it."""
    src = src.astype(np.int64)
    sh, sw = src.shape
    f = _scale_filter_reduce(sw, sh, dw, dh, _K_BOX)
    if (dw, dh) == (sw, sh):
        return src.copy()
    if dw == sw and f != _K_BOX:
        y, dy = 0, 0
        if dh <= sh:
            dy = _fixed_div(sh, dh)
            y = _centerstart(dy, -32768)
        elif sh > 1 and dh > 1:
            dy = _fixed_div1(sh, dh)
        max_y = ((sh - 1) << 16) - 1 if sh > 1 else 0
        out = np.empty((dh, dw), np.int64)
        for j in range(dh):
            y = min(y, max_y)
            yi = y >> 16
            yf = (y >> 8) & 255 if f else 0
            out[j] = _interpolate_row(src[yi], src[min(yi + 1, sh - 1)], yf)
            y += dy
        return out
    if dw <= sw and dh <= sh:
        if 4 * dw == 3 * sw and 4 * dh == 3 * sh:
            # (the filter reduces to bilinear here, never to none)
            stride = 0 if f == _K_LINEAR else 1
            out, r = [], 0
            for y in range(0, dh - 2, 3):
                out.append(_down34_row(src[r], src[r + stride], dw, 0, hbd))
                out.append(_down34_row(src[r + 1], src[r + 1 + stride], dw,
                                       1, hbd))
                out.append(_down34_row(src[r + 3], src[r + 3 - stride], dw,
                                       0, hbd))
                r += 4
            if dh % 3 == 2:
                out.append(_down34_row(src[r], src[r + stride], dw, 0, hbd))
                out.append(_down34_row(src[r + 1], src[r + 1], dw, 1, hbd))
            elif dh % 3 == 1:
                out.append(_down34_row(src[r], src[r], dw, 0, hbd))
            return np.stack(out)
        if 2 * dw == sw and 2 * dh == sh:
            return (src[0::2, 0::2] + src[0::2, 1::2] + src[1::2, 0::2] +
                    src[1::2, 1::2] + 2) >> 2
        if 8 * dw == 3 * sw and 8 * dh == 3 * sh:
            stride = 0 if f == _K_LINEAR else 1
            out, r = [], 0
            for y in range(0, dh - 2, 3):
                out.append(_down38_row([src[r + k * stride] for k in range(3)],
                                       dw, hbd))
                out.append(_down38_row([src[r + 3 + k * stride]
                                        for k in range(3)], dw, hbd))
                out.append(_down38_row([src[r + 6 + k * stride]
                                        for k in range(2)], dw, hbd))
                r += 8
            if dh % 3 == 2:
                out.append(_down38_row([src[r + k * stride] for k in range(3)],
                                       dw, hbd))
                out.append(_down38_row([src[r + 3]] * 3, dw, hbd))
            elif dh % 3 == 1:
                out.append(_down38_row([src[r]] * 3, dw, hbd))
            return np.stack(out)
        if 4 * dw == sw and 4 * dh == sh and f in (_K_BOX, _K_NONE):
            blocks = src.reshape(dh, 4, dw, 4)
            return (blocks.sum((1, 3)) + 8) >> 4
    if f == _K_BOX and dh * 2 < sh:
        return _scale_box(src, dw, dh)
    if (dw + 1) // 2 == sw and f == _K_LINEAR:
        if dh == 1:
            return _up2_linear(src[(sh - 1) // 2][None], dw).astype(np.int64)
        dy = _fixed_div(sh - 1, dh - 1)
        rows = ((1 << 15) - 1 + dy * np.arange(dh, dtype=np.int64)) >> 16
        return _up2_linear(src[rows], dw).astype(np.int64)
    if (dh + 1) // 2 == sh and (dw + 1) // 2 == sw and \
            f in (_K_BILINEAR, _K_BOX):
        # ScalePlaneUp2_Bilinear (and _12, _16): upsample_420's rows
        return upsample_420(src, dw, dh).astype(np.int64)
    if f and dh > sh:
        return _scale_bilinear_up(src, dw, dh, f, hbd)
    if f:
        return _scale_bilinear_down(src, dw, dh, f, hbd)
    x, y, dx, dy = _scale_slope(sw, sh, dw, dh, _K_NONE)
    rows = (y + dy * np.arange(dh, dtype=np.int64)) >> 16
    return np.stack([_scale_cols(src[r], dw, x, dx) for r in rows])


def _alpha_to_8(a: np.ndarray, depth: int) -> np.ndarray:
    """libavif's ``avifReformatAlpha`` from ``depth`` bits to 8: a / max ·
    255 rounded (never a tie at 10 or 12 bits)."""
    top = (1 << depth) - 1
    return ((a.astype(np.int64) * 510 + top) // (2 * top)).astype(np.uint8)


def alpha_limited_to_full(a: np.ndarray, depth: int) -> np.ndarray:
    """libavif's ``avifLimitedToFullY`` on a limited-range alpha plane (the
    alpha frame's colour_range 0): (a - black) · max / (white - black),
    rounded half up, clamped."""
    lo, hi = {8: (16, 235), 10: (64, 940), 12: (256, 3760)}[depth]
    num = (a.astype(np.int64) - lo) * ((1 << depth) - 1)
    q = (2 * num + hi - lo) // (2 * (hi - lo))
    return np.clip(q, 0, (1 << depth) - 1).astype(np.uint16)


# libyuv's fixed_invtbl8: 1 / a in 8.8 fixed point (its low 16 bits)
_UNATTENUATE = np.array([0, 0xFFFF] + [0x10000 // a for a in range(2, 255)] +
                        [0x100], np.int64)


def unattenuate(rgb: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libyuv 1924's ``ARGBUnattenuate`` (its AVX2 and SSE2 rows, what
    libavif's ``avifRGBImageUnpremultiplyAlpha`` calls on 8-bit RGBA): each
    channel c → (c · 257 · fixed_invtbl8[a]) >> 16, saturated as a signed
    16-bit word to 0-255 (a result of 32768 up, alpha 1 under a bright
    colour, packs to 0)."""
    r = rgb.astype(np.int64) * 257 * _UNATTENUATE[a.astype(np.int64)][
        ..., None] >> 16
    return np.where(r >= 32768, 0, np.minimum(r, 255)).astype(np.uint8)


def avif_planes_to_rgb(planes, depth: int, subx: int, suby: int,
                       matrix: int, full_range: bool, path="image",
                       primaries: int = 2, alpha=None,
                       premultiplied: bool = False):
    """Decoded AV1 planes → (H, W, 3) uint8 RGB as cv2 5.0.0 gets them:
    OpenCV asks libavif 1.4.2 for 8-bit BGR (BGRA where the image has an
    alpha, which it drops after).  libavif converts through libyuv with
    the constants of ``_avif_matrix`` (BT.601, BT.709 and BT.2020 NCL, full
    and limited range), samples past 8 bits cut to their top 8 first; where
    an alpha is converted too, 10-bit images go through libyuv's own 10-bit
    rows (I010/I210/I410AlphaToARGB: 4:2:0 and 4:2:2 chroma upsampled at 10
    bits, alpha >> 2) and 12-bit 4:2:0 through I012ToARGBMatrix (chroma
    repeated, alpha rounded); or libavif takes its own identity path (GBR,
    matrix 0, 4:4:4: samples past 8 bits scaled by 255 / max and
    rounded).  ``alpha``: the alpha plane at the colour's size and depth
    (full range), and with ``premultiplied`` the colour is divided by it
    as libyuv's ``ARGBUnattenuate`` divides (libavif's identity path past
    8 bits divides in float itself).  4:2:0 and 4:2:2 chroma are
    upsampled as libyuv's bilinear and linear filters do.  A monochrome
    frame under a colour av1C: its luma as gray at 8 bits, as libyuv's
    I400 conversion gives it."""
    if len(planes) == 1:
        # libavif's libyuv path converts a 4:0:0 frame only into BGRA (an
        # image with alpha; I400ToARGBMatrix, the identity matrix with
        # BT.601's constants, samples past 8 bits cut to their top 8), its
        # own luma table otherwise
        constants = _avif_matrix(matrix, primaries, full_range, depth, 0, 0,
                                 path)
        if matrix == 0:
            constants = _LIBYUV_CONSTANTS["601", full_range]
        if alpha is None or constants == "libavif":
            return libavif_builtin_rgb(planes, depth, 0, 0, matrix,
                                       primaries, full_range, alpha,
                                       premultiplied)
        y = np.minimum(planes[0] >> (depth - 8), 255)
        mid = np.full_like(y, 128)
        rgb = yuv_to_rgb(y, mid, mid, constants)
        if premultiplied:
            rgb = unattenuate(rgb, _alpha_to_8(alpha, depth) if depth > 8
                              else alpha)
        return rgb
    y, u, v = planes
    height, width = y.shape
    constants = _avif_matrix(matrix, primaries, full_range, depth, subx,
                             suby, path)
    if constants == "libavif":
        return libavif_builtin_rgb(planes, depth, subx, suby, matrix,
                                   primaries, full_range, alpha,
                                   premultiplied)
    a8 = None
    if constants is None and depth > 8 and premultiplied:
        # libavif's slow path, which divides by the alpha itself in float
        top = np.float32((1 << depth) - 1)
        gbr = np.stack([v, y, u], -1).astype(np.float32) / top
        a = (alpha.astype(np.float32) / top)[..., None]
        with np.errstate(divide="ignore", invalid="ignore"):
            c = np.where(a > 0, np.minimum(gbr / a, np.float32(1)),
                         np.float32(0))
        return np.floor(np.float32(0.5) + c * np.float32(255)).astype(
            np.uint8)
    if constants is None:
        gbr = np.stack([v, y, u], -1).astype(np.int64)
        if depth > 8:        # libavif's float path: round(x / max · 255)
            top = (1 << depth) - 1
            gbr = (gbr * 510 + top) // (2 * top)
        rgb = gbr.astype(np.uint8)
    else:
        ydepth = 8           # libyuv's rows after libavif's downshift
        if alpha is not None and depth == 10:
            ydepth, a8 = 10, (alpha >> 2).astype(np.uint8)
        elif alpha is not None and depth == 12 and subx and suby:
            ydepth, a8 = 12, _alpha_to_8(alpha, depth)
            u, v = (np.repeat(np.repeat(c, 2, 0), 2, 1)[:height, :width]
                    for c in (u, v))
            subx = suby = 0
        if ydepth == 8 and depth > 8:
            y, u, v = (np.minimum(p >> (depth - 8), 255) for p in (y, u, v))
            if alpha is not None:
                a8 = np.minimum(alpha >> (depth - 8), 255).astype(np.uint8)
        if subx and suby:
            u = upsample_420(u, width, height)
            v = upsample_420(v, width, height)
        elif subx:      # 4:2:2: libyuv's linear filter, rows alone
            u = _up2_linear(u.astype(np.int32), width)
            v = _up2_linear(v.astype(np.int32), width)
        rgb = yuv_to_rgb(y, u, v, constants, ydepth)
    if premultiplied:
        rgb = unattenuate(rgb, alpha if a8 is None else a8)
    return rgb


def decode_av1(obu: bytes, path="image", grain: bool = True):
    """The OBUs of an AV1 image (a still item's, or a sequence's first
    sample; of its frames, the last one shown) → ([Y, U, V] uint16 planes,
    or [Y] for a monochrome frame, info): info is (width, height, bit depth,
    subsampling x, subsampling y, monochrome, colour primaries, transfer,
    matrix, full range) from the sequence header, then the tools the frame
    used (tile columns and rows, 128x128 superblocks, CDEF, quantizer
    matrices, lossless, delta q, filter intra enabled, screen content
    tools, intra block copy allowed), the palette and intra block copy
    blocks decoded and whether film grain was applied; then where the
    frame header lies (its OBU payload's offset in ``obu``, the bit of its
    film grain fields, its bytes); then loop restoration's frame type of
    each plane (0 none, 1 Wiener, 2 self-guided, 3 switchable), the Wiener
    and self-guided units decoded, whether segmentation is enabled and the
    blocks of each of the 8 segment ids; then superres's denominator (8:
    none) and the coded width (the width above is the upscaled frame's),
    whether the delta loop filter is present and multi, the blocks with a
    nonzero delta and the frame header's bit of delta_lf_present (-1
    without delta q); then the counters of the whole data: frames decoded,
    intra-only frames, show_existing_frame headers, inter blocks by mode
    (NEARESTMV, NEARMV, GLOBALMV, NEWMV) and by interpolation filters (both
    regular, smooth, sharp, bilinear, or two different ones), frames with
    use_ref_frame_mvs (motion-field projection), blocks whose MV stack took
    a temporal candidate, LOCALWARP blocks and those of them whose model
    was invalid, references with non-identity global motion (each
    frame's), GLOBALMV blocks warped by it, OBMC blocks, inter-intra blocks
    (smooth, wedge); compound blocks by type (average, distance weights,
    wedge, difference-weighted), skip-mode blocks, single-reference blocks
    beside a compound neighbour; blocks predicted from a scaled reference
    (another size than the frame's, or the frame coded with superres),
    inter frames coded with superres, switch frames, blocks whose warp a
    scaled reference turned into a translation, inter frames that name a
    reference coded with superres, compound blocks with a scaled reference
    and OBMC blocks that predicted from one (their own or a neighbour's);
    slots rebuilt from ref_order_hint (libaom's neutral-grey buffer), inter
    frames that name a rebuilt slot, blocks predicted from one, and reads of
    what a rebuilt buffer kept of its last frame (a primary reference
    frame's state, a motion-field projection, film grain, a
    show_existing_frame).  The fields
    before those counters describe the last frame decoded.  With ``grain``
    False the planes are the frame before its film grain."""
    import ctypes

    lib = _load_avif_codec()
    err = ctypes.create_string_buffer(_AVIF_ERRLEN)
    handle = lib.av1_decode(obu, len(obu), 0 if grain else 1, err,
                            _AVIF_ERRLEN)
    if not handle:
        msg = err.value.decode(errors="replace")
        raise RuntimeError(f"{path}: AV1 data cv2 does not read: {msg}")
    try:
        info = (ctypes.c_longlong * 84)()
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


def avif_scale(planes, info, width: int, height: int):
    """libavif 1.4.2's ``avifImageScale`` of a decoded frame (its planes
    and decode_av1's info) to width x height, as its decoder scales a
    tile's frame to the tile's size (an item's ispe, a track's tkhd):
    each plane through ``libyuv_scale_plane`` (box filter), chroma to its
    subsampled size → (planes, info with the new size)."""
    depth, subx, suby = info[2:5]
    if (width, height) == tuple(info[:2]):
        return planes, info
    out = []
    for p, plane in enumerate(planes):
        sx, sy = (subx, suby) if p else (0, 0)
        out.append(libyuv_scale_plane(plane, (width + sx) >> sx,
                                      (height + sy) >> sy, depth > 8
                                      ).astype(np.uint16))
    return out, [width, height] + list(info[2:])


def _avif_assemble(heif: _Heif, tiles, grid, path, size=None):
    """The decoded frame of an image item: its one tile's, or a grid's
    tiles placed into one frame as libavif 1.4.2 places them → (planes,
    info of the first tile with the item's size).  libavif scales each
    tile's frame to its size (``avif_scale``): a grid tile's ispe, a lone
    item's ``size`` (its ispe, an alpha item's taken from its colour's
    where it has none); a grid's tiles must then agree in size, depth,
    chroma format, range and CICP, cover the grid with the last row and
    column overlapping its edge (MIAF 7.3.11.4.2), be at least 64x64 and
    even where chroma is subsampled."""
    decoded = []
    for obu, props in tiles:
        planes, info = decode_av1(obu, path)
        ispe = props.get(b"ispe")
        if ispe is not None and len(ispe) < 12:
            raise heif.bad("an ispe box cut short")
        want = size if grid is None else None
        if want is None and ispe is not None:
            want = struct.unpack_from(">II", ispe, 4)
        if want is not None:
            planes, info = avif_scale(planes, info, *want)
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


def _avif_sequence(heif: _Heif, path):
    """The first frame of an image sequence's colour track, as libavif
    decodes it for cv2 → (planes, info, properties, gray, alpha planes and
    info or None, premultiplied); the alpha track's first frame decoded and
    checked as an alpha item's.  The sample entry's transforms (irot,
    imir, clap) are parsed and not applied, as cv2 reads the frame."""
    colour, alpha = heif.colour_track()
    obu, props = heif.track_image(colour)
    if b"av1C" not in props:
        raise heif.bad("the colour track has no av1C")
    gray = _avif_check_properties(heif, props)
    if alpha is not None:
        aobu, aprops = heif.track_image(alpha)
        if b"av1C" not in aprops:
            raise heif.bad("the alpha track has no av1C")
        _avif_check_properties(heif, aprops)
    heif.signature_check([])
    # libavif scales each track's frame to its tkhd's size
    planes, info = avif_scale(*decode_av1(obu, path), colour["width"],
                              colour["height"])
    decoded = None
    if alpha is not None:
        decoded = avif_scale(*decode_av1(aobu, path), alpha["width"],
                             alpha["height"])
        if decoded[1][2] != info[2]:
            raise heif.bad(f"a {decoded[1][2]}-bit alpha frame for a "
                           f"{info[2]}-bit image")
    if gray and alpha is not None:
        raise heif.bad("a gray image with an alpha track")
    prem = alpha is not None and colour["prem_by"] == alpha["id"]
    return planes, info, props, gray, decoded, prem


def _avif_alpha(heif: _Heif, decoded, info):
    """The alpha plane the colour stage takes: the alpha frame's luma
    (scaled to its item's or track's size), made full range where its
    frame says limited (libavif's ``avifImageLimitedToFullAlpha``).
    libavif refuses an alpha still of another size than the colour (a
    track's tkhd of another size than the colour track's)."""
    aplanes, ainfo = decoded
    a = aplanes[0]
    if tuple(ainfo[:2]) != tuple(info[:2]):
        raise heif.bad("an alpha of another size than the colour")
    if not ainfo[9]:
        a = alpha_limited_to_full(a, ainfo[2])
    return a


def _decode_avif_bytes(data: bytes, path):
    heif = _Heif(data, path)
    heif.parse()
    if heif.source == "tracks":
        planes, info, props, gray, decoded, prem = _avif_sequence(heif, path)
        depth, subx, suby = info[2:5]
        if gray:
            return avif_gray(planes[0], depth)
        primaries, matrix, full = _avif_cicp(props, info)
        alpha = None if decoded is None else _avif_alpha(heif, decoded, info)
        return avif_planes_to_rgb(planes, depth, subx, suby, matrix, full,
                                  path, primaries, alpha, prem)
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
    planes, info = _avif_assemble(heif, tiles, grid, path,
                                  struct.unpack_from(">II", ispe, 4))
    width, height, depth, subx, suby = info[:5]
    decoded = None
    if alpha is not None:
        # libavif decodes the alpha too (its frame fitted to the item's
        # size), and refuses one that does not decode or whose depth is not
        # the colour's
        decoded = _avif_assemble(heif, alpha[0], alpha[2], path,
                                 struct.unpack_from(">II", aispe, 4))
        ainfo = decoded[1]
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
    primaries, matrix, full = _avif_cicp(props, info)
    prem = alpha is not None and heif.prem_by == heif.alpha
    a = None if decoded is None else _avif_alpha(heif, decoded, info)
    return avif_planes_to_rgb(planes, depth, subx, suby, matrix, full, path,
                              primaries, a, prem)


def read_avif(path) -> np.ndarray:
    """An AVIF file → (H, W, 3) uint8 RGB, bit for bit what
    ``cv2.imread(path)[..., ::-1]`` gives (cv2 5.0.0 with libavif 1.4.2,
    libaom 3.14.1 and libyuv 1924): the container parsed here as libavif
    parses it (a still image's primary item, or an image sequence's colour
    track, as libavif's ``AVIF_DECODER_SOURCE_AUTO`` picks), the AV1 key
    frame decoded by the port's own decoder (``csrc/avif_codec.cpp``), the
    YUV → RGB of libavif and libyuv.  Reads what cv2's and Pillow's
    writers make: 8, 10 and 12 bits, 4:2:0, 4:2:2, 4:4:4 and 4:0:0 (gray:
    the luma as OpenCV copies it), lossless too, any tiling, 64x64 or
    128x128 superblocks, CDEF, loop restoration, segmentation, quantizer
    matrices, the screen content tools (palette, intra block copy), film
    grain (synthesised as libaom's ``av1_add_film_grain`` does), full and
    reduced sequence headers, an alpha item or track (decoded and checked
    as libavif does, then dropped as cv2's 3-channel read drops it; a
    premultiplied one divided out first), grid items (colour and alpha)
    with libavif's grid rules, and image sequences (``avis``: the first
    frame); an nclx colr wherever it stands beside an ICC one, rotations,
    mirrors and clean apertures (parsed, not applied, as cv2 reads the
    image), BT.601, BT.709 and BT.2020 NCL at full and limited range
    through libyuv, and the matrices libavif converts on its own path
    (FCC, SMPTE 240, YCgCo, 15, YCgCo-Re, chroma-derived NCL of other
    primaries, the identity matrix at limited range:
    ``libavif_builtin_rgb``); superres and the delta loop filter; frames
    libavif scales to their item's ispe or their track's tkhd
    (``avif_scale``: libyuv's box filter), alphas too; a monochrome frame
    under a colour av1C at any depth and range; scalability metadata;
    several frames (libaom outputs the last one shown): intra-only
    frames, hidden key and inter frames that a show_existing_frame header
    shows, inter frames with motion-field projection, local warped and
    global motion, OBMC, inter-intra, compound prediction and skip mode
    (the inter tools libaom's encoder uses at its defaults), inter frames
    predicted from references of another size (libaom's resize) or coded
    with superres, switch frames, and error resilient frames whose
    ref_order_hint differs from a slot's (libaom rebuilds the slot as a
    neutral-grey buffer of its pool that keeps the rest of what it held).
    Raises ``RuntimeError`` naming the file where cv2 returns None
    (OpenCV's own 500-byte signature test included; an iloc construction
    method 2; a reference more than twice or less than a sixteenth of the
    frame)."""
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
    that cv2's and Pillow's writers make, grids and image sequences, every
    colour and orientation option of Pillow's, superres and the delta loop
    filter, every matrix libavif converts, frames it scales, intra-only,
    hidden and inter frames with libaom's default inter tools, its resize
    and superres, switch frames, reference slots rebuilt from
    ref_order_hint; ``read_avif``).  A file cv2 does not read raises
    naming the file."""
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
