"""Writes ``tests/torch_images/``: small image files of every kind the
port's readers take beyond plain PNG and JPEG, each with cv2's decode of it,
so that ``utils/image_io.read_image`` can be held to cv2 where cv2 is not
installed (the tier-1 tests, the card's machine).

    python tests/torch_make_image_fixtures.py   # needs cv2, PIL, gcc and
                                                # the system libjpeg

Each ``<name>.<ext>`` has ``<name>.want.png``, ``cv2.imread``'s decode of
it (as RGB).  ``REFUSED`` names the files cv2 does not read (its
``imread`` gives None): the port must raise naming them.  ``enc_src.png``
has ``enc_src.bmp``, ``enc_src.ppm`` and ``enc_src.tif``, the bytes of
``cv2.imwrite``'s defaults.

The writers: a small C program, built here, over the system libjpeg-turbo
(arithmetic-coded JPEG with DAC conditioning, YCCK, 2 components) and over
Pillow's bundled libjpeg-turbo 3 (lossless and 12-bit JPEG); PIL (CMYK
JPEG, BMP); ``cv2.imwrite`` (TIFF compressions, 16-bit TIFF, BMP, PNM);
bytes written here (Adam7 PNG, tiled / planar / big-endian / palette TIFF,
RLE BMP, PNM text files, a hierarchical frame) and cuts of the files
written.  ``check(folder)`` imports neither cv2 nor PIL.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import tempfile
import zlib

import numpy as np

FOLDER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_images")
H, W = 29, 38                       # fixture size: whole and partial MCUs

# name -> file; every file but those of REFUSED has <name>.want.png
CASES = [
    # JPEG
    "jpeg_cut_baseline.jpg", "jpeg_cut_prog_30.jpg", "jpeg_cut_prog_60.jpg",
    "jpeg_cut_prog_90.jpg", "jpeg_arith_seq.jpg", "jpeg_arith_prog.jpg",
    "jpeg_cmyk.jpg", "jpeg_ycck.jpg", "jpeg_lossless_p1.jpg",
    "jpeg_lossless_p7_pt2.jpg", "jpeg_lossless_cmyk.jpg",
    # interlaced PNG
    "png_adam7_rgb8.png", "png_adam7_rgb16.png", "png_adam7_palette.png",
    "png_adam7_gray2.png",
    # TIFF
    "tiff_none.tif", "tiff_lzw.tif", "tiff_deflate.tif",
    "tiff_adobe_deflate.tif", "tiff_packbits.tif", "tiff_lzw_16.tif",
    "tiff_gray_pred.tif", "tiff_tiled.tif", "tiff_planar.tif",
    "tiff_big_endian.tif", "tiff_palette.tif", "tiff_gray.tif",
    "tiff_bilevel.tif", "tiff_rgba_unassoc.tif", "tiff_jpeg.tif",
    "tiff_jpeg_ycbcr.tif",
    # BMP
    "bmp_pal8.bmp", "bmp_rle8.bmp", "bmp_rle4.bmp", "bmp_pal1.bmp",
    "bmp_24.bmp", "bmp_32.bmp", "bmp_565.bmp", "bmp_top_down.bmp",
    # PNM
    "pnm_p1.pbm", "pnm_p4.pbm",
    *[f"pnm_{kind}_{maxval}.{'pgm' if kind in ('p2', 'p5') else 'ppm'}"
      for kind in ("p2", "p3", "p5", "p6") for maxval in (255, 7, 1000)],
]
REFUSED = ["jpeg_12bit.jpg", "jpeg_hierarchical.jpg", "jpeg_2comp.jpg",
           "jpeg_lossless_gray.jpg", "tiff_gray_alpha.tif",
           "tiff_palette2.tif"]
ENCODED = ["enc_src.bmp", "enc_src.ppm", "enc_src.tif"]
# a full-size view for the decode seconds of an arithmetic-coded JPEG
# (chip_smoke.py); no decode beside it, the tests hold it to cv2
TIMING = "timing_arith_1297x840.jpg"

_JPEGW = r"""
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <jpeglib.h>
__attribute__((weak)) void jpeg_enable_lossless(j_compress_ptr, int, int);
__attribute__((weak)) JDIMENSION jpeg12_write_scanlines(j_compress_ptr,
                                                         short **, JDIMENSION);
/* jpegw OUT RAW W H C [-q Q] [-arith] [-prog] [-restart N] [-space S]
   [-lossless PSV PT] [-prec 12] [-dac L U K]: RAW holds H*W*C samples
   (16-bit with -prec 12). */
int main(int argc, char **argv) {
  const char *out = argv[1], *raw = argv[2];
  int W = atoi(argv[3]), H = atoi(argv[4]), C = atoi(argv[5]);
  int q = 90, arith = 0, prog = 0, rst = 0, psv = 0, pt = 0, prec = 8;
  int dac = 0, L = 0, U = 1, K = 5;
  const char *space = NULL;
  for (int i = 6; i < argc; i++) {
    if (!strcmp(argv[i], "-q")) q = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-arith")) arith = 1;
    else if (!strcmp(argv[i], "-prog")) prog = 1;
    else if (!strcmp(argv[i], "-restart")) rst = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-lossless")) {
      psv = atoi(argv[++i]); pt = atoi(argv[++i]); }
    else if (!strcmp(argv[i], "-prec")) prec = atoi(argv[++i]);
    else if (!strcmp(argv[i], "-space")) space = argv[++i];
    else if (!strcmp(argv[i], "-dac")) {
      dac = 1; L = atoi(argv[++i]); U = atoi(argv[++i]); K = atoi(argv[++i]); }
  }
  size_t bps = prec > 8 ? 2 : 1, n = (size_t)W * H * C * bps;
  unsigned char *buf = malloc(n);
  FILE *f = fopen(raw, "rb");
  if (!f || fread(buf, 1, n, f) != n) return 2;
  fclose(f);
  struct jpeg_compress_struct ci;
  struct jpeg_error_mgr je;
  ci.err = jpeg_std_error(&je);
  jpeg_create_compress(&ci);
  FILE *o = fopen(out, "wb");
  jpeg_stdio_dest(&ci, o);
  ci.image_width = W; ci.image_height = H; ci.input_components = C;
  ci.in_color_space = C == 1 ? JCS_GRAYSCALE : C == 3 ? JCS_RGB :
                      C == 4 ? JCS_CMYK : JCS_UNKNOWN;
  if (prec != 8) ci.data_precision = prec;
  jpeg_set_defaults(&ci);
  if (space) jpeg_set_colorspace(&ci, !strcmp(space, "ycck") ? JCS_YCCK :
                                       !strcmp(space, "rgb") ? JCS_RGB :
                                       JCS_CMYK);
  jpeg_set_quality(&ci, q, TRUE);
  if (arith) ci.arith_code = TRUE;
  if (dac) for (int t = 0; t < 16; t++) {
    ci.arith_dc_L[t] = L; ci.arith_dc_U[t] = U; ci.arith_ac_K[t] = K; }
  if (prog) jpeg_simple_progression(&ci);
  if (rst) ci.restart_interval = rst;
  if (psv) jpeg_enable_lossless(&ci, psv, pt);
  jpeg_start_compress(&ci, TRUE);
  while (ci.next_scanline < (JDIMENSION)H) {
    unsigned char *row = buf + (size_t)ci.next_scanline * W * C * bps;
    if (prec > 8) { short *r = (short *)row; jpeg12_write_scanlines(&ci, &r, 1); }
    else jpeg_write_scanlines(&ci, &row, 1);
  }
  jpeg_finish_compress(&ci);
  fclose(o);
  return 0;
}
"""


def fixture_image(h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    """A smooth (H, W, 3) uint8 image with light noise."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([128 + 100 * np.sin(x / 7 + y / 11),
                    128 + 90 * np.cos(x / 5 - y / 9),
                    128 + 80 * np.sin((x + y) / 13)], axis=2)
    img += rng.normal(0, 6, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


# ------------------------------------------------------------ JPEG writers


def _jpeg_tools(tmp: str):
    """The C writer built twice: over the system libjpeg-turbo (2.1) and
    over Pillow's bundled libjpeg-turbo 3 (lossless, 12-bit)."""
    import glob

    import PIL

    src = os.path.join(tmp, "jpegw.c")
    with open(src, "w") as f:
        f.write(_JPEGW)
    sys_tool, pil_tool = os.path.join(tmp, "jpegw_sys"), \
        os.path.join(tmp, "jpegw_pil")
    subprocess.run(["gcc", "-O1", "-o", sys_tool, src, "-ljpeg"], check=True)
    libs = os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs")
    lib = sorted(glob.glob(os.path.join(libs, "libjpeg-*.so*")))[0]
    subprocess.run(["gcc", "-O1", "-o", pil_tool, src, lib,
                    f"-Wl,-rpath,{os.path.dirname(lib)}"], check=True)

    def write(tool, path, arr, *opts):
        arr = np.ascontiguousarray(arr)
        raw = os.path.join(tmp, "in.raw")
        arr.tofile(raw)
        h, w = arr.shape[:2]
        c = arr.shape[2] if arr.ndim == 3 else 1
        subprocess.run([tool, path, raw, str(w), str(h), str(c), *opts],
                       check=True)
    return (lambda *a: write(sys_tool, *a)), (lambda *a: write(pil_tool, *a))


def _scan_data(data: bytes):
    """(start, end) of each scan's entropy-coded data."""
    out, i = [], 2
    while i + 4 <= len(data):
        if data[i] != 0xFF or data[i + 1] in (0x00, 0xFF, 0xD8, 0xD9) or \
                0xD0 <= data[i + 1] <= 0xD7:
            i += 1
            continue
        length = (data[i + 2] << 8) | data[i + 3]
        if data[i + 1] != 0xDA:
            i += 2 + length
            continue
        j = i + 2 + length
        k = j
        while k + 1 < len(data) and not (
                data[k] == 0xFF and data[k + 1] not in (0x00, 0xFF)
                and not 0xD0 <= data[k + 1] <= 0xD7):
            k += 1
        out.append((j, k))
        i = k
    return out


def _cut(data: bytes, fraction: float) -> bytes:
    """The file cut at the first byte past ``fraction`` of it that lies in
    a scan's data (a cut inside a marker segment makes libjpeg fail)."""
    at = int(len(data) * fraction)
    for start, end in _scan_data(data):
        if end > at:
            return data[:max(at, start + 1)]
    raise ValueError("no scan data past the cut")


# ------------------------------------------------------------- PNG writer


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _png_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    h, w, _ = samples.shape
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = ((samples[..., 0][..., None] >> np.arange(depth - 1, -1, -1))
            & 1).astype(np.uint8).reshape(h, -1)
    return np.packbits(bits, axis=1)


def _png_filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each row under a random filter type (0-4)."""
    out, prior = [], np.zeros(rows.shape[1], np.int64)
    for r in rows.astype(np.int64):
        t = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])[:len(r)]
        c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])[:len(r)]
        if t == 0:
            f = r
        elif t == 1:
            f = r - a
        elif t == 2:
            f = r - prior
        elif t == 3:
            f = r - ((a + prior) >> 1)
        else:
            p = a + prior - c
            pa, pb, pc = abs(p - a), abs(p - prior), abs(p - c)
            f = r - np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, prior, c))
        out.append(np.concatenate([[t], f & 0xFF]).astype(np.uint8))
        prior = r
    return b"".join(x.tobytes() for x in out)


def write_adam7_png(path, samples, depth, ctype, palette=None, seed=0):
    """An interlaced PNG of (H, W, C) samples, every row filtered."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    raw = b"".join(_png_filter(_png_rows(samples[y0::dy, x0::dx], depth),
                               bpp, rng)
                   for x0, y0, dx, dy in _ADAM7
                   if samples[y0::dy, x0::dx].size)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 1))
    if palette is not None:
        data += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    data += chunk(b"IDAT", zlib.compress(raw, 9)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)


# ------------------------------------------------------------ TIFF writer


def _lzw(data: bytes) -> bytes:
    """TIFF LZW (MSB first, early change, CLEAR at 4094), plain Python."""
    out, acc, nacc = bytearray(), 0, 0

    def put(code, nbits):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 0xFF)
            nacc -= 8
    table, nbits, free = {}, 9, 258
    put(256, nbits)
    if data:
        cur = data[0]
        for c in data[1:]:
            if (cur, c) in table:
                cur = table[(cur, c)]
                continue
            put(cur, nbits)
            table[(cur, c)] = free
            free += 1
            cur = c
            if free == 4094:
                put(256, nbits)
                table, free, nbits = {}, 258, 9
            elif free > (1 << nbits) - 1:
                nbits += 1
        put(cur, nbits)
        free += 1
        if free > (1 << nbits) - 1 and nbits < 12:
            nbits += 1
    put(257, nbits)
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def write_tiff_file(path, samples, bps=8, photometric=None, compression=1,
                    predictor=1, planar=1, tile=None, rows_per_strip=None,
                    endian="<", colormap=None, extra_samples=None):
    """A one-image TIFF: strips or tiles, chunky or planar, II or MM, no
    compression, LZW or Deflate, predictor 2 at 8 or 16 bits."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    h, w, spp = samples.shape
    if photometric is None:
        photometric = 1 if spp == 1 else 2
    planes = ([samples[..., k:k + 1] for k in range(spp)] if planar == 2
              else [samples])

    def encode(block):
        rows, cols, n = block.shape
        if predictor == 2:
            d = block.astype(np.int64)
            d[:, 1:] -= block[:, :-1].astype(np.int64)
            block = d & ((1 << bps) - 1)
        if bps == 16:
            raw = block.astype(endian + "u2").tobytes()
        elif bps == 8:
            raw = block.astype(np.uint8).tobytes()
        else:
            flat = block.reshape(rows, cols * n)
            bits = ((flat[..., None] >> np.arange(bps - 1, -1, -1)) & 1
                    ).astype(np.uint8).reshape(rows, -1)
            raw = np.packbits(bits, axis=1).tobytes()
        return {1: raw, 5: _lzw(raw), 8: zlib.compress(raw)}[compression]

    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for ty in range(0, h, th):
                for tx in range(0, w, tw):
                    blk = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[ty:ty + th, tx:tx + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
        else:
            rps = rows_per_strip or h
            chunks += [encode(plane[y:y + rps]) for y in range(0, h, rps)]
    e = endian
    body = bytearray(b"II*\x00" if e == "<" else b"MM\x00*") + bytes(4)
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if tile:
        tags.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                     324: (4, offsets), 325: (4, [len(c) for c in chunks])})
    else:
        tags.update({273: (4, offsets), 279: (4, [len(c) for c in chunks]),
                     278: (4, [rows_per_strip or h])})
    if colormap is not None:
        tags[320] = (3, list(np.asarray(colormap).T.reshape(-1)))
    if extra_samples is not None:
        tags[338] = (3, list(extra_samples))
    entries = []
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = struct.pack(e + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) > 4:
            entries.append(struct.pack(e + "HHII", t, typ, len(vals),
                                       len(body)))
            body += raw + b"\x00" * (len(raw) % 2)
        else:
            entries.append(struct.pack(e + "HHI", t, typ, len(vals))
                           + raw.ljust(4, b"\x00"))
    ifd = len(body)
    body += struct.pack(e + "H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack(e + "I", ifd)
    with open(path, "wb") as f:
        f.write(bytes(body))


def write_jpeg_tiff(path, jpeg: bytes, h: int, w: int, subsampling):
    """A whole JFIF stream as the one strip of a YCbCr (photometric 6)
    JPEG-compressed TIFF, with its YCbCrSubsampling tag."""
    body = bytearray(b"II*\x00" + bytes(4)) + jpeg + b"\x00" * (len(jpeg) % 2)
    tags = {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [7]),
            262: (3, [6]), 273: (4, [8]), 277: (3, [3]), 278: (3, [h]),
            279: (4, [len(jpeg)]), 284: (3, [1]), 530: (3, list(subsampling))}
    entries = []
    for t in sorted(tags):
        typ, vals = tags[t]
        raw = struct.pack("<" + {3: "H", 4: "I"}[typ] * len(vals), *vals)
        if len(raw) > 4:
            entries.append(struct.pack("<HHII", t, typ, len(vals), len(body)))
            body += raw
        else:
            entries.append(struct.pack("<HHI", t, typ, len(vals))
                           + raw.ljust(4, b"\x00"))
    ifd = len(body)
    body += struct.pack("<H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack("<I", ifd)
    with open(path, "wb") as f:
        f.write(bytes(body))


# ------------------------------------------------------------- BMP writer


def _rle8(idx: np.ndarray) -> bytes:
    """Bottom-up RLE8: runs of 3 or more encoded, the rest absolute."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            run = 1
            while x + run < w and run < 255 and row[x + run] == row[x]:
                run += 1
            if run >= 3 or w - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            n = 3
            while x + n < w and n < 255 and not (
                    x + n + 2 < w and row[x + n] == row[x + n + 1]
                    == row[x + n + 2]):
                n += 1
            out += bytes([0, n]) + bytes(row[x:x + n]) + b"\x00" * (n % 2)
            x += n
        out += b"\x00\x00"
    out[-2:] = b"\x00\x01"
    return bytes(out)


def _rle4(idx: np.ndarray) -> bytes:
    """Bottom-up RLE4: two-color encoded runs and absolute runs."""
    out = bytearray()
    for row in idx[::-1].tolist():
        x, w = 0, len(row)
        while x < w:
            if w - x >= 6 and len(set(row[x:x + 6])) > 2:
                n = min(w - x, 20)
                nib = row[x:x + n] + [0] * (n % 2)
                b = bytes((nib[i] << 4) | nib[i + 1]
                          for i in range(0, len(nib), 2))
                out += bytes([0, n]) + b + b"\x00" * (len(b) % 2)
                x += n
                continue
            a, b2 = row[x], row[x + 1] if x + 1 < w else 0
            run = 1
            while x + run < w and run < 255 and \
                    row[x + run] == (a if run % 2 == 0 else b2):
                run += 1
            out += bytes([run, (a << 4) | b2])
            x += run
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


def write_bmp_file(path, px, bits, palette=None, comp=0, top_down=False,
                   masks=None):
    """A BMP with a 40-byte header: 1-8 bit palette, RLE8 / RLE4, 16 bits
    (BI_BITFIELDS masks), 24 or 32 bits."""
    h, w = px.shape[:2]
    if comp in (1, 2):
        body = (_rle8 if comp == 1 else _rle4)(px)
    else:
        pitch = ((w * bits + 7) // 8 + 3) & ~3
        rows = px if top_down else px[::-1]
        if bits <= 8:
            b = ((rows[..., None] >> np.arange(bits - 1, -1, -1)) & 1
                 ).astype(np.uint8).reshape(h, -1)
            packed = np.packbits(b, axis=1)
        elif bits == 16:
            packed = rows.astype("<u2").view(np.uint8).reshape(h, -1)
        else:
            packed = rows.astype(np.uint8).reshape(h, -1)
        grid = np.zeros((h, pitch), np.uint8)
        grid[:, :packed.shape[1]] = packed
        body = grid.tobytes()
    pal = b""
    if palette is not None:
        pal = np.concatenate([palette[:, ::-1], np.zeros(
            (len(palette), 1), np.uint8)], 1).astype(np.uint8).tobytes()
    extra = struct.pack("<III", *masks) if masks else b""
    hdr = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bits,
                      comp, len(body), 2835, 2835, 0, 0)
    off = 14 + len(hdr) + len(extra) + len(pal)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off)
                + hdr + extra + pal + body)


# ------------------------------------------------------------- PNM writer


def write_pnm_file(path, kind: str, values: np.ndarray, maxval: int = 255):
    """P1-P6 with a comment line; text files wrapped at 7 values."""
    h, w = values.shape[:2]
    header = f"{kind}\n# a fixture\n{w} {h}\n"
    if kind not in ("P1", "P4"):
        header += f"{maxval}\n"
    flat = values.reshape(-1)
    if kind in ("P1", "P2", "P3"):
        lines = [" ".join(str(v) for v in flat[i:i + 7])
                 for i in range(0, len(flat), 7)]
        body = ("\n".join(lines) + "\n").encode()
    elif kind == "P4":
        body = np.packbits(values.astype(np.uint8), axis=1).tobytes()
    else:
        body = flat.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(header.encode() + body)


# --------------------------------------------------------------- generate


def generate(folder: str = FOLDER):
    import cv2
    from PIL import Image

    from gsplat_tpu_torch.utils.image_io import write_png

    os.makedirs(folder, exist_ok=True)
    rng = np.random.default_rng(12)
    img = fixture_image(seed=1)
    p = lambda name: os.path.join(folder, name)       # noqa: E731
    with tempfile.TemporaryDirectory() as tmp:
        jsys, jpil = _jpeg_tools(tmp)
        big = fixture_image(61, 83, seed=2)      # enough scan data to cut
        jsys(os.path.join(tmp, "base.jpg"), big, "-q", "85", "-restart",
             "2")
        jsys(os.path.join(tmp, "prog.jpg"), big, "-q", "85", "-prog")
        with open(os.path.join(tmp, "base.jpg"), "rb") as f:
            base = f.read()
        with open(os.path.join(tmp, "prog.jpg"), "rb") as f:
            prog = f.read()
        cuts = {"jpeg_cut_baseline.jpg": _cut(base, 0.5)}
        for pct in (30, 60, 90):
            cuts[f"jpeg_cut_prog_{pct}.jpg"] = _cut(prog, pct / 100)
        for name, data in cuts.items():
            with open(p(name), "wb") as f:
                f.write(data)
        jsys(p("jpeg_arith_seq.jpg"), img, "-arith", "-q", "80",
             "-restart", "3", "-dac", "1", "3", "9")
        jsys(p("jpeg_arith_prog.jpg"), img, "-arith", "-prog", "-q", "90",
             "-restart", "2")
        Image.fromarray(img).convert("CMYK").save(p("jpeg_cmyk.jpg"),
                                                  quality=90)
        cmyk = np.concatenate([img, 255 - img[..., 1:2]], axis=2)
        jsys(p("jpeg_ycck.jpg"), cmyk, "-space", "ycck", "-q", "88")
        jpil(p("jpeg_lossless_p1.jpg"), img, "-lossless", "1", "0")
        jpil(p("jpeg_lossless_p7_pt2.jpg"), img, "-lossless", "7", "2",
             "-restart", str(W * 4))
        jpil(p("jpeg_lossless_cmyk.jpg"), cmyk, "-lossless", "4", "0")
        # refused by cv2: 12-bit, hierarchical, 2 components, lossless gray
        jpil(p("jpeg_12bit.jpg"), img.astype(np.uint16) * 16, "-prec", "12")
        plain = os.path.join(tmp, "plain.jpg")
        jsys(plain, img, "-q", "85")
        with open(plain, "rb") as f:
            data = f.read()
        sof = data.index(b"\xff\xc0")            # SOF0 -> SOF5
        with open(p("jpeg_hierarchical.jpg"), "wb") as f:
            f.write(data[:sof] + b"\xff\xc5" + data[sof + 2:])
        jsys(p("jpeg_2comp.jpg"), img[..., :2], "-q", "85")
        y, x = np.mgrid[0:840, 0:1297].astype(np.float64)
        view = np.stack([128 + 90 * np.sin(x / 70 + y / 110),
                         128 + 80 * np.cos(x / 50 - y / 90),
                         128 + 70 * np.sin((x + y) / 130)], axis=2)
        view += np.random.default_rng(3).normal(0, 2, view.shape)
        jsys(p(TIMING), np.clip(np.rint(view), 0, 255).astype(np.uint8),
             "-arith", "-prog", "-q", "90", "-restart", "64")
        jpil(p("jpeg_lossless_gray.jpg"), img[..., 0], "-lossless", "1",
             "0")

    # interlaced PNG
    write_adam7_png(p("png_adam7_rgb8.png"), img, 8, 2, seed=1)
    write_adam7_png(p("png_adam7_rgb16.png"),
                    rng.integers(0, 65536, (H, W, 3)), 16, 2, seed=2)
    pal = rng.integers(0, 256, (16, 3))
    write_adam7_png(p("png_adam7_palette.png"),
                    rng.integers(0, 16, (H, W, 1)), 4, 3, palette=pal, seed=3)
    write_adam7_png(p("png_adam7_gray2.png"), rng.integers(0, 4, (H, W, 1)),
                    2, 0, seed=4)

    # TIFF
    bgr = img[..., ::-1]
    T = cv2.IMWRITE_TIFF_COMPRESSION
    cv2.imwrite(p("tiff_none.tif"), bgr, [T, 1])
    cv2.imwrite(p("tiff_lzw.tif"), bgr)
    cv2.imwrite(p("tiff_deflate.tif"), bgr, [T, 8])
    cv2.imwrite(p("tiff_adobe_deflate.tif"), bgr, [T, 32946])
    cv2.imwrite(p("tiff_packbits.tif"), bgr, [T, 32773])
    cv2.imwrite(p("tiff_lzw_16.tif"),
                rng.integers(0, 65536, (H, W, 3)).astype(np.uint16))
    cv2.imwrite(p("tiff_gray_pred.tif"),
                (img[..., 0].astype(np.uint16) * 257 + rng.integers(
                    0, 257, (H, W))).astype(np.uint16), [T, 8])
    cv2.imwrite(p("tiff_jpeg.tif"), bgr, [T, 7])
    write_jpeg_tiff(p("tiff_jpeg_ycbcr.tif"), cv2.imencode(".jpg", bgr)[1]
                    .tobytes(), H, W, (2, 2))
    write_tiff_file(p("tiff_tiled.tif"), img, compression=5, predictor=2,
                    tile=(16, 16))
    write_tiff_file(p("tiff_planar.tif"), img, compression=8, predictor=2,
                    planar=2, rows_per_strip=7)
    write_tiff_file(p("tiff_big_endian.tif"),
                    rng.integers(0, 65536, (H, W, 3)), bps=16, compression=5,
                    predictor=2, endian=">", rows_per_strip=10)
    write_tiff_file(p("tiff_palette.tif"), rng.integers(0, 256, (H, W)),
                    photometric=3, compression=5,
                    colormap=rng.integers(0, 65536, (256, 3)))
    write_tiff_file(p("tiff_gray.tif"), img[..., 1], photometric=0,
                    compression=8, predictor=2)
    write_tiff_file(p("tiff_bilevel.tif"), rng.integers(0, 2, (H, W)), bps=1)
    write_tiff_file(p("tiff_rgba_unassoc.tif"),
                    rng.integers(0, 256, (H, W, 4)), compression=5,
                    extra_samples=[2])
    write_tiff_file(p("tiff_gray_alpha.tif"), rng.integers(0, 256, (H, W, 2)),
                    extra_samples=[2])
    write_tiff_file(p("tiff_palette2.tif"), rng.integers(0, 4, (H, W)),
                    bps=2, photometric=3,
                    colormap=rng.integers(0, 65536, (4, 3)))

    # BMP
    Image.fromarray(img).convert("P").save(p("bmp_pal8.bmp"))
    smooth = ((np.arange(W)[None] // 3 + np.arange(H)[:, None] // 2)
              % 256).astype(np.int64)
    smooth[::3, ::4] = rng.integers(0, 256, smooth[::3, ::4].shape)
    write_bmp_file(p("bmp_rle8.bmp"), smooth, 8, rng.integers(
        0, 256, (256, 3)), comp=1)
    write_bmp_file(p("bmp_rle4.bmp"), smooth % 16, 4, rng.integers(
        0, 256, (16, 3)), comp=2)
    write_bmp_file(p("bmp_pal1.bmp"), rng.integers(0, 2, (H, W)), 1,
                   rng.integers(0, 256, (2, 3)))
    cv2.imwrite(p("bmp_24.bmp"), bgr)
    Image.fromarray(np.concatenate([img, img[..., :1]], 2), "RGBA").save(
        p("bmp_32.bmp"))
    write_bmp_file(p("bmp_565.bmp"), rng.integers(0, 65536, (H, W)), 16,
                   comp=3, masks=(0xF800, 0x7E0, 0x1F))
    write_bmp_file(p("bmp_top_down.bmp"), img, 24, top_down=True)

    # PNM
    write_pnm_file(p("pnm_p1.pbm"), "P1", rng.integers(0, 2, (H, W)))
    write_pnm_file(p("pnm_p4.pbm"), "P4", rng.integers(0, 2, (H, W)))
    for kind in ("p2", "p3", "p5", "p6"):
        ch = 3 if kind in ("p3", "p6") else 1
        for maxval in (255, 7, 1000):
            vals = rng.integers(0, maxval + 1, (H, W, ch))
            ext = "ppm" if ch == 3 else "pgm"
            write_pnm_file(p(f"pnm_{kind}_{maxval}.{ext}"), kind.upper(),
                           vals, maxval)

    for name in CASES:
        want = cv2.imread(p(name))
        assert want is not None, name
        write_png(p(_want(name)), np.ascontiguousarray(want[..., ::-1]))
    for name in REFUSED:
        assert cv2.imread(p(name)) is None, name
    src = fixture_image(23, 31, seed=9)
    write_png(p("enc_src.png"), src)
    for name in ENCODED:
        cv2.imwrite(p(name), src[..., ::-1])


def _want(name: str) -> str:
    return os.path.splitext(name)[0] + ".want.png"


def check(folder: str = FOLDER, scratch: str | None = None) -> dict:
    """The port's readers against the committed outputs: name -> True where
    ``read_image`` is bit for bit cv2's decode; for ``REFUSED``, where it
    raises naming the file; for ``ENCODED``, where the port's writer gives
    cv2's bytes.  ``scratch`` is a directory for the writers' files (a
    temporary one by default).  Warnings of cut-short files are expected
    and silenced."""
    import warnings

    from gsplat_tpu_torch.utils.image_io import read_image, read_png, \
        write_bmp, write_pnm, write_tiff

    out = {}
    for name in CASES:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            got = read_image(os.path.join(folder, name))
        want = read_png(os.path.join(folder, _want(name)))
        out[name] = got.shape == want.shape and bool((got == want).all())
    for name in REFUSED:
        try:
            read_image(os.path.join(folder, name))
            out[name] = False
        except (ValueError, RuntimeError) as err:
            out[name] = name in str(err)
    src = read_png(os.path.join(folder, "enc_src.png"))
    writers = {".bmp": write_bmp, ".ppm": write_pnm, ".tif": write_tiff}
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        for name in ENCODED:
            path = os.path.join(tmp, name)
            writers[os.path.splitext(name)[1]](path, src)
            with open(path, "rb") as f, \
                    open(os.path.join(folder, name), "rb") as g:
                out[name] = f.read() == g.read()
    return out


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    generate()
    result = check()
    print(result)
    sys.exit(0 if all(result.values()) else 1)
