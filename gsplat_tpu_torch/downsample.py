"""Offline image-pyramid prep (the JAX package's root ``downsample.py``):
every image of ``--src`` shrunk by a whole-number ``--factor`` into ``--dst``
under its own name.

    python -m gsplat_tpu_torch.downsample --src colmap_garden/images_2 \\
        --dst colmap_garden/images_4 --factor 2

The JAX script resizes with ``cv2.resize(..., INTER_AREA)``; the port has no
cv2 and averages each ``factor`` x ``factor`` block itself.  Images are read
by their signature and written by their name's extension, as cv2 reads and
writes them (``utils/image_io``): a ``.jpg`` / ``.jpeg`` / ``.jpe`` name gets
the bytes of ``cv2.imwrite``'s default JPEG, a ``.png`` name an 8-bit PNG,
``.tif`` / ``.tiff`` cv2's LZW TIFF, ``.bmp`` / ``.dib`` its 24-bit BMP,
``.ppm`` / ``.pnm`` its binary PPM, ``.webp`` a lossless (VP8L) WebP,
the kind cv2 writes by default (its pixels, not libwebp's bytes), ``.gif``
its dithered 3-3-2 GIF, ``.hdr`` / ``.pic`` its run-length Radiance file,
``.pfm`` its float PFM, ``.pam`` its PAM and ``.ras`` / ``.sr`` its 24-bit
Sun raster (the last row's pad byte 0, where cv2 copies a byte from past
its image).  A ``.jp2`` name is skipped: cv2 writes it at rate 4 through
OpenJPEG's rate allocation, which the port has not ported (its
``write_jpeg2000`` is cv2's lossless setting, other pixels).  cv2 writes
no color ``.pgm`` or ``.pbm`` (the JAX script's
``imwrite`` returns False there), so the port writes none either and names
the file on stderr; nor does this cv2 write ``.im1``, ``.im8``, ``.im24``,
``.im32`` or ``.rs`` (its ``imwrite`` raises), so those names are skipped.
The output is ``round(H / factor)`` by ``round(W / factor)``, as cv2 sizes
it; a block cut off by the image's edge
averages the pixels it holds.  Means are rounded as cv2 rounds them: half
to even, except whole 2 x 2 blocks, which its fast path rounds half up.
A file that does not decode is skipped, as the JAX script skips files cv2
cannot read, and so is a name of an extension the port does not write;
each skipped file is named on stderr.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from gsplat_tpu_torch.utils.image_io import read_image, write_bmp, \
    write_gif, write_hdr, write_jpeg, write_pam, write_pfm, write_png, \
    write_pnm, write_sunras, write_tiff, write_webp

_WRITERS = {".jpg": write_jpeg, ".jpeg": write_jpeg, ".jpe": write_jpeg,
            ".png": write_png, ".tif": write_tiff, ".tiff": write_tiff,
            ".bmp": write_bmp, ".dib": write_bmp, ".ppm": write_pnm,
            ".pnm": write_pnm, ".pgm": write_pnm, ".pbm": write_pnm,
            ".webp": write_webp, ".gif": write_gif, ".hdr": write_hdr,
            ".pic": write_hdr, ".pfm": write_pfm, ".pam": write_pam,
            ".ras": write_sunras, ".sr": write_sunras}
# extensions cv2 writes with a writer the port does not have yet
_UNPORTED_WRITERS = {".jp2": "cv2's default (rate-4) JPEG 2000 writer is "
                             "not ported yet"}


def downsample_area(img: np.ndarray, factor) -> np.ndarray:
    """(H, W, C) uint8 → (round(H / f), round(W / f), C) uint8, each output
    pixel the mean of its f x f source block (the part inside the image)."""
    f = float(factor)
    if f != int(f) or f < 1:
        raise ValueError(f"downsample: the factor must be a whole number "
                         f">= 1, got {factor!r}")
    f = int(f)
    h, w = img.shape[:2]
    # cv2's size: the nearest integer, ties to even (cvRound)
    oh, ow = max(int(np.rint(h / f)), 1), max(int(np.rint(w / f)), 1)
    ph, pw = oh * f, ow * f
    src = np.zeros((ph, pw) + img.shape[2:], np.float64)
    cnt = np.zeros((ph, pw), np.float64)
    hh, ww = min(h, ph), min(w, pw)
    src[:hh, :ww] = img[:hh, :ww]
    cnt[:hh, :ww] = 1.0
    total = src.reshape(oh, f, ow, f, -1).sum(axis=(1, 3))
    n = cnt.reshape(oh, f, ow, f).sum(axis=(1, 3))[..., None]
    mean = total / n
    out = np.rint(mean)
    if f == 2:
        whole = np.broadcast_to(n == 4, mean.shape)
        out[whole] = np.floor(mean[whole] + 0.5)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(
        (oh, ow) + img.shape[2:])


def build_argparser():
    p = argparse.ArgumentParser(
        description="shrink every image of a folder by a whole-number factor")
    p.add_argument("--src", default="colmap_garden/images_2")
    p.add_argument("--dst", default="colmap_garden/images_4")
    p.add_argument("--factor", type=float, default=2.0)
    return p


def main(argv=None):
    a = build_argparser().parse_args(argv)
    if a.factor != int(a.factor) or a.factor < 1:
        raise SystemExit(f"--factor must be a whole number >= 1, got "
                         f"{a.factor}")
    os.makedirs(a.dst, exist_ok=True)
    for fn in sorted(glob.glob(os.path.join(a.src, "*"))):
        name = os.path.basename(fn)
        ext = os.path.splitext(name)[1].lower()
        writer = _WRITERS.get(ext)
        if ext in _UNPORTED_WRITERS:
            print(f"skipped {fn}: {_UNPORTED_WRITERS[ext]}", file=sys.stderr)
            continue
        if writer is None:
            print(f"skipped {fn}: not a name of an extension the port "
                  f"writes ({' '.join(sorted(_WRITERS))})", file=sys.stderr)
            continue
        try:
            img = read_image(fn)
        except (OSError, RuntimeError, ValueError) as e:
            print(f"skipped {fn}: {e}", file=sys.stderr)
            continue
        try:
            writer(os.path.join(a.dst, name), downsample_area(img, a.factor))
        except ValueError as e:       # a color .pgm / .pbm: cv2 writes none
            print(f"not written {name}: {e}", file=sys.stderr)
            continue
        print(name)


if __name__ == "__main__":
    main()
