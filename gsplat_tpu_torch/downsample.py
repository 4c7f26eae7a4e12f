"""Offline image-pyramid prep (the JAX package's root ``downsample.py``):
every image of ``--src`` resized by ``1 / --factor`` into ``--dst`` under its
own name.

    python -m gsplat_tpu_torch.downsample --src colmap_garden/images_2 \\
        --dst colmap_garden/images_4 --factor 2
    python -m gsplat_tpu_torch.downsample --src images --dst images_1.5 \\
        --factor 1.5

The JAX script resizes with ``cv2.resize(img, None, fx=1/f, fy=1/f,
interpolation=INTER_AREA)``; the port has no cv2 and computes the same
pixels, bit for bit, for any finite factor f > 0.  The output is
``cvRound(H * (1/f))`` by ``cvRound(W * (1/f))`` (ties to even); where a
side rounds to 0 cv2 asserts, and so the port raises.  An output of the
input's size is the input.  Otherwise, with ``scale = 1 / (1/f)``, cv2's
three regimes:

* a whole scale (within DBL_EPSILON of an integer: f = 2, 3, 4, ...): each
  output pixel the mean of its f x f block (the part inside the image),
  rounded half to even, but whole 2 x 2 blocks, which cv2's fast path
  rounds half up;
* a shrink by any other scale > 1 (f = 1.5, 2.25, ...): cv2's
  ``resizeArea_``, each source pixel weighted by the share of it that an
  output cell covers, summed in f32 in cv2's order;
* an enlargement (f < 1): cv2's linear resize with INTER_AREA's weights in
  11-bit fixed point.

Images are read by their signature and written by their name's extension,
as cv2 reads and writes them (``utils/image_io``): a ``.jpg`` / ``.jpeg`` /
``.jpe`` name gets the bytes of ``cv2.imwrite``'s default JPEG, a ``.png``
name an 8-bit PNG, ``.tif`` / ``.tiff`` cv2's LZW TIFF, ``.bmp`` / ``.dib``
its 24-bit BMP, ``.ppm`` / ``.pnm`` its binary PPM, ``.webp`` a lossless
(VP8L) WebP, the kind cv2 writes by default (its pixels, not libwebp's
bytes), ``.gif`` its dithered 3-3-2 GIF, ``.hdr`` / ``.pic`` its run-length
Radiance file, ``.pfm`` its float PFM, ``.pam`` its PAM, ``.ras`` / ``.sr``
its 24-bit Sun raster (the last row's pad byte 0, where cv2 copies a byte
from past its image) and ``.jp2`` its default JPEG 2000 file (one layer at
rate 4).  cv2 writes no color ``.pgm`` or ``.pbm`` and no ``.jp2`` with a
side under 32 (the JAX script's ``imwrite`` returns False there), so the
port writes none either, names the file on stderr and carries on; nor does
this cv2 write ``.im1``, ``.im8``, ``.im24``, ``.im32`` or ``.rs`` (its
``imwrite`` raises), so those names are skipped.  A file that does not
decode is skipped, as the JAX script skips files cv2 cannot read, and so is
a name of an extension the port does not write; each skipped file is named
on stderr.  An image too small for the factor (a side that rounds to 0)
ends the run as it ends the JAX script: the files before it are written,
the file is named on stderr and the exit code is not 0.
"""

from __future__ import annotations

import argparse
import glob
import math
import os
import sys

import numpy as np

from gsplat_tpu_torch.utils.image_io import read_image, write_bmp, \
    write_gif, write_hdr, write_jpeg, write_jpeg2000, write_pam, write_pfm, \
    write_png, write_pnm, write_sunras, write_tiff, write_webp

_WRITERS = {".jpg": write_jpeg, ".jpeg": write_jpeg, ".jpe": write_jpeg,
            ".png": write_png, ".tif": write_tiff, ".tiff": write_tiff,
            ".bmp": write_bmp, ".dib": write_bmp, ".ppm": write_pnm,
            ".pnm": write_pnm, ".pgm": write_pnm, ".pbm": write_pnm,
            ".webp": write_webp, ".gif": write_gif, ".hdr": write_hdr,
            ".pic": write_hdr, ".pfm": write_pfm, ".pam": write_pam,
            ".ras": write_sunras, ".sr": write_sunras,
            # cv2's default: one layer at rate 4 (X1000 = 250)
            ".jp2": lambda path, img: write_jpeg2000(path, img, 250)}
_COEF_SCALE = 2048                # INTER_RESIZE_COEF_SCALE: 11-bit weights


def downsample_area(img: np.ndarray, factor) -> np.ndarray:
    """(H, W, C) uint8 → what ``cv2.resize(img, None, fx=1/f, fy=1/f,
    interpolation=INTER_AREA)`` gives, bit for bit, for any finite f > 0
    (the module's docstring lists the regimes).  Raises ``ValueError``
    naming the sizes where a side rounds to 0 (cv2 asserts there) and
    naming the factor where it is not finite and positive."""
    f = float(factor)
    if not math.isfinite(f) or f <= 0:
        raise ValueError(f"downsample: the factor must be a finite number "
                         f"> 0, got {factor!r}")
    inv = 1.0 / f
    h, w = img.shape[:2]
    oh, ow = round(h * inv), round(w * inv)        # cvRound: ties to even
    if oh == 0 or ow == 0:
        raise ValueError(f"downsample: a {w}x{h} image at factor {factor!r} "
                         f"would be {ow}x{oh} (cv2.resize asserts "
                         f"!dsize.empty())")
    if (oh, ow) == (h, w):
        return img.copy()
    src = img.reshape(h, w, -1)
    scale = 1.0 / inv
    if scale >= 1:
        iscale = round(scale)
        if abs(scale - iscale) < sys.float_info.epsilon:
            out = _area_whole(src, iscale, oh, ow)
        else:
            out = _area_fraction(src, scale, oh, ow)
    else:
        out = _area_enlarge(src, scale, inv, oh, ow)
    return out.reshape((oh, ow) + img.shape[2:])


def _area_whole(img, f, oh, ow):
    """cv2's is_area_fast: each output pixel the mean of its f x f block
    (the part inside the image), rounded half to even, but whole 2 x 2
    blocks half up."""
    h, w = img.shape[:2]
    ph, pw = oh * f, ow * f
    src = np.zeros((ph, pw, img.shape[2]), np.float64)
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
    return np.clip(out, 0, 255).astype(np.uint8)


def _area_tab(ssize, dsize, scale):
    """computeResizeAreaTab: the (output, source, weight) entries in cv2's
    order; the weights in double, then f32."""
    di, si, alpha = [], [], []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx2 = min(math.floor(fsx2), ssize - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        taps = [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if sx1 - fsx1 > 1e-3:             # the part of the pixel before
            taps.insert(0, (sx1 - 1, (sx1 - fsx1) / cell))
        if fsx2 - sx2 > 1e-3:             # and after the whole ones
            taps.append((sx2, min(fsx2 - sx2, 1.0, cell) / cell))
        for sx, a in taps:
            di.append(dx)
            si.append(sx)
            alpha.append(a)
    di = np.array(di)
    # each entry's rank among its output's: the slots, taken in turn, keep
    # cv2's order of accumulation
    first = np.r_[0, np.flatnonzero(np.diff(di)) + 1]
    slot = np.arange(len(di)) - np.repeat(first, np.diff(np.r_[first,
                                                                len(di)]))
    return di, np.array(si), np.array(alpha).astype(np.float32), slot


def _area_fraction(img, scale, oh, ow):
    """cv2's resizeArea_ (a shrink by a factor that is not whole): per
    source row the f32 sums of its weighted pixels into each output column,
    then per output row the f32 sum of the weighted source rows, in the
    tables' order, rounded half to even."""
    h, w, c = img.shape
    xd, xs, xa, xslot = _area_tab(w, ow, scale)
    yd, ys, ya, yslot = _area_tab(h, oh, scale)
    src = img.astype(np.float32)
    rows = np.zeros((h, ow, c), np.float32)
    for m in range(xslot.max() + 1):
        k = xslot == m
        rows[:, xd[k]] += src[:, xs[k]] * xa[k][None, :, None]
    out = np.zeros((oh, ow, c), np.float32)
    for m in range(yslot.max() + 1):
        k = yslot == m
        term = ya[k][:, None, None] * rows[ys[k]]
        if m == 0:
            out[yd[k]] = term
        else:
            out[yd[k]] += term
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _linear_taps(n_out, scale, inv, n_in=None):
    """INTER_AREA's weights where it enlarges: each output's first tap and
    its two 11-bit weights.  With ``n_in`` (the columns), a tap past the
    last pair is the edge pixel at full weight, and the first such output
    is returned too (cv2's xmax); the rows have no such clamp."""
    d = np.arange(n_out)
    s = np.floor(d * scale).astype(np.int64)
    frac = ((d + 1) - (s + 1) * inv).astype(np.float32)
    frac = np.where(frac <= 0, np.float32(0),
                    frac - np.floor(frac)).astype(np.float32)
    xmax = n_out
    if n_in is not None:
        edge = s >= n_in - 1
        xmax = int(np.argmax(edge)) if edge.any() else n_out
        s = np.where(edge, n_in - 1, s)
        frac = np.where(edge, np.float32(0), frac).astype(np.float32)
    w0 = np.rint((np.float32(1) - frac) * np.float32(_COEF_SCALE))
    w1 = np.rint(frac * np.float32(_COEF_SCALE))
    return s, w0.astype(np.int32), w1.astype(np.int32), xmax


def _area_enlarge(img, scale, inv, oh, ow):
    """cv2's linear resize with INTER_AREA's weights (an enlargement): the
    rows in 11-bit fixed point, the columns in its 8-bit vertical pass
    (each row sum >> 4, times the weight >> 16, the sum + 2 >> 2; its SIMD
    body and scalar tail agree)."""
    h, w, _ = img.shape
    sx, a0, a1, xmax = _linear_taps(ow, scale, inv, n_in=w)
    px = img.astype(np.int32)
    rows = px[:, sx] * a0[None, :, None] + \
        px[:, np.minimum(sx + 1, w - 1)] * a1[None, :, None]
    rows[:, xmax:] = px[:, sx[xmax:]] * _COEF_SCALE
    rows >>= 4
    sy, b0, b1, _ = _linear_taps(oh, scale, inv)
    out = rows[np.clip(sy, 0, h - 1)]
    out *= b0[:, None, None]
    out >>= 16
    bottom = rows[np.clip(sy + 1, 0, h - 1)]
    bottom *= b1[:, None, None]
    bottom >>= 16
    out += bottom
    out += 2
    out >>= 2
    return out.astype(np.uint8)


def build_argparser():
    p = argparse.ArgumentParser(
        description="resize every image of a folder by 1 / factor, as "
                    "cv2.resize(..., INTER_AREA) does")
    p.add_argument("--src", default="colmap_garden/images_2")
    p.add_argument("--dst", default="colmap_garden/images_4")
    p.add_argument("--factor", type=float, default=2.0)
    return p


def main(argv=None):
    a = build_argparser().parse_args(argv)
    if not math.isfinite(a.factor) or a.factor <= 0:
        raise SystemExit(f"--factor must be a finite number > 0, got "
                         f"{a.factor}")
    os.makedirs(a.dst, exist_ok=True)
    for fn in sorted(glob.glob(os.path.join(a.src, "*"))):
        name = os.path.basename(fn)
        writer = _WRITERS.get(os.path.splitext(name)[1].lower())
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
            small = downsample_area(img, a.factor)
        except ValueError as e:       # cv2.resize asserts: the run ends
            raise SystemExit(f"{fn}: {e}") from None
        try:
            writer(os.path.join(a.dst, name), small)
        except ValueError as e:       # cv2's imwrite returns False
            print(f"not written {name}: {e}", file=sys.stderr)
            continue
        print(name)


if __name__ == "__main__":
    main()
