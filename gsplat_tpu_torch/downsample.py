"""Offline image-pyramid prep (the JAX package's root ``downsample.py``):
every PNG of ``--src`` shrunk by a whole-number ``--factor`` into ``--dst``.

    python -m gsplat_tpu_torch.downsample --src colmap_garden/images_2 \\
        --dst colmap_garden/images_4 --factor 2

The JAX script resizes with ``cv2.resize(..., INTER_AREA)``; the port has no
cv2 and averages each ``factor`` x ``factor`` block itself (PNG in and out
through ``utils/image_io``).  The output is ``round(H / factor)`` by
``round(W / factor)``, as cv2 sizes it; a block cut off by the image's edge
averages the pixels it holds.  Means are rounded as cv2 rounds them: half
to even, except whole 2 x 2 blocks, which its fast path rounds half up.
Files that are not PNG are skipped, as the JAX script skips files cv2
cannot read.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from gsplat_tpu_torch.utils.image_io import read_png, write_png


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
        description="shrink every PNG of a folder by a whole-number factor")
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
        if not fn.lower().endswith(".png"):
            continue
        write_png(os.path.join(a.dst, os.path.basename(fn)),
                  downsample_area(read_png(fn), a.factor))
        print(os.path.basename(fn))


if __name__ == "__main__":
    main()
