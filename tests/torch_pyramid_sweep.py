"""A wider sweep than the tier-1 tests of the pyramid's two cv2 twins, on
the CPU (not collected by pytest; needs cv2 and the system libopenjp2):

    python tests/torch_pyramid_sweep.py [--seconds 120] [--seed 0]

1. ``downsample_area(img, f)`` against ``cv2.resize(img, None, fx=1/f,
   fy=1/f, interpolation=INTER_AREA)``: random sizes (1-200 a side),
   random factors (0.2-9, log-uniform; one in five rounded to a tenth, so
   that whole factors come up), noise and smooth images; where cv2 asserts
   (a side rounds to 0) the port must raise.
2. ``write_jpeg2000(path, img, x)`` against ``cv2.imwrite(path, bgr,
   [IMWRITE_JPEG2000_COMPRESSION_X1000, x])``: random sizes (32-200 a
   side), x in 1-1000, noise, smooth, flat-with-a-patch and random-walk
   images, byte for byte; beside it, whether the system libopenjp2 (2.5.0)
   at ``layers=[1000 / x]`` gives cv2's (2.5.3's) codestream.

Each half gets half the seconds.  Prints one JSON line of counts; exits 1
on any mismatch of the port.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_make_image_fixtures as fx  # noqa: E402

from gsplat_tpu_torch.downsample import downsample_area  # noqa: E402
from gsplat_tpu_torch.utils.image_io import write_jpeg2000  # noqa: E402


def sweep_resize(cv2, rng, seconds):
    n = bad = refused = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        f = float(np.exp(rng.uniform(np.log(0.2), np.log(9))))
        if n % 5 == 0:
            f = max(round(f, 1), 0.2)
        h, w = (int(v) for v in rng.integers(1, 201, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        if n % 2:
            img = np.clip(np.cumsum(img.astype(int) - 127, axis=1) // 8
                          + 128, 0, 255).astype(np.uint8)
        n += 1
        try:
            want = cv2.resize(img, None, fx=1 / f, fy=1 / f,
                              interpolation=cv2.INTER_AREA)
        except cv2.error:
            refused += 1
            try:
                downsample_area(img, f)
                bad += 1
                print(f"resize {h}x{w} f={f!r}: cv2 asserts, the port "
                      f"does not", flush=True)
            except ValueError:
                pass
            continue
        got = downsample_area(img, f)
        if got.shape != want.shape or (got != want).any():
            bad += 1
            print(f"resize {h}x{w} f={f!r}: differs", flush=True)
    return {"cases": n, "cv2_asserts": refused, "mismatches": bad}


def _image(rng, h, w, kind):
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        return fx.fixture_image(h, w, seed=int(rng.integers(1 << 20)))
    if kind == 2:
        img = np.full((h, w, 3), rng.integers(256), np.uint8)
        y, x = int(rng.integers(h)), int(rng.integers(w))
        img[y:y + 20, x:x + 30] = rng.integers(0, 256, 3)
        return img
    walk = np.cumsum(rng.normal(0, 6, (h, w, 3)), axis=1) + 128
    return np.clip(walk, 0, 255).astype(np.uint8)


def sweep_jp2(cv2, rng, seconds, tmp):
    n = bad = truncated = differs_250 = 0
    cv_path, port_path = os.path.join(tmp, "c.jp2"), os.path.join(tmp,
                                                                  "p.jp2")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        h, w = (int(v) for v in rng.integers(32, 201, 2))
        img = _image(rng, h, w, n % 4)
        x = int(rng.integers(1, 1001))
        n += 1
        assert cv2.imwrite(cv_path, np.ascontiguousarray(img[..., ::-1]),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x])
        write_jpeg2000(port_path, img, x)
        with open(cv_path, "rb") as f, open(port_path, "rb") as g:
            want, got = f.read(), g.read()
        if got != want:
            bad += 1
            print(f"jp2 {h}x{w} kind {n % 4} x1000={x}: {len(got)} bytes, "
                  f"cv2 {len(want)}", flush=True)
        write_jpeg2000(port_path, img)
        truncated += os.path.getsize(port_path) > len(got)
        if x < 1000:
            old = fx.openjpeg_encode([img[..., k] for k in range(3)],
                                     jp2=True, layers=[1000 / x])
            cs = want[want.find(b"\xff\x4f"):].replace(b"2.5.3", b"2.5.0")
            differs_250 += old[old.find(b"\xff\x4f"):] != cs
    return {"cases": n, "shorter_than_lossless": truncated,
            "mismatches": bad, "libopenjp2_2.5.0_differs": differs_250}


def main():
    import cv2

    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=120.0)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    rng = np.random.default_rng(a.seed)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"resize": sweep_resize(cv2, rng, a.seconds / 2),
               "jp2": sweep_jp2(cv2, rng, a.seconds / 2, tmp)}
    print(json.dumps(out))
    sys.exit(1 if out["resize"]["mismatches"] or out["jp2"]["mismatches"]
             else 0)


if __name__ == "__main__":
    main()
