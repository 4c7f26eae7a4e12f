"""The port's WebP writer and readers against cv2 (libwebp) on full-size
views: file sizes of ``write_webp`` and of ``cv2.imwrite``'s default
lossless WebP, and the seconds each takes to encode and decode (best of
``--reps``), one process, one thread.

    python tests/torch_webp_sizes.py [--reps 3]      # needs cv2

The views: the committed arithmetic-coded timing view
(``tests/torch_images/timing_arith_1297x840.jpg``) decoded, the same with
Gaussian noise of sigma 12 (seed 1), and the committed lossy view
(``timing_lossy_1297x840.webp``, decode only).  Not collected by pytest.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def best(fn, reps):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


def main(argv=None):
    import cv2
    import torch

    from gsplat_tpu_torch.bench import host_cpu
    from gsplat_tpu_torch.utils.image_io import read_image, read_webp, \
        write_webp

    import torch_make_image_fixtures as fx

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=3)
    a = p.parse_args(argv)
    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    view = read_image(os.path.join(fx.FOLDER, fx.TIMING))
    noisy = np.clip(view + np.random.default_rng(1).normal(0, 12, view.shape),
                    0, 255).astype(np.uint8)
    print(f"host: {host_cpu()}; {view.shape[1]}x{view.shape[0]}, best of "
          f"{a.reps}")
    with tempfile.TemporaryDirectory() as tmp:
        port, ref = os.path.join(tmp, "port.webp"), os.path.join(tmp,
                                                                 "cv2.webp")
        for name, img in (("timing view", view), ("timing view + noise",
                                                  noisy)):
            enc = best(lambda: write_webp(port, img), a.reps)
            enc_cv2 = best(lambda: cv2.imwrite(ref, img[..., ::-1]), a.reps)
            dec = best(lambda: read_webp(port), a.reps)
            dec_cv2 = best(lambda: cv2.imread(port), a.reps)
            assert (read_webp(port) == img).all()
            assert (cv2.imread(port)[..., ::-1] == img).all()
            size, size_cv2 = os.path.getsize(port), os.path.getsize(ref)
            print(f"{name:22s} lossless: write_webp {size} bytes "
                  f"({size / size_cv2:.4f} of cv2's {size_cv2}); encode "
                  f"{enc * 1e3:.1f} ms (cv2 {enc_cv2 * 1e3:.1f}); decode of "
                  f"the port's file {dec * 1e3:.1f} ms (cv2 "
                  f"{dec_cv2 * 1e3:.1f})")
    lossy = os.path.join(fx.FOLDER, fx.TIMING_WEBP)
    dec = best(lambda: read_webp(lossy), a.reps)
    dec_cv2 = best(lambda: cv2.imread(lossy), a.reps)
    print(f"{fx.TIMING_WEBP:22s} lossy ({os.path.getsize(lossy)} bytes): "
          f"decode {dec * 1e3:.1f} ms (cv2 {dec_cv2 * 1e3:.1f})")


if __name__ == "__main__":
    main()
