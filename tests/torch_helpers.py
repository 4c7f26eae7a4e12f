"""Shared image-space scenes for the gsplat_tpu_torch parity tests.

``image_space_pairs`` lives in ``gsplat_tpu_torch.synthetic`` so that
``chip_smoke.py`` checks the kernels on the same scenes as the tests.
"""

import numpy as np

from gsplat_tpu_torch.synthetic import image_space_pairs  # noqa: F401

TILE = 16
# a crowd whose tile holds more than 256 pairs: two batches of the kernels
BIG_CROWD = dict(n=640, crowd=320)


def assert_close_cols(a, b, atol_frac, rtol, what=""):
    """|a − b| ≤ atol_frac·colmax(b) + rtol·|b|, column by column: gradients
    of the focal-normalised covariance reach ~1e3 on these scenes while
    other entries sum to ~0 over a tile, so an absolute tolerance is stated
    as a fraction of each column's largest magnitude."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bound = atol_frac * np.abs(b).max(axis=0, keepdims=True) \
        + rtol * np.abs(b)
    worst = (np.abs(a - b) / np.maximum(bound, 1e-30)).max()
    assert (np.abs(a - b) <= bound).all(), f"{what}: {worst:.3g} x bound"
