"""Shared image-space scenes for the gsplat_tpu_torch parity tests.

``image_space_pairs`` lives in ``gsplat_tpu_torch.synthetic`` so that
``chip_smoke.py`` checks the kernels on the same scenes as the tests.
"""

import numpy as np

from gsplat_tpu_torch.synthetic import image_space_pairs  # noqa: F401
from gsplat_tpu_torch.synthetic import image_space_sh

TILE = 16
# a crowd whose tile holds more than 256 pairs: six staged batches of
# either kernel
BIG_CROWD = dict(n=640, crowd=320)
# csrc/rasterize_bwd.cu stages kBatch = 64 pairs at a time and sums them in
# rounds of kSub = 32; csrc/rasterize_fwd.cu stages kBatch = 64 pairs too
BWD_BATCH, BWD_ROUND = 64, 32
FWD_BATCH = 64
# pairs per tile of ragged_pairs' 2 x 2 grid: one pair, one more than a
# staged batch (of either kernel), none, one more than a round
RAGGED_COUNTS = (1, BWD_BATCH + 1, 0, BWD_ROUND + 1)


def ragged_pairs(seed, tile, focal=40.0, sh=False):
    """Pairs already grouped by tile (the layout of ``pack_sorted``'s
    output): ``RAGGED_COUNTS[t]`` gaussians centred inside tile t of a
    2 x 2 grid of ``tile``-px tiles, 0.8-4 px wide (scaled by
    ``tile / 16``).
    → ``(geom (P, 8), color (P, 3) or SH (P, 27), tile_start (5,) int32,
    geo, sh_vecs (4, 3) or None)``, numpy."""
    rng = np.random.default_rng(seed)
    s = tile / 16
    n = sum(RAGGED_COUNTS)
    t = np.repeat(np.arange(len(RAGGED_COUNTS)), RAGGED_COUNTS)
    px = (t % 2 + rng.uniform(0.1, 0.9, n)) * tile
    py = (t // 2 + rng.uniform(0.1, 0.9, n)) * tile
    sig = rng.uniform(0.8, 4.0, (n, 2)) * s
    theta = rng.uniform(0, np.pi, n)
    ct, st = np.cos(theta), np.sin(theta)
    rot = np.stack([np.stack([ct, -st], -1), np.stack([st, ct], -1)], -2)
    cov = np.einsum("nij,nj,nkj->nik", rot, (sig / focal) ** 2, rot)
    mean2d = np.stack([(px - tile) / focal, (py - tile) / focal], 1)
    geom = np.concatenate([mean2d, cov.reshape(n, 4),
                           rng.uniform(0.05, 0.99, (n, 1)),
                           np.zeros((n, 1))], 1).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    tile_start = np.concatenate([[0], np.cumsum(RAGGED_COUNTS)]).astype(
        np.int32)
    geo = dict(n_tile_x=2, n_tile_y=2, tile_len_x=tile / focal,
               tile_len_y=tile / focal, leftmost=-tile / focal,
               topmost=-tile / focal)
    shv = None
    if sh:
        color, shv = image_space_sh(seed, color, geo, focal, tile=tile)
    return geom, color, tile_start, geo, shv


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
