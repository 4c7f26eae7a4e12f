"""Synthetic scenes for benchmarking and checks (no dataset needed).

The generators of ``gsplat_tpu/synthetic.py``, with numpy doing all the
random draws in the same order: the same seed gives bit-identical arrays in
both packages.  Gaussian statistics give realistic pair counts (a few tiles
per gaussian); the bench scene is ~506k gaussians at 1297x840.
"""

from __future__ import annotations

import numpy as np
import torch

from gsplat_tpu_torch.models.camera import TileGrid, ray_info
from gsplat_tpu_torch.models.gaussians import GaussianTable, table_from_numpy
from gsplat_tpu_torch.ops.sh import C0, SH_DIM, initialize_sh
from gsplat_tpu_torch.utils.so3 import inverse_sigmoid, quat_to_rotmat_np


def synthetic_table(n: int, capacity_round: int = 65536, use_sh=False,
                    seed: int = 0, depth_range=(2.0, 8.0),
                    frustum=(0.65, 0.45), scale_px=2.5, focal=1000.0,
                    opa=0.5, headroom: float = 1.15, ball=None,
                    sh_ampl: float = 0.0, device="cpu") -> GaussianTable:
    """Random gaussian table.

    Default layout fills the frustum of a camera at the origin looking +z.
    ``ball=(cx, cy, cz, r, view_dist)`` instead fills a sphere (orbit-camera
    scenes); ``view_dist`` sets the on-screen splat size.  ``use_sh`` gives
    27 SH coefficients with the colors as DC terms; ``sh_ampl`` > 0 adds
    random degree-1/2 coefficients (view-dependent color).
    """
    rng = np.random.default_rng(seed)
    if ball is not None:
        cx, cy, cz, r, view_dist = ball
        u = rng.normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-9
        rad = r * rng.uniform(0.0, 1.0, n) ** (1 / 3)
        pos = (np.array([cx, cy, cz]) + u * rad[:, None]).astype(np.float32)
        dist = np.full((n,), view_dist, np.float32)
    else:
        z = rng.uniform(*depth_range, n)
        x = rng.uniform(-frustum[0], frustum[0], n) * z
        y = rng.uniform(-frustum[1], frustum[1], n) * z
        pos = np.stack([x, y, z], 1).astype(np.float32)
        dist = z
    # world-space scale giving ~scale_px pixels on screen at given focal
    scale = (rng.uniform(0.5, 1.5, (n, 3)) * scale_px * dist[:, None]
             / focal).astype(np.float32)
    quat = rng.normal(size=(n, 4)).astype(np.float32)
    rgb01 = rng.uniform(0.05, 0.95, (n, 3))
    rgb = (-np.log(1.0 / rgb01 - 1.0)).astype(np.float32)
    if use_sh:
        rgb = initialize_sh(torch.from_numpy(rgb)).numpy()
        if sh_ampl:
            hi = rng.normal(0.0, sh_ampl, (n, 3, 9)).astype(np.float32)
            hi[:, :, 0] = 0.0
            rgb = rgb + hi.reshape(n, 27)

    cap = max(int(np.ceil(n * headroom / capacity_round)) * capacity_round,
              capacity_round)

    def pad(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    quat_p = np.zeros((cap, 4), np.float32)
    quat_p[:, 0] = 1
    quat_p[:n] = quat
    live = np.zeros((cap,), bool)
    live[:n] = True
    return table_from_numpy({
        "pos": pad(pos), "rgb": pad(rgb),
        "opa": pad(np.full((n,), inverse_sigmoid(opa), np.float32),
                   fill=inverse_sigmoid(1e-4)),
        "quat": quat_p, "scale": pad(scale), "live": live,
    }, n, device)


def synthetic_cameras(m: int, width: int, height: int, focal: float,
                      tile_h=16, tile_w=16, seed: int = 0,
                      with_images=True, device="cpu"):
    """Ring of slightly perturbed cameras near the origin looking +z."""
    rng = np.random.default_rng(seed)
    grid = TileGrid(width=width, height=height, focal_x=focal, focal_y=focal,
                    tile_h=tile_h, tile_w=tile_w)
    rots, trans, shvs = [], [], []
    for i in range(m):
        angle = 0.05 * np.sin(2 * np.pi * i / max(m, 1))
        q = np.array([np.cos(angle / 2), 0.0, np.sin(angle / 2), 0.0])
        rot = quat_to_rotmat_np(q)
        tran = np.array([0.05 * (i % 5 - 2), 0.03 * (i % 3 - 1), 0.0])
        rots.append(rot)
        trans.append(tran)
        shvs.append(np.stack(list(ray_info(
            rot, tran, grid.padded_height, grid.padded_width,
            focal, focal).values())))
    images = None
    if with_images:
        # channel-major, matching the render pipeline layout
        images = torch.from_numpy(
            rng.integers(0, 255, (m, 3, height, width), dtype=np.uint8)
        ).to(device)

    def dev(a):
        return torch.from_numpy(np.stack(a).astype(np.float32)).to(device)

    return {
        "w2c_rot": dev(rots),
        "w2c_tran": dev(trans),
        "sh_vecs": dev(shvs),
        "images": images,
        "grid": grid,
    }


def image_space_pairs(seed: int, n: int = 420, n_tile_x: int = 4,
                      n_tile_y: int = 3, focal: float = 40.0, wide=True,
                      crowd: int | None = None):
    """Image-space gaussians on a small grid of 16-px tiles, for checking
    the compositor (numpy arrays, the inputs of ``pack_sorted``).

    The gaussians lie in the left three tile columns only (the right column
    stays empty); ``crowd`` of them (default n // 2) crowd into tile (0, 0),
    which then holds more pairs than the crowd (> 128 by default; 372 with
    n=640, crowd=320, two 256-pair kernel batches); a few wide ones cover
    more than K tiles, some are invisible and one has a degenerate
    (det <= 0) covariance.  Returns
    ``geom (n, 8)``, ``color (n, 3)``, ``depth (n,)``, ``visible (n,)`` and
    the grid geometry as ``BinningSpec`` keywords.
    """
    rng = np.random.default_rng(seed)
    crowd = n // 2 if crowd is None else crowd
    tile = 16
    w, h = n_tile_x * tile, n_tile_y * tile
    px = np.where(np.arange(n) < crowd, rng.uniform(3, 13, n),
                  rng.uniform(3, 35, n))
    py = np.where(np.arange(n) < crowd, rng.uniform(3, 13, n),
                  rng.uniform(3, h - 3, n))
    sig = rng.uniform(0.8, 4.0, (n, 2))
    if wide:
        sig[:8] = [14.0, 9.0]                   # bbox > K tiles
    theta = rng.uniform(0, np.pi, n)
    ct, st = np.cos(theta), np.sin(theta)
    rot = np.stack([np.stack([ct, -st], -1), np.stack([st, ct], -1)], -2)
    cov = np.einsum("nij,nj,nkj->nik", rot, (sig / focal) ** 2, rot)
    cov = cov.reshape(n, 4)
    cov[9] = [1e-3, 2e-3, 2e-3, 1e-3]           # det < 0
    mean2d = np.stack([(px - w / 2) / focal, (py - h / 2) / focal], 1)
    geom = np.concatenate([mean2d, cov, rng.uniform(0.05, 0.99, (n, 1)),
                           np.zeros((n, 1))], 1).astype(np.float32)
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    depth = rng.uniform(1.0, 10.0, n).astype(np.float32)
    depth[20:30] = depth[10]                    # ties keep table order
    visible = rng.uniform(size=n) > 0.1
    geo = dict(n_tile_x=n_tile_x, n_tile_y=n_tile_y,
               tile_len_x=tile / focal, tile_len_y=tile / focal,
               leftmost=-w / 2 / focal, topmost=-h / 2 / focal)
    return geom, color, depth, visible, geo


def image_space_sh(seed: int, color: np.ndarray, geo: dict,
                   focal: float = 40.0, ampl: float = 0.35):
    """SH color for the gaussians of :func:`image_space_pairs`: (n, 27)
    coefficients whose DC terms give their ``color`` and whose higher bands
    are random (σ = ``ampl``), and the ``sh_vecs`` (4, 3) of a camera at
    the origin looking +z over the same grid."""
    rng = np.random.default_rng(seed + 1000)
    n = color.shape[0]
    c = np.clip(color, 0.02, 0.98)
    coef = rng.normal(0.0, ampl, (n, 3, SH_DIM))
    coef[:, :, 0] = np.log(c / (1.0 - c)) / C0
    tile = 16
    shv = np.stack(list(ray_info(
        np.eye(3), np.zeros(3), geo["n_tile_y"] * tile,
        geo["n_tile_x"] * tile, focal, focal).values()))
    return (coef.reshape(n, 3 * SH_DIM).astype(np.float32),
            shv.astype(np.float32))
