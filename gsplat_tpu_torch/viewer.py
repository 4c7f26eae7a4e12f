"""Headless rendering of arbitrary cameras (the viewer's render path).

``render_offscreen`` is ``gsplat_tpu/viewer.py:62-161``: any pose,
resolution and focal, with optional near/far clip planes applied through the
live mask, the SH order slider's band mask, and the Fast Mode render preset.
The viser server (``run_viewer``) is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gsplat_tpu_torch.models.camera import TileGrid, ray_info
from gsplat_tpu_torch.models.splatter import make_specs, render_cropped
from gsplat_tpu_torch.ops.projection import world_to_camera
from gsplat_tpu_torch.ops.sh import SH_DIM
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat_np

# SH band sizes: order o keeps the first o^2 of the 9 deg-2 coefficients
_SH_COEFFS_PER_ORDER = {1: 1, 2: 4, 3: 9, 4: 9}


def camera_to_w2c(wxyz: np.ndarray, position: np.ndarray) -> np.ndarray:
    """viser camera (c2w quaternion + position) → 4x4 w2c
    (visergui.py:14-23)."""
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = quat_to_rotmat_np(wxyz)
    c2w[:3, 3] = position
    return np.linalg.inv(c2w)


@torch.no_grad()
def render_offscreen(splat, w2c: np.ndarray, width: int, height: int,
                     focal_x: float, focal_y: float,
                     near: float | None = None, far: float | None = None,
                     sh_order: int | None = None, fast: bool | None = None):
    """Render an arbitrary camera → (H, W, 3) numpy image.

    ``near`` culls by camera z and ``far`` by Euclidean depth ||p_cam||
    (gaussian.cu:1208, :1217); when ``near`` is given the projection's own
    near plane drops to 0.1 so the slider value is the binding cull, as in
    JAX.  ``sh_order`` (SH models) keeps the first ``sh_order``² of each
    channel's 9 coefficients.  ``fast`` (default ``cfg.fast_drawing``)
    renders an RGB model through the bf16 render preset; SH models keep the
    f32 route, as JAX's Fast Mode does (viewer.py:90-100).
    """
    cfg = splat.cfg
    if fast is None:
        fast = bool(cfg.fast_drawing)
    preset = fast and not cfg.use_sh_coeff
    if near is not None:
        cfg = dataclasses.replace(cfg, near=min(float(cfg.near), 0.1))
    grid = TileGrid(width=int(width), height=int(height),
                    focal_x=focal_x, focal_y=focal_y,
                    tile_h=cfg.tile_h, tile_w=cfg.tile_w)
    bspec, rspec = make_specs(grid, cfg)
    dev = splat.table.device
    rot = torch.as_tensor(np.asarray(w2c[:3, :3], np.float32), device=dev)
    tran = torch.as_tensor(np.asarray(w2c[:3, 3], np.float32), device=dev)
    params = splat.table.params()
    live = splat.table.live
    shv = None
    if cfg.use_sh_coeff:
        shv = torch.as_tensor(np.stack(list(ray_info(
            w2c[:3, :3], w2c[:3, 3], grid.padded_height, grid.padded_width,
            focal_x, focal_y).values())), dtype=torch.float32, device=dev)
        keep = _SH_COEFFS_PER_ORDER.get(int(sh_order), SH_DIM) \
            if sh_order is not None else SH_DIM
        if keep < SH_DIM:
            # zero the truncated bands per channel (27 = 3 channels x 9)
            mask = torch.zeros(3, SH_DIM, dtype=torch.float32, device=dev)
            mask[:, :keep] = 1.0
            params = dict(params, rgb=params["rgb"] * mask.reshape(-1))
    if near is not None or far is not None:
        p_c = world_to_camera(params["pos"], rot, tran)
        if near is not None:
            live = live & (p_c[:, 2] > near)
        if far is not None:
            live = live & (torch.sqrt((p_c * p_c).sum(dim=-1)) < far)
    img, _ = render_cropped(params, live, rot, tran, grid, cfg, bspec, rspec,
                            shv, preset)
    return img.permute(1, 2, 0).cpu().numpy()
