"""Build a synthetic COLMAP scene whose ground truth the port itself renders
(``scripts/make_synth_scene.py`` of the JAX package): GT gaussians →
rendered views → COLMAP files + a degraded point cloud as the training init.

    python -m gsplat_tpu_torch.scripts.make_synth_scene OUT \\
        --preset garden_hard [--seed 0] [--device cuda]

Presets (``PRESETS``):

- ``mid``: 50k GT gaussians, 640x416, 24 cameras;
- ``garden``: 400k GT gaussians, 1297x840, 56 cameras on an orbit;
- ``garden_hard``: 1.2M GT gaussians with degree-1/2 SH view dependence,
  1297x840, 56 orbit cameras and independent sensor noise (σ = 2 of 255)
  on every saved view.  The GT table holds ~2.4x the trainer's 524,288-slot
  ceiling and its view dependence is beyond an RGB model, so the final PSNR
  measures fitting power against an unreachable target; the oracle ceiling
  (the noiseless GT render against the saved noisy targets) goes to
  ``gt_ceiling.json``.

Every random draw comes from numpy in the JAX script's order (the table
from ``synthetic_table``'s own generator; the sensor noise, the init subset
and its jitter from one ``default_rng(seed)``), so the two generators write
the same COLMAP files byte for byte.  Each view is rendered once in f32
through ``render_cropped``, on the card unless ``device="cpu"``.  The JAX
script stops when a render overflows its TPU pair budgets; the port has
none and prints each view's pairs and clipped pairs instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from gsplat_tpu_torch.config import SplatConfig
from gsplat_tpu_torch.models.camera import TileGrid, ray_info
from gsplat_tpu_torch.models.splatter import make_specs, render_cropped
from gsplat_tpu_torch.ops.sh import C0
from gsplat_tpu_torch.synthetic import synthetic_table
from gsplat_tpu_torch.utils.colmap import write_cameras_binary, \
    write_images_binary, write_points3d_binary
from gsplat_tpu_torch.utils.image_io import write_png
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat_np
from gsplat_tpu_torch.viewer import _rotmat_to_quat

PRESETS = {
    "mid": dict(n_gt=50_000, n_points=15_000, n_cams=24, w=640, h=416,
                focal=500.0, capacity_round=4096, scale_px=3.0, opa=0.7),
    "garden": dict(n_gt=400_000, n_points=140_000, n_cams=56, w=1297, h=840,
                   focal=1000.0, capacity_round=65536, scale_px=2.5, opa=0.6,
                   orbit=True),
    "garden_hard": dict(n_gt=1_200_000, n_points=140_000, n_cams=56,
                        w=1297, h=840, focal=1000.0, capacity_round=65536,
                        scale_px=1.6, opa=0.6, orbit=True, use_sh=True,
                        sh_ampl=0.35, noise_std=2.0),
}


def _orbit_poses(n_cams, center, radius):
    """Cameras circling ``center`` and looking at it (COLMAP x right, y
    down, z forward), with the elevation and radius varying around the
    ring: multi-view geometry like a real capture's."""
    poses = []
    c = np.asarray(center, np.float64)
    for i in range(n_cams):
        az = 2 * np.pi * i / n_cams
        elev = 0.25 * np.sin(3 * az) + 0.1
        rad = radius * (1.0 + 0.08 * np.sin(5 * az))
        p = c + rad * np.array([np.sin(az) * np.cos(elev),
                                -np.sin(elev),
                                -np.cos(az) * np.cos(elev)])
        fwd = c - p
        fwd /= np.linalg.norm(fwd)
        up = np.array([0.0, -1.0, 0.0])       # COLMAP y is down
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        rot = np.stack([right, down, fwd])    # w2c rows
        poses.append((_rotmat_to_quat(rot), -rot @ p, f"img_{i:03d}.png"))
    return poses


def _ring_poses(n_cams):
    """Slightly rotated and shifted cameras near the origin looking +z."""
    poses = []
    for i in range(n_cams):
        ang = 0.12 * np.sin(2 * np.pi * i / n_cams)
        tilt = 0.06 * np.cos(2 * np.pi * i / n_cams)
        q = np.array([np.cos(ang / 2) * np.cos(tilt / 2),
                      np.sin(tilt / 2), np.sin(ang / 2), 0.0])
        q /= np.linalg.norm(q)
        t = np.array([0.15 * np.sin(2 * np.pi * i / n_cams),
                      0.08 * np.cos(2 * np.pi * i / n_cams), 0.0])
        poses.append((q, t, f"img_{i:03d}.png"))
    return poses


def view_inputs(q, t, grid, device):
    """A COLMAP pose (w2c quaternion, translation) → the render's (rotation,
    translation, SH view vectors) as f32 tensors on ``device``."""
    rot = quat_to_rotmat_np(q)
    shv = np.stack(list(ray_info(rot, t, grid.padded_height,
                                 grid.padded_width, grid.focal_x,
                                 grid.focal_y).values()))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device)
                 for a in (rot, t, shv))


def main(out_dir, n_gt, n_points, n_cams, w, h, focal, capacity_round,
         scale_px, opa, downsample=4, seed=0, orbit=False, use_sh=False,
         sh_ampl=0.0, noise_std=0.0, device="cuda", log=None):
    """Write the scene to ``out_dir`` → a dict of the oracle ceiling (dB),
    each view's ``n_pairs`` and ``n_clipped``, the seconds it took, and what
    rendered the views (the GT ``table``, its ``cfg``, the ``grid`` and the
    ``poses``); ``log`` (default: print) takes the progress lines."""
    log = log or (lambda msg: print(msg, flush=True))
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    if orbit:
        center, radius, ball_r = (0.0, 0.0, 0.0), 5.0, 2.2
        table = synthetic_table(
            n_gt, capacity_round=capacity_round, focal=focal,
            scale_px=scale_px, opa=opa, seed=seed, use_sh=use_sh,
            sh_ampl=sh_ampl, ball=center + (ball_r, radius), device=device)
        poses = _orbit_poses(n_cams, center, radius)
    else:
        table = synthetic_table(n_gt, capacity_round=capacity_round,
                                focal=focal, scale_px=scale_px, opa=opa,
                                seed=seed, frustum=(0.85, 0.55),
                                device=device)
        poses = _ring_poses(n_cams)
    cfg = SplatConfig(capacity_round=capacity_round, use_sh_coeff=use_sh)
    grid = TileGrid(width=w, height=h, focal_x=focal, focal_y=focal)
    bspec, rspec = make_specs(grid, cfg)

    sparse = os.path.join(out_dir, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    img_dir = os.path.join(out_dir, f"images_{downsample}")
    os.makedirs(img_dir, exist_ok=True)

    params, live = table.params(), table.live
    mse_sum, n_px, views = 0.0, 0, []
    for q, t, name in poses:
        rot, tran, shv = view_inputs(q, t, grid, table.device)
        with torch.no_grad():
            img, aux = render_cropped(params, live, rot, tran, grid, cfg,
                                      bspec, rspec, shv)
        clean = np.clip(img.permute(1, 2, 0).cpu().numpy(), 0, 1) * 255
        noisy = clean
        if noise_std:
            # independent sensor noise a view: not even the GT table
            # reproduces the target, and the ceiling below measures it
            noisy = clean + rng.normal(0.0, noise_std, clean.shape)
        img8 = np.clip(np.round(noisy), 0, 255).astype(np.uint8)
        err = (clean - img8.astype(np.float64)) / 255.0
        mse_sum += float((err ** 2).sum())
        n_px += img8.size
        write_png(os.path.join(img_dir, name), img8)
        views.append({"name": name, "n_pairs": int(aux["n_pairs"]),
                      "n_clipped": int(aux["n_clipped"])})
        log(f"rendered {name} pairs= {views[-1]['n_pairs']} clipped= "
            f"{views[-1]['n_clipped']}")
    ceiling = None
    if n_px:
        ceiling = float(10 * np.log10(1.0 / max(mse_sum / n_px, 1e-12)))
        with open(os.path.join(out_dir, "gt_ceiling.json"), "w") as f:
            json.dump({
                "oracle_ceiling_psnr": round(ceiling, 2),
                "what": "PSNR of the noiseless GT-table render vs the "
                        "saved (noisy, quantized) target images — the "
                        "best ANY model could score on this scene",
                "n_gt": n_gt, "use_sh": bool(use_sh),
                "sh_ampl": sh_ampl, "noise_std": noise_std,
            }, f, indent=1)
        log(f"oracle ceiling: {ceiling:.2f} dB -> gt_ceiling.json")

    # the degraded init point cloud: a subset of the GT centres, jittered
    sel = rng.choice(table.n_live, size=n_points, replace=False)
    pos = table.pos.cpu().numpy()[sel] + rng.normal(0, 0.01, (n_points, 3))
    rgb_all = table.rgb.cpu().numpy()
    if use_sh:
        # the DC terms back to color logits (initialize_sh divides by C0;
        # the 27 coefficients are (3, 9) channel-major)
        rgb_logit = rgb_all[sel][:, [0, 9, 18]] * C0
    else:
        rgb_logit = rgb_all[sel]
    rgb = (1 / (1 + np.exp(-rgb_logit)) * 255).astype(np.uint8)
    write_cameras_binary(os.path.join(sparse, "cameras.bin"), 1,
                         w * downsample, h * downsample,
                         focal * downsample, focal * downsample)
    write_images_binary(os.path.join(sparse, "images.bin"), poses, 1)
    write_points3d_binary(os.path.join(sparse, "points3D.bin"), pos, rgb)
    log(f"scene written to {out_dir}")
    return {"oracle_ceiling_psnr": ceiling, "views": views,
            "seconds": time.perf_counter() - t0, "table": table, "cfg": cfg,
            "grid": grid, "poses": poses}


def build_argparser():
    ap = argparse.ArgumentParser(
        description="a synthetic COLMAP scene rendered by the port")
    ap.add_argument("out_dir")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="mid")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the GT render (cuda, cuda:N, or cpu)")
    return ap


if __name__ == "__main__":
    args = build_argparser().parse_args()
    main(args.out_dir, seed=args.seed, device=args.device,
         **PRESETS[args.preset])
