"""Scene container + render pipeline (PyTorch port of ``Splatter``).

The render of ``gsplat_tpu/models/splatter.py``: project → cull → bin →
depth-sort → composite → assemble, then clip and centre-crop.  Cameras of
one intrinsics group are stacked into tensors once; a render selects one by
index.  The compositor follows the tensors' device: the CUDA kernels for
CUDA tensors, their plain PyTorch versions for CPU tensors
(``ops/rasterize.composite_tiles``).  ``render_padded`` and
``render_cropped`` are differentiable in the table's parameters (the train
step's forward), except through the render-only bf16 preset (``preset``);
``Splatter.render`` runs without gradients.  With ``cfg.use_sh_coeff`` the
table's ``rgb`` holds 27 SH coefficients, evaluated per pixel from the
camera's ``sh_vecs``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from gsplat_tpu_torch.config import SplatConfig
from gsplat_tpu_torch.models.camera import TileGrid, ray_info
from gsplat_tpu_torch.models.gaussians import GaussianTable, init_from_points
from gsplat_tpu_torch.ops.binning import BinningSpec, pack_preset, pack_sorted
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import RasterSpec, rasterize, \
    rasterize_preset
from gsplat_tpu_torch.ops.sh import SH_DIM
from gsplat_tpu_torch.utils.colmap import camera_focals, read_cameras_binary, \
    read_images_binary, read_points3d_arrays
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat_np


@dataclass
class SceneCameras:
    """Stacked per-camera tensors (single shared intrinsics)."""

    w2c_rot: torch.Tensor     # (M, 3, 3)
    w2c_tran: torch.Tensor    # (M, 3)
    sh_vecs: torch.Tensor     # (M, 4, 3) [rays_o, lefttop, dx, dy]
    images: Optional[torch.Tensor]  # (M, 3, H, W) uint8 GT, channel-major
    grid: TileGrid
    names: list

    @property
    def n_cameras(self) -> int:
        return self.w2c_rot.shape[0]


def load_scene_camera_groups(colmap_path, image_path, render_downsample,
                             tile_h=16, tile_w=16, load_images=True,
                             device="cpu"):
    """COLMAP sparse dir + image dir → list of SceneCameras groups.

    Images sorted by COLMAP image id, skipped when the file is missing;
    cameras grouped by their (resolution, focal) signature, largest group
    first (``gsplat_tpu/models/splatter.py:61-127``).
    """
    import cv2

    cameras = read_cameras_binary(os.path.join(colmap_path, "cameras.bin"))
    images_info = read_images_binary(os.path.join(colmap_path, "images.bin"))

    buckets = {}   # grid signature → dict of per-camera lists
    for img_id in sorted(images_info.keys()):
        info = images_info[img_id]
        fn = os.path.join(image_path, info.name)
        if load_images and not os.path.exists(fn):
            continue
        cam = cameras[info.camera_id]
        w = int(cam.width / render_downsample)
        h = int(cam.height / render_downsample)
        fx, fy = camera_focals(cam)
        fx /= render_downsample
        fy /= render_downsample
        im = None
        if load_images:
            im = cv2.cvtColor(cv2.imread(fn), cv2.COLOR_BGR2RGB)
            h, w = im.shape[:2]
        key = (w, h, round(fx, 6), round(fy, 6))
        b = buckets.setdefault(key, {"rots": [], "trans": [], "imgs": [],
                                     "names": [], "fx": fx, "fy": fy})
        if im is not None:
            b["imgs"].append(im)
        b["rots"].append(quat_to_rotmat_np(info.qvec))
        b["trans"].append(info.tvec)
        b["names"].append(info.name)

    def f32(a):
        return torch.from_numpy(np.stack(a).astype(np.float32)).to(device)

    groups = []
    for (w, h, _, _), b in buckets.items():
        grid = TileGrid(width=w, height=h, focal_x=b["fx"], focal_y=b["fy"],
                        tile_h=tile_h, tile_w=tile_w)
        shv = [np.stack(list(ray_info(
            r, t, grid.padded_height, grid.padded_width,
            grid.focal_x, grid.focal_y).values()))
            for r, t in zip(b["rots"], b["trans"])]
        groups.append(SceneCameras(
            w2c_rot=f32(b["rots"]),
            w2c_tran=f32(b["trans"]),
            sh_vecs=f32(shv),
            images=torch.from_numpy(
                np.ascontiguousarray(np.stack(b["imgs"]).transpose(0, 3, 1, 2))
            ).to(device) if b["imgs"] else None,
            grid=grid,
            names=b["names"],
        ))
    groups.sort(key=lambda g: -g.n_cameras)
    return groups


def make_specs(grid: TileGrid, cfg: SplatConfig):
    """Binning + raster specs of one camera grid; the raster spec's
    ``color_dim`` is 27 with ``cfg.use_sh_coeff``, else 3."""
    method = cfg.tile_culling_method
    if method == "dist":
        thresh = (grid.tile_geo_length_x / cfg.tile_culling_dist_thresh) ** 2
    else:
        thresh = cfg.tile_culling_prob_thresh
    bspec = BinningSpec(
        n_tile_x=grid.n_tile_x, n_tile_y=grid.n_tile_y,
        tile_len_x=grid.tile_geo_length_x, tile_len_y=grid.tile_geo_length_y,
        leftmost=grid.leftmost, topmost=grid.topmost,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        method=method, thresh=thresh)
    rspec = RasterSpec(
        n_tile_x=grid.n_tile_x, n_tile_y=grid.n_tile_y,
        tile_h=grid.tile_h, tile_w=grid.tile_w,
        focal_x=grid.focal_x, focal_y=grid.focal_y,
        chunk_size=cfg.chunk_size,
        weight_normalize=cfg.render_weight_normalize,
        color_dim=3 * SH_DIM if cfg.use_sh_coeff else 3)
    return bspec, rspec


def render_padded(params: dict, live, w2c_rot, w2c_tran, grid: TileGrid,
                  cfg: SplatConfig, bspec: BinningSpec, rspec: RasterSpec,
                  sh_vecs=None, preset: bool = False):
    """Table params → padded (3, Hp, Wp) image and diagnostics.

    ``sh_vecs`` (4, 3) is the camera's RayInfo, needed with SH color.
    ``preset`` renders through the bf16 render preset (RGB, render-only).
    ``aux`` carries the visibility mask and the binning counters.
    """
    proj = project_gaussians(
        params["pos"], params["quat"], params["scale"],
        w2c_rot, w2c_tran,
        near=cfg.near,
        half_width=grid.width * 1.2 / 2 / grid.focal_x,
        half_height=grid.height * 1.2 / 2 / grid.focal_y,
        scale_activation=cfg.scale_activation,
    )
    visible = proj.visible & live
    opa = torch.sigmoid(params["opa"])
    color = params["rgb"] if cfg.use_sh_coeff \
        else torch.sigmoid(params["rgb"])
    geom_n = torch.cat([proj.mean2d, proj.cov2d, opa[:, None],
                        torch.zeros_like(opa)[:, None]], dim=1)
    packed = pack_sorted(bspec, geom_n, color, proj.depth, visible)
    if preset:
        img = rasterize_preset(pack_preset(bspec, packed), rspec)
    else:
        img = rasterize(packed, rspec, sh_vecs)
    aux = {
        "visible": visible,
        "n_pairs": packed.n_pairs,
        "n_clipped": packed.n_clipped,
        "n_visible": packed.n_visible,
        "n_max_tiles": packed.n_max_tiles,
    }
    return img, aux


def render_cropped(params, live, w2c_rot, w2c_tran, grid, cfg, bspec, rspec,
                   sh_vecs=None, preset: bool = False):
    """Padded render, clamped to [0, 1] and centre-cropped → (3, H, W)."""
    img, aux = render_padded(params, live, w2c_rot, w2c_tran, grid, cfg,
                             bspec, rspec, sh_vecs, preset)
    img = torch.clamp(img, 0.0, 1.0)
    t, l = grid.crop_top, grid.crop_left
    return img[:, t:t + grid.height, l:l + grid.width], aux


class Splatter:
    """Scene + model container: a gaussian table and its cameras."""

    def __init__(self, colmap_path, image_path, cfg: SplatConfig,
                 load_ckpt=None, test=False, device="cpu"):
        if load_ckpt is not None:
            from gsplat_tpu_torch.utils.checkpoint import load_checkpoint
            table = load_checkpoint(load_ckpt,
                                    capacity_round=cfg.capacity_round,
                                    device=device)
        else:
            points, rgbs = read_points3d_arrays(
                os.path.join(colmap_path, "points3D.bin"))
            table = init_from_points(
                points, rgbs,
                use_sh_coeff=cfg.use_sh_coeff,
                opa_init_value=cfg.opa_init_value,
                scale_init_value=cfg.scale_init_value,
                scale_activation=cfg.scale_activation,
                capacity_round=cfg.capacity_round,
                device=device,
            )
        groups = load_scene_camera_groups(
            colmap_path, image_path, cfg.render_downsample,
            tile_h=cfg.tile_h, tile_w=cfg.tile_w, load_images=not test,
            device=device)
        self._setup(cfg, table, groups)

    @classmethod
    def from_scene(cls, cfg: SplatConfig, table: GaussianTable,
                   camera_groups: list) -> "Splatter":
        """A Splatter over an in-memory table and cameras (synthetic
        scenes)."""
        self = cls.__new__(cls)
        self._setup(cfg, table, camera_groups)
        return self

    def _setup(self, cfg, table, camera_groups):
        self.cfg = cfg
        self.table = table
        self.camera_groups = camera_groups
        self.cameras = camera_groups[0]   # primary (largest) group
        self._specs_cache = {}

    def specs(self, grid: TileGrid | None = None):
        grid = grid or self.cameras.grid
        if grid not in self._specs_cache:
            self._specs_cache[grid] = make_specs(grid, self.cfg)
        return self._specs_cache[grid]

    @torch.no_grad()
    def render(self, camera_id: int) -> torch.Tensor:
        """Single-camera render → (3, H, W) channel-major."""
        grid = self.cameras.grid
        bspec, rspec = self.specs(grid)
        img, _ = render_cropped(
            self.table.params(), self.table.live,
            self.cameras.w2c_rot[camera_id], self.cameras.w2c_tran[camera_id],
            grid, self.cfg, bspec, rspec, self.cameras.sh_vecs[camera_id])
        return img

    def ground_truth(self, camera_id: int) -> torch.Tensor:
        """GT image as stored: channel-major (3, H, W) float in [0, 1]."""
        return self.cameras.images[camera_id].to(torch.float32) / 255.0
