"""Band-parallel rendering of one camera (spatial parallelism).

The port of ``gsplat_tpu/parallel/tile_parallel.py``: the pixel plane is
split into horizontal bands of tile rows, one band per rank.  Projection is
recomputed per band on the replicated table; binning and compositing run on
the band only.

JAX's translation trick keeps every band's shapes the same: the image plane
is translated per band instead of parameterising the tile grid.
Compositing reads only pixel-gaussian coordinate differences, so shifting
``mean2d.y`` by the band's centre offset and using a band-local grid is
exact (``:53-65``); the SH ``lefttop`` vector moves by the band's first row
times ``dy`` (``:79``).
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.models.camera import TileGrid
from gsplat_tpu_torch.models.splatter import make_specs
from gsplat_tpu_torch.ops.binning import pack_sorted
from gsplat_tpu_torch.ops.projection import project_gaussians
from gsplat_tpu_torch.ops.rasterize import rasterize


def band_heights(grid: TileGrid, n_bands: int) -> tuple[int, int]:
    """The nearest image heights at or below and above ``grid.height``
    whose tile rows ``n_bands`` divide (0 when none is below)."""
    step = n_bands * grid.tile_h
    rows = grid.n_tile_y // n_bands * n_bands
    return rows * grid.tile_h, -(-grid.n_tile_y // n_bands) * step


def make_tile_sharded_render(grid: TileGrid, cfg, n_bands: int,
                             process_group=None):
    """→ ``render(params, live, rot, tran, shv=None)``, the padded
    (3, padded_h, padded_w) channel-major image of ``grid`` rendered in
    ``n_bands`` bands of tile rows.

    With ``process_group`` (of ``n_bands`` ranks), rank r renders band r
    and the bands are ``all_gather``-ed on every rank; without one, the
    bands render one after another on the caller's device.  ``shv`` (the
    camera's ``sh_vecs``) is needed with SH color.  Raises ``ValueError``
    when ``n_bands`` does not divide the grid's tile rows, naming the
    nearest image heights that it divides.
    """
    if grid.n_tile_y % n_bands:
        lo, hi = band_heights(grid, n_bands)
        raise ValueError(
            f"{n_bands} bands need a tile-row count that {n_bands} divides; "
            f"height {grid.height} gives {grid.n_tile_y} rows of "
            f"{grid.tile_h} px: use height {lo} or {hi}"
            if lo else
            f"{n_bands} bands need at least {n_bands} tile rows; height "
            f"{grid.height} gives {grid.n_tile_y}: use height {hi}")
    rows_per = grid.n_tile_y // n_bands
    band = TileGrid(width=grid.padded_width, height=rows_per * grid.tile_h,
                    focal_x=grid.focal_x, focal_y=grid.focal_y,
                    tile_h=grid.tile_h, tile_w=grid.tile_w)
    bspec, rspec = make_specs(band, cfg)

    def render_band(params, live, rot, tran, shv, b):
        row0 = b * rows_per * grid.tile_h             # first pixel row
        # full-image pixel row p sits at (p + .5 - H/2)/fy; band-local row
        # p - row0 at (p - row0 + .5 - Hb/2)/fy: shift by the difference
        shift_y = (row0 + band.padded_height / 2
                   - grid.padded_height / 2) / grid.focal_y
        proj = project_gaussians(
            params["pos"], params["quat"], params["scale"], rot, tran,
            near=cfg.near,
            half_width=grid.width * 1.2 / 2 / grid.focal_x,
            half_height=grid.height * 1.2 / 2 / grid.focal_y,
            scale_activation=cfg.scale_activation)
        mean2d = proj.mean2d - torch.tensor(
            [0.0, shift_y], dtype=proj.mean2d.dtype,
            device=proj.mean2d.device)
        opa = torch.sigmoid(params["opa"])
        color = params["rgb"] if cfg.use_sh_coeff \
            else torch.sigmoid(params["rgb"])
        geom_n = torch.cat([mean2d, proj.cov2d, opa[:, None],
                            torch.zeros_like(opa)[:, None]], dim=1)
        packed = pack_sorted(bspec, geom_n, color, proj.depth,
                             proj.visible & live)
        shv_band = None
        if cfg.use_sh_coeff:
            shv_band = shv.clone()
            shv_band[1] += float(row0) * shv[3]
        return rasterize(packed, rspec, shv_band)     # (3, band_h, Wp)

    def render(params, live, rot, tran, shv=None):
        if process_group is None:
            return torch.cat([render_band(params, live, rot, tran, shv, b)
                              for b in range(n_bands)], dim=1)
        import torch.distributed as dist

        img = render_band(params, live, rot, tran, shv,
                          dist.get_rank(process_group)).contiguous()
        bands = [torch.empty_like(img) for _ in range(n_bands)]
        dist.all_gather(bands, img, group=process_group)
        return torch.cat(bands, dim=1)

    return render
