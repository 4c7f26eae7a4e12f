"""Tile binning: depth order, per-gaussian tile lists, one sort by tile.

The semantics are those of the exact dense route of the JAX package,
``_pack_sorted_impl`` (``gsplat_tpu/ops/binning.py:483-616``):

1. a stable argsort of ``where(visible, depth, inf)`` gives the
   front-to-back order;
2. each gaussian covers the tile rectangle of its iso-probability ellipse
   bbox (``_tile_bbox_rows``, ``:235-262``; same floor/clip truncation);
3. it emits its first ``count = min(rw*rh, K)`` tiles, enumerated
   row-major in the bbox; the tiles past K are counted in ``n_clipped``;
4. one stable sort by tile keeps depth order within each tile.

The output is the GPU layout, not the TPU one: per-pair rows
``geom (P, 8)`` = [x, y, a, b, c, d, opa, 0] and ``color (P, C)`` in
tile-then-depth order, plus ``tile_start (T+1,)`` offsets.  There is no
chunk alignment, no pad row and no slot budget: every tile is composited
whole, so nothing is truncated.

Shapes are dynamic: the pair count is read back once per call (the
``repeat_interleave`` output size), the one host sync of the pack.  Every
index is int64; ``tile_start`` is handed to the kernel as int32, which
holds any pair count that fits in device memory at 44 bytes a pair.

Backward: the port's form of ``_pack_sorted_bwd`` (``gsplat_tpu/ops/
binning.py:1363-1535``) is autograd through the two row gathers
``geom_n[src]`` and ``color_n[src]``: each per-pair cotangent row is summed
into its gaussian's row (an ``index_put_`` with ``accumulate=True``, the
TPU's avoided scatter).  On CUDA PyTorch computes it by sorting the indices,
which is deterministic (it is not on PyTorch's list of nondeterministic
operations).  The ordering and the tile rectangles read detached copies,
so depth gets no gradient (``:1340-1342``, ``:1534``); column 7 gets zero
because the compositor never reads it.

The render preset (JAX's ``packed_bf16``, the viewer's Fast Mode) takes the
same pairs in the same order and rounds each pair's values to bf16, with
the position made relative to its tile's centre (:func:`pack_preset`).  The
TPU's i32 pairing of two bf16 values, its pad-free ``post_align`` sort and
the in-kernel realign are sort-cost mechanics the port leaves out.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class BinningSpec(NamedTuple):
    """Grid geometry and tile-culling rule of one camera."""

    n_tile_x: int
    n_tile_y: int
    tile_len_x: float     # focal-normalized tile width
    tile_len_y: float
    leftmost: float
    topmost: float
    max_tiles_per_gaussian: int   # K
    method: str = "prob2"         # prob2 | prob | dist
    thresh: float = 0.05

    @property
    def n_tiles(self) -> int:
        return self.n_tile_x * self.n_tile_y


class PackedPairs(NamedTuple):
    """Depth-ordered (gaussian, tile) pairs, grouped by tile."""

    geom: torch.Tensor        # (P, 8) f32 [x, y, a, b, c, d, opa, 0]
    color: torch.Tensor       # (P, C) f32
    tile_start: torch.Tensor  # (T+1,) int32: tile t owns pairs
                              # [tile_start[t], tile_start[t+1])
    n_pairs: torch.Tensor     # ()  pairs emitted
    n_clipped: torch.Tensor   # ()  pairs dropped by the per-gaussian K cap
    n_visible: torch.Tensor   # ()  frustum-visible gaussians
    n_max_tiles: torch.Tensor  # () max tiles covered by any gaussian


class PresetPairs(NamedTuple):
    """The render preset's pairs: :class:`PackedPairs` rows in bf16."""

    geom: torch.Tensor        # (P, 8) bf16 [x - tcx, y - tcy, a, b, c, d,
                              #              opa, 0]; one 16-byte row
    color: torch.Tensor       # (P, 4) bf16 [r, g, b, 0]; one 8-byte row
    tile_start: torch.Tensor  # (T+1,) int32, as in PackedPairs


def _tile_bbox_rows(spec: BinningSpec, cx, cy, a, b, c, d, visible):
    """Per-gaussian covered tile rectangle [x0, x0+rw) x [y0, y0+rh).

    The arithmetic of ``gsplat_tpu/ops/binning.py::_tile_bbox_rows`` step
    for step (the floor/clip truncation decides which tiles a gaussian
    reaches, so the two must agree bit for bit); "dist" uses a fixed
    radius around the center.
    """
    det = a * d - b * c
    det_ok = det > 0
    if spec.method in ("prob2", "prob"):
        log_t = -2.0 * math.log(spec.thresh)
        shift_x = torch.sqrt(torch.clamp_min(a * log_t, 0.0))
        shift_y = torch.sqrt(torch.clamp_min(d * log_t, 0.0))
    else:  # "dist"
        r = math.sqrt(spec.thresh)
        shift_x = torch.full_like(a, r)
        shift_y = torch.full_like(a, r)
        det_ok = torch.ones_like(det_ok)
    x0 = torch.floor((cx - shift_x - spec.leftmost) / spec.tile_len_x)
    x1 = torch.floor((cx + shift_x - spec.leftmost) / spec.tile_len_x) + 1.0
    y0 = torch.floor((cy - shift_y - spec.topmost) / spec.tile_len_y)
    y1 = torch.floor((cy + shift_y - spec.topmost) / spec.tile_len_y) + 1.0
    x0 = torch.clamp(x0, 0, spec.n_tile_x).to(torch.int64)
    x1 = torch.clamp(x1, 0, spec.n_tile_x).to(torch.int64)
    y0 = torch.clamp(y0, 0, spec.n_tile_y).to(torch.int64)
    y1 = torch.clamp(y1, 0, spec.n_tile_y).to(torch.int64)
    valid = visible & det_ok
    zero = torch.zeros_like(x0)
    rw = torch.where(valid, torch.clamp_min(x1 - x0, 0), zero)
    rh = torch.where(valid, torch.clamp_min(y1 - y0, 0), zero)
    return x0, y0, rw, rh


def pack_sorted(spec: BinningSpec, geom_n: torch.Tensor,
                color_n: torch.Tensor, depth: torch.Tensor,
                visible: torch.Tensor) -> PackedPairs:
    """Depth-order, bin and pack the pairs of one view.

    Args:
      spec: grid geometry and culling rule.
      geom_n: (N, 8) [x, y, cov_a, cov_b, cov_c, cov_d, opa, 0], table order.
      color_n: (N, C) colors.
      depth: (N,) camera depth (ordering only).
      visible: (N,) bool frustum mask.
    """
    dev = geom_n.device
    n = depth.shape[0]
    K, T = spec.max_tiles_per_gaussian, spec.n_tiles

    # ---- depth order -----------------------------------------------------
    depth = depth.detach()
    depth_key = torch.where(visible, depth,
                            torch.full_like(depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices          # (N,)
    geom_o = geom_n.detach()[order]     # ordering and bboxes: no gradient
    vis_o = visible[order]

    # ---- per-gaussian tile rectangles, K cap -----------------------------
    x0, y0, rw, rh = _tile_bbox_rows(
        spec, geom_o[:, 0], geom_o[:, 1], geom_o[:, 2], geom_o[:, 3],
        geom_o[:, 4], geom_o[:, 5], vis_o)
    cover = rw * rh
    count = torch.clamp_max(cover, K)
    n_clipped = torch.clamp_min(cover - K, 0).sum()
    n_max_tiles = cover.max() if n else torch.zeros((), dtype=torch.int64,
                                                   device=dev)

    # ---- expand to pairs: gaussian g emits its bbox tiles k < count[g],
    # row-major, in depth order (rank g ascending) ------------------------
    total = int(count.sum())
    rank = torch.repeat_interleave(torch.arange(n, device=dev), count,
                                   output_size=total)           # (P,)
    first = torch.cumsum(count, 0) - count
    k = torch.arange(total, device=dev) - first[rank]
    rw_g = torch.clamp_min(rw, 1)[rank]
    ky = torch.div(k, rw_g, rounding_mode="floor")
    kx = k - ky * rw_g
    tile = (x0[rank] + kx) + (y0[rank] + ky) * spec.n_tile_x
    if spec.method == "dist":
        # refine: tile-centre distance test (gaussian.cu:124-128)
        tcx = spec.leftmost + (x0[rank] + kx + 0.5) * spec.tile_len_x
        tcy = spec.topmost + (y0[rank] + ky + 0.5) * spec.tile_len_y
        d2 = (geom_o[rank, 0] - tcx) ** 2 + (geom_o[rank, 1] - tcy) ** 2
        keep = d2 < spec.thresh
        rank, tile = rank[keep], tile[keep]

    # ---- one stable sort by tile keeps depth order within each tile ------
    tile_sorted, perm = torch.sort(tile, stable=True)
    src = order[rank[perm]]                                      # table rows
    tile_start = torch.searchsorted(
        tile_sorted, torch.arange(T + 1, device=dev, dtype=tile.dtype))

    return PackedPairs(
        geom=geom_n[src],           # the differentiable gathers
        color=color_n[src],
        tile_start=tile_start.to(torch.int32),
        n_pairs=torch.tensor(tile.shape[0], device=dev),
        n_clipped=n_clipped,
        n_visible=visible.sum(),
        n_max_tiles=n_max_tiles,
    )


def pack_preset(spec: BinningSpec, packed: PackedPairs) -> PresetPairs:
    """The render preset's pairs, from :func:`pack_sorted`'s (same pairs,
    same order): x and y minus the centre of the pair's tile, then a, b, c,
    d, opa and r, g, b, rounded to bf16 (round to nearest even, as
    ``_pack2_bf16``, ``gsplat_tpu/ops/binning.py:678-689``).

    The tile centre is the packer's (``:1011-1014``): ``leftmost +
    (tile_x + 0.5)·tile_len_x`` in f32, before the rounding.  RGB only.
    """
    g = packed.geom
    p, dev = g.shape[0], g.device
    if packed.color.shape[1] != 3:
        raise ValueError("the render preset is RGB only (JAX's Fast Mode "
                         "keeps SH on the f32 route)")
    counts = (packed.tile_start[1:] - packed.tile_start[:-1]).to(torch.int64)
    tile = torch.repeat_interleave(torch.arange(spec.n_tiles, device=dev),
                                   counts, output_size=p)
    tx = (tile % spec.n_tile_x).to(torch.float32)
    ty = torch.div(tile, spec.n_tile_x, rounding_mode="floor").to(
        torch.float32)
    tcx = spec.leftmost + (tx + 0.5) * spec.tile_len_x
    tcy = spec.topmost + (ty + 0.5) * spec.tile_len_y
    zero = torch.zeros_like(g[:, :1])
    geom = torch.cat([(g[:, 0] - tcx)[:, None], (g[:, 1] - tcy)[:, None],
                      g[:, 2:7], zero], dim=1)
    color = torch.cat([packed.color, zero], dim=1)
    return PresetPairs(geom=geom.to(torch.bfloat16),
                       color=color.to(torch.bfloat16),
                       tile_start=packed.tile_start)
