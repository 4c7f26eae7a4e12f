"""Naive reference rasterizer (the test oracle): every gaussian against every
pixel, in depth order, with no tiles and no caps.

A port of ``gsplat_tpu/ops/rasterize_ref.py::rasterize_oracle``.  Like the
original it has no 0.9999 alpha clamp:

- pixel centre (id + 0.5 - size/2) / focal                    (:839-840)
- prob = exp(-(d x² - (b+c) x y + a y²) / (2 det + 1e-14))     (:920-923)
- alpha = prob · opa; weight = alpha · T;  T *= (1 - alpha)    (:926-960)
- a pixel stops accepting gaussians once T < 1e-4              (:906)
- optional weight normalization (skipped when Σw < 0.01)       (:964-966)
- SH mode: per-pixel view directions from the RayInfo vectors, sigmoid of
  the SH dot product                                     (:845-861, 936-948)
"""

from __future__ import annotations

import torch

from gsplat_tpu_torch.ops.binning import sqrt_rn
from gsplat_tpu_torch.ops.sh import sh_basis

STOP_THRESH = 1e-4  # gaussian.cu:906


def pixel_grid(h: int, w: int, focal_x: float, focal_y: float, device=None):
    """Focal-normalized pixel-centre coordinates for a padded h x w image."""
    ix = torch.arange(w, dtype=torch.float32, device=device)
    iy = torch.arange(h, dtype=torch.float32, device=device)
    px = (ix + 0.5 - w / 2) / focal_x
    py = (iy + 0.5 - h / 2) / focal_y
    gy, gx = torch.meshgrid(py, px, indexing="ij")
    return gx, gy  # each (h, w)


def rasterize_oracle(mean2d, cov2d, opa, color, h: int, w: int,
                     focal_x: float, focal_y: float,
                     sh_vecs: dict | None = None,
                     weight_normalize: bool = False) -> torch.Tensor:
    """Depth-sorted, culled (M, ...) gaussians → (3, h, w) image.

    ``color`` is (M, 3) post-sigmoid RGB or (M, 27) SH coefficients; for SH,
    ``sh_vecs`` holds the camera's ``rays_o``, ``lefttop``, ``dx`` and ``dy``
    (3,) each.
    """
    px, py = pixel_grid(h, w, focal_x, focal_y, mean2d.device)
    shb = None
    if color.shape[-1] != 3:
        ix = torch.arange(w, dtype=torch.float32,
                          device=mean2d.device)[None, :, None]
        iy = torch.arange(h, dtype=torch.float32,
                          device=mean2d.device)[:, None, None]
        d = (sh_vecs["lefttop"] + ix * sh_vecs["dx"] + iy * sh_vecs["dy"]
             - sh_vecs["rays_o"])
        d = d / (sqrt_rn((d * d).sum(dim=-1, keepdim=True)) + 1e-7)
        shb = sh_basis(d)                                    # (h, w, 9)
    accum = torch.ones((h, w), dtype=torch.float32, device=mean2d.device)
    col = torch.zeros((3, h, w), dtype=torch.float32, device=mean2d.device)
    accw = torch.zeros((h, w), dtype=torch.float32, device=mean2d.device)
    for i in range(mean2d.shape[0]):
        a, b, c, d = cov2d[i, 0], cov2d[i, 1], cov2d[i, 2], cov2d[i, 3]
        dx = px - mean2d[i, 0]
        dy = py - mean2d[i, 1]
        det = a * d - b * c
        prob = torch.exp(-(d * dx * dx - (b + c) * dx * dy + a * dy * dy)
                         / (2 * det + 1e-14))
        alpha = prob * opa[i]
        live = accum >= STOP_THRESH
        wgt = torch.where(live, alpha * accum, torch.zeros_like(alpha))
        if shb is None:
            col = col + wgt[None] * color[i][:, None, None]
        else:
            logits = torch.einsum("hwk,ck->chw", shb, color[i].reshape(3, 9))
            col = col + wgt[None] * torch.sigmoid(logits)
        accw = accw + wgt
        accum = torch.where(live, accum * (1 - alpha), accum)
    if weight_normalize:
        denom = torch.where(accw < 0.01, torch.ones_like(accw), accw)
        col = col / denom[None]
    return col
