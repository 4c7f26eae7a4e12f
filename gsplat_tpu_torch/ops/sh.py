"""Real spherical-harmonics basis, degree 2 (9 coefficients).

The port of ``gsplat_tpu/ops/sh.py:14-46``: the svox2 constants and layout
of the reference's ``calc_sh`` (``src/gaussian.cu:385-426``), coefficient
order [l0, l1(-y, z, -x), l2(xy, yz, 2z²-x²-y², xz, x²-y²)], and per-gaussian
color coefficients stored channel-major as (3, 9) → 27.  The compositors
evaluate the basis per pixel (``ops/rasterize._sh_pixel_basis`` and
``csrc/sh_color.cuh``) with these constants.
"""

from __future__ import annotations

import torch

SH_DIM = 9
C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)


def sh_basis(dirs: torch.Tensor) -> torch.Tensor:
    """Unit directions (..., 3) → SH basis values (..., 9)."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack(
        [
            torch.full_like(x, C0),
            -C1 * y,
            C1 * z,
            -C1 * x,
            C2[0] * x * y,
            C2[1] * y * z,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * x * z,
            C2[4] * (xx - yy),
        ],
        dim=-1,
    )


def initialize_sh(rgb_logits: torch.Tensor) -> torch.Tensor:
    """DC-only SH init from per-point rgb logits (N, 3) → (N, 27)
    (reference utils.py:345-348)."""
    n = rgb_logits.shape[0]
    coeff = torch.zeros((n, 3, SH_DIM), dtype=rgb_logits.dtype,
                        device=rgb_logits.device)
    coeff[:, :, 0] = rgb_logits / C0
    return coeff.reshape(n, 3 * SH_DIM)
