"""EWA projection + frustum culling (forward), plain PyTorch.

The math is that of ``gsplat_tpu/ops/projection.py:91-160``, written in the
same order so the two agree to float32 rounding:

- camera space: p_c = R p_w + t
- image space: (x/z, y/z) and depth = ||p_c|| (the Euclidean norm, not z)
- visible: z > near and |x/z| < half_width and |y/z| < half_height, where
  the caller passes half extents that carry the 1.2x frustum margin
- z is replaced by 1 at or behind the near plane, so 1/z stays finite for
  culled points
- the 2x2 EWA covariance in closed form, flattened as (a, b, b, d)

Everything stays at table size with a ``visible`` mask; binning compacts.
Elementwise throughout, so a float32 matmul mode (TF32) can never touch it.
Gradients come from autograd, as JAX's come from autodiff: the (a, b, b, d)
stack sums the b and c cotangents, and ``trunc_exp`` carries the clamped
gradient of the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.ops.binning import sqrt_rn

EPS = 1e-4  # reference splatter.py:19


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.exp(torch.clamp(x, -1.0, 1.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """exp with gradient exp(clamp(x, -1, 1)) (reference renderer.py:91-102;
    the JAX custom JVP of ``gsplat_tpu/ops/projection.py:34-43``)."""
    return _TruncExp.apply(x)


def activate_scale(scale: torch.Tensor, scale_activation: str) -> torch.Tensor:
    """abs+eps or truncated exp (reference splatter.py:520-524)."""
    if scale_activation == "abs":
        return torch.abs(scale) + EPS
    if scale_activation == "exp":
        return trunc_exp(scale)
    raise ValueError(f"unknown scale activation {scale_activation!r}")


def world_to_camera(pos: torch.Tensor, rot: torch.Tensor,
                    tran: torch.Tensor) -> torch.Tensor:
    """p_c = R p_w + t for a batch of points, as three elementwise rows."""
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    return torch.stack(
        [x * rot[k, 0] + y * rot[k, 1] + z * rot[k, 2] + tran[k]
         for k in range(3)], dim=-1)


class ProjectedGaussians(NamedTuple):
    """Image-space gaussians, padded to table capacity."""

    mean2d: torch.Tensor   # (N, 2) image-plane position (x/z, y/z)
    depth: torch.Tensor    # (N,)   Euclidean camera-space distance ||p_c||
    cov2d: torch.Tensor    # (N, 4) flattened 2x2 EWA covariance (a, b, c, d)
    visible: torch.Tensor  # (N,)   bool frustum/near mask


def normalize_quat(quat: torch.Tensor) -> torch.Tensor:
    """``quat / ‖quat‖`` with the correctly rounded f32 norm and JAX's
    gradient through it (``gsplat_tpu/ops/projection.py:113``)."""
    return quat / sqrt_rn((quat * quat).sum(dim=-1, keepdim=True))


def project_gaussians(
    pos: torch.Tensor,
    quat: torch.Tensor,
    scale: torch.Tensor,
    w2c_rot: torch.Tensor,
    w2c_tran: torch.Tensor,
    near: float,
    half_width: float,
    half_height: float,
    scale_activation: str = "abs",
) -> ProjectedGaussians:
    """Project world-space gaussians into the image plane (EWA splatting).

    Callers pass raw parameters: quaternion normalization and the scale
    activation happen here (reference splatter.py:519-524).
    """
    quat = normalize_quat(quat)
    s = activate_scale(scale, scale_activation)

    p_c = world_to_camera(pos, w2c_rot, w2c_tran)
    x, y, z = p_c[:, 0], p_c[:, 1], p_c[:, 2]
    near_ok = z > near
    zs = torch.where(near_ok, z, torch.ones_like(z))

    xi = x / zs
    yi = y / zs
    norm = sqrt_rn(x * x + y * y + z * z)
    visible = near_ok & (torch.abs(xi) < half_width) \
        & (torch.abs(yi) < half_height)

    # Σ2d upper-left 2x2 of (J W) Σ3d (J W)ᵀ with Σ3d = (R S)(R S)ᵀ:
    # a_ij = m_i · m_j for m = S Rᵀ (JW row_i)
    inv_z = 1.0 / zs
    inv_z2x = x * inv_z * inv_z
    inv_z2y = y * inv_z * inv_z
    w = w2c_rot
    u = [inv_z * w[0, k] - inv_z2x * w[2, k] for k in range(3)]
    v = [inv_z * w[1, k] - inv_z2y * w[2, k] for k in range(3)]
    qw, qx, qy, qz = quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]
    r = [
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx * qx + qy * qy)],
    ]
    m = [s[:, j] * (r[0][j] * u[0] + r[1][j] * u[1] + r[2][j] * u[2])
         for j in range(3)]
    n = [s[:, j] * (r[0][j] * v[0] + r[1][j] * v[1] + r[2][j] * v[2])
         for j in range(3)]
    a = m[0] * m[0] + m[1] * m[1] + m[2] * m[2]
    b = m[0] * n[0] + m[1] * n[1] + m[2] * n[2]
    d = n[0] * n[0] + n[1] * n[1] + n[2] * n[2]
    cov2d = torch.stack([a, b, b, d], dim=-1)

    mean2d = torch.stack([xi, yi], dim=-1)
    return ProjectedGaussians(mean2d=mean2d, depth=norm, cov2d=cov2d,
                              visible=visible)
