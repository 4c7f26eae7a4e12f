"""Losses & image metrics: L1, PSNR, SSIM — plain PyTorch.

The same definitions as ``gsplat_tpu/ops/losses.py``: SSIM with an 11x11
gaussian window (sigma 1.5, k1 0.01, k2 0.03) over the valid region, the
algorithm of torchmetrics' ``StructuralSimilarityIndexMeasure``.  The
separable blur is two banded matmuls, as in JAX.  They run in full float32,
forward and backward: :class:`_BandedBlur` is an autograd function whose
forward and backward each turn TF32 off for their matmuls (``allow_tf32 =
False``, the PyTorch default) and restore the caller's setting afterwards,
since TF32 keeps only ~3 decimal digits.  The backward runs later, inside
``loss.backward()``, so a setting that held only during the forward would
not reach it.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range=None
         ) -> torch.Tensor:
    """PSNR; with data_range=None it is inferred from the tensors, matching
    torchmetrics' default behaviour (reference train.py:73)."""
    if data_range is None:
        data_range = torch.maximum(pred.max(), target.max()) - torch.minimum(
            pred.min(), target.min())
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


@functools.lru_cache(maxsize=16)
def _band_matrix(n: int, kernel_size: int, sigma: float) -> np.ndarray:
    """(n, n-k+1) banded VALID-convolution matrix for the gaussian window
    (numpy; the same construction as the JAX package)."""
    coords = np.arange(kernel_size, dtype=np.float32) - (kernel_size - 1) / 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    m = n - kernel_size + 1
    band = np.zeros((n, m), np.float32)
    for i in range(kernel_size):
        band[i:i + m][np.arange(m), np.arange(m)] = g[i]
    return band


@functools.lru_cache(maxsize=16)
def _band(n: int, kernel_size: int, sigma: float, device) -> torch.Tensor:
    """The band matrix as a tensor on ``device``, built once: a fresh copy
    per call is a pageable host-to-device copy, which stalls the host."""
    return torch.from_numpy(_band_matrix(n, kernel_size, sigma)).to(device)


@contextlib.contextmanager
def _full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _BandedBlur(torch.autograd.Function):
    """(N, H, W) → (N, H', W'): x ·_H bh ·_W bw, full float32 both ways.
    The band matrices are constants and get no gradient."""

    @staticmethod
    def forward(ctx, x, bh, bw):
        ctx.save_for_backward(bh, bw)
        with _full_f32_matmul():
            y = torch.matmul(x.transpose(1, 2), bh)              # (N, W, H')
            return torch.matmul(y.transpose(1, 2), bw)           # (N, H', W')

    @staticmethod
    def backward(ctx, gz):
        bh, bw = ctx.saved_tensors
        with _full_f32_matmul():
            gy = torch.matmul(gz, bw.T)                          # (N, H', W)
            gx = torch.matmul(gy.transpose(1, 2), bh.T)          # (N, W, H)
        return gx.transpose(1, 2), None, None


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         layout: str = "hwc") -> torch.Tensor:
    """Mean SSIM over an image pair (gaussian window, valid region).

    layout="chw" takes the pipeline's channel-major (C, H, W) images;
    layout="hwc" takes (H, W, C).
    """
    if layout == "hwc":
        pred, target = pred.permute(2, 0, 1), target.permute(2, 0, 1)
    elif layout != "chw":
        raise ValueError(f"unknown layout {layout!r}")
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    p = pred.to(torch.float32)
    t = target.to(torch.float32)
    c, h, w = p.shape
    bw = _band(w, kernel_size, sigma, p.device)
    bh = _band(h, kernel_size, sigma, p.device)
    x = torch.cat([p, t, p * p, t * t, p * t], dim=0)            # (5C, H, W)
    z = _BandedBlur.apply(x, bh, bw)                             # (5C, H', W')
    mu_p, mu_t = z[:c], z[c:2 * c]
    mu_pp = z[2 * c:3 * c] - mu_p * mu_p
    mu_tt = z[3 * c:4 * c] - mu_t * mu_t
    mu_pt = z[4 * c:5 * c] - mu_p * mu_t
    num = (2 * mu_p * mu_t + c1) * (2 * mu_pt + c2)
    den = (mu_p ** 2 + mu_t ** 2 + c1) * (mu_pp + mu_tt + c2)
    return torch.mean(num / den)

