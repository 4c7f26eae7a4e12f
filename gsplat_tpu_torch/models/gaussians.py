"""Fixed-capacity gaussian parameter table and its initialisation.

The layout of ``gsplat_tpu/models/gaussians.py``: five parameter tensors
padded to a ``capacity`` with a ``live`` mask, so a table built from the
same numpy arrays holds the same values in both packages.  ``rgb`` holds 3
color logits, or 27 SH coefficients when the model uses SH color.
Adaptive density control is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from gsplat_tpu_torch.ops.sh import initialize_sh
from gsplat_tpu_torch.utils.so3 import inverse_sigmoid

PARAM_KEYS = ("pos", "rgb", "opa", "quat", "scale")


@dataclasses.dataclass
class GaussianTable:
    pos: torch.Tensor     # (N, 3)
    rgb: torch.Tensor     # (N, 3) color logits or (N, 27) SH coefficients
    opa: torch.Tensor     # (N,)  logits
    quat: torch.Tensor    # (N, 4) wxyz, unnormalized
    scale: torch.Tensor   # (N, 3) raw (abs-activated or log)
    live: torch.Tensor    # (N,)  bool
    n_live: int

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device

    def params(self) -> dict:
        """The five optimizable tensors (reference train.py:56-62 groups)."""
        return {k: getattr(self, k) for k in PARAM_KEYS}

    def to(self, device) -> "GaussianTable":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device)
                     for k in PARAM_KEYS + ("live",)})


def table_from_numpy(arrays: dict, n_live: int, device) -> GaussianTable:
    """Padded numpy arrays (the JAX table's field layout) → GaussianTable."""
    t = {k: torch.from_numpy(np.array(arrays[k])).to(device)
         for k in PARAM_KEYS + ("live",)}
    return GaussianTable(n_live=int(n_live), **t)


def round_capacity(n: int, bucket: int) -> int:
    return max(int(math.ceil(n / bucket)) * bucket, bucket)


def init_from_points(
    points: np.ndarray,
    rgbs_uint8: np.ndarray,
    use_sh_coeff: bool = False,
    opa_init_value: float = 0.3,
    scale_init_value: float = 1.0,
    scale_activation: str = "abs",
    capacity_round: int = 65536,
    headroom: float = 1.25,
    device="cpu",
) -> GaussianTable:
    """COLMAP point cloud → initial gaussian table.

    Mirrors reference scene init (``splatter.py:373-406``): color logits via
    inverse sigmoid of rgb/255 (with ``use_sh_coeff``, the DC terms of 27
    SH coefficients, ``ops/sh.initialize_sh``), opacity logits at a
    constant, identity quaternions, isotropic scales set to the mean
    distance of the 3 nearest neighbours times ``scale_init_value``
    (log-space for the exp activation), via a KD-tree.
    """
    from scipy.spatial import cKDTree

    n = points.shape[0]
    rgb01 = np.clip(rgbs_uint8.astype(np.float64) / 255.0, 1e-4, 1 - 1e-4)
    rgb_logit = -np.log(1.0 / rgb01 - 1.0)

    dist, _ = cKDTree(points).query(points, k=4)
    mean3 = dist[:, 1:].mean(axis=1) * scale_init_value
    if scale_activation == "exp":
        mean3 = np.log(np.maximum(mean3, 1e-12))

    cap = round_capacity(int(n * headroom), capacity_round)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    rgb = rgb_logit.astype(np.float32)
    if use_sh_coeff:
        rgb = initialize_sh(torch.from_numpy(rgb)).numpy()
    quat = np.zeros((cap, 4), np.float32)
    quat[:, 0] = 1.0
    live = np.zeros((cap,), bool)
    live[:n] = True
    arrays = {
        "pos": pad(points.astype(np.float32)),
        "rgb": pad(rgb),
        "opa": pad(np.full((n,), inverse_sigmoid(opa_init_value), np.float32)),
        "quat": quat,
        "scale": pad(np.repeat(mean3[:, None], 3, axis=1).astype(np.float32)),
        "live": live,
    }
    return table_from_numpy(arrays, n, device)
