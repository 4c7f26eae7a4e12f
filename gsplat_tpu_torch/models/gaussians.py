"""Fixed-capacity gaussian parameter table, its initialisation and
adaptive density control.

The layout of ``gsplat_tpu/models/gaussians.py``: five parameter tensors
padded to a ``capacity`` with a ``live`` mask, so a table built from the
same numpy arrays holds the same values in both packages.  ``rgb`` holds 3
color logits, or 27 SH coefficients when the model uses SH color.

Densification keeps JAX's fixed-capacity form, although PyTorch could
resize the tensors: deletes, clones and splits are compacted into the same
capacity as ``[kept..., clones..., splits...]``, and capacity grows by
buckets (``grow_capacity``), so a table's shape and the trainer's state
stay those of the JAX package and a test can compare them slot by slot.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from gsplat_tpu_torch.ops.binning import div_rn, sqrt_rn
from gsplat_tpu_torch.ops.projection import activate_scale
from gsplat_tpu_torch.ops.sh import initialize_sh
from gsplat_tpu_torch.utils.so3 import inverse_sigmoid, quat_to_rotmat

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
    device="cuda",
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


class DensifyStats(NamedTuple):
    n_deleted: int
    n_cloned: int
    n_split: int
    overflowed: bool   # capacity exhausted: the caller should grow and rerun
    n_wanted: int      # keep + clone + split, before the clamp to capacity


@torch.no_grad()
def adaptive_control(table: GaussianTable, grad: torch.Tensor,
                     eps: torch.Tensor, taus: float, delete_thresh: float,
                     grad_thresh: float, clone_dt: float, use_clone: bool,
                     use_split: bool, scale_activation: str = "abs",
                     grad_aggregation: str = "max"
                     ) -> tuple[GaussianTable, DensifyStats]:
    """Delete / clone / split, compacted into the same capacity
    (``gsplat_tpu/models/gaussians.py:135-226``, the reference's
    ``Gaussian3ds.adaptive_control``).

    ``grad`` (N, 3) is the averaged accumulated |∇pos|; ``eps`` (N, 2, 3)
    is the standard normal noise of the two split samples (JAX draws it
    from a key, ``:184``; here the caller draws it, so a test can give both
    packages the same draws).  The input table is not modified: on
    overflow the caller grows it and runs the control again.
    """
    cap = table.capacity
    s_act = activate_scale(table.scale, scale_activation)
    scale_norm = sqrt_rn((s_act * s_act).sum(dim=-1))

    # 1. delete: low opacity or oversized
    keep = table.live & (table.opa > inverse_sigmoid(0.02)) \
        & (scale_norm < delete_thresh)

    # 2. densify candidates
    g = grad.abs()
    g = g.amax(dim=-1) if grad_aggregation == "max" else g.mean(dim=-1)
    densify = keep & (g > grad_thresh)
    split = densify & (scale_norm > taus) & bool(use_split)
    clone = densify & (scale_norm <= taus) & bool(use_clone)

    # 3. split shrink and two-point sampling pos + (R S) eps
    if scale_activation == "abs":
        new_scale = torch.where(split[:, None], div_rn(table.scale, 1.6),
                                table.scale)
    else:
        new_scale = torch.where(split[:, None], table.scale - math.log(1.6),
                                table.scale)
    q = table.quat / (sqrt_rn((table.quat * table.quat).sum(
        dim=-1, keepdim=True)) + 1e-12)
    rs = quat_to_rotmat(q) * s_act[:, None, :]
    # (R S) eps written out in f32, so no matmul setting (TF32) reaches it
    p1, p2 = (table.pos + (rs[..., 0] * e[:, None, 0]
                           + rs[..., 1] * e[:, None, 1]
                           + rs[..., 2] * e[:, None, 2])
              for e in (eps[:, 0], eps[:, 1]))
    kept_pos = torch.where(split[:, None], p1, table.pos)
    clone_pos = table.pos - grad * clone_dt

    # 4. compact [kept..., clones..., splits...]; slots past the capacity
    # are dropped
    counts = torch.stack([keep.sum(), clone.sum(), split.sum(),
                          (table.live & ~keep).sum()]).tolist()
    n_keep, n_clone, n_split, n_deleted = counts
    ranks = (torch.cumsum(keep, 0) - 1,
             n_keep + torch.cumsum(clone, 0) - 1,
             n_keep + n_clone + torch.cumsum(split, 0) - 1)
    sel = [m & (r < cap) for m, r in zip((keep, clone, split), ranks)]

    def compact(kept_vals, clone_vals, split_vals, fill=0.0):
        out = torch.full_like(kept_vals, fill)
        for m, r, v in zip(sel, ranks, (kept_vals, clone_vals, split_vals)):
            out[r[m]] = v[m]
        return out

    n_wanted = n_keep + n_clone + n_split
    new_n = min(n_wanted, cap)
    new_table = GaussianTable(
        pos=compact(kept_pos, clone_pos, p2),
        rgb=compact(table.rgb, table.rgb, table.rgb),
        opa=compact(table.opa, table.opa, table.opa,
                    fill=inverse_sigmoid(1e-4)),
        quat=compact(table.quat, table.quat, table.quat),
        scale=compact(new_scale, table.scale, new_scale),
        live=torch.arange(cap, device=table.device) < new_n,
        n_live=new_n,
    )
    return new_table, DensifyStats(n_deleted=n_deleted, n_cloned=n_clone,
                                   n_split=n_split,
                                   overflowed=n_wanted > cap,
                                   n_wanted=n_wanted)


def reset_opacity(table: GaussianTable) -> GaussianTable:
    """Clamp every live opacity to logit(0.01) (reference
    ``splatter.py:119-120``)."""
    opa = torch.where(table.live,
                      torch.full_like(table.opa, inverse_sigmoid(0.01)),
                      table.opa)
    return dataclasses.replace(table, opa=opa)


def grow_capacity(table: GaussianTable, capacity_round: int,
                  headroom: float = 1.5, min_capacity: int = 0,
                  max_capacity: int = 0) -> GaussianTable:
    """Bucketed capacity growth (``gsplat_tpu/models/gaussians.py:235-266``):
    ``n_live · headroom`` or at least ``min_capacity`` slots (the overflow
    retry's need), rounded up to ``capacity_round``, and at most
    ``max_capacity`` (0: no ceiling).  New slots are dead, with opacity
    logit(1e-4).  Returns the table itself when it would not grow."""
    new_cap = round_capacity(max(int(table.n_live * headroom), min_capacity),
                             capacity_round)
    if max_capacity:
        new_cap = min(new_cap, max(round_capacity(max_capacity,
                                                  capacity_round),
                                   table.capacity))
    if new_cap <= table.capacity:
        return table

    def pad(x, fill=0.0):
        extra = torch.full((new_cap - x.shape[0],) + tuple(x.shape[1:]),
                           fill, dtype=x.dtype, device=x.device)
        return torch.cat([x, extra])

    return GaussianTable(
        pos=pad(table.pos), rgb=pad(table.rgb),
        opa=pad(table.opa, fill=inverse_sigmoid(1e-4)),
        quat=pad(table.quat), scale=pad(table.scale),
        live=pad(table.live, fill=False), n_live=table.n_live)
