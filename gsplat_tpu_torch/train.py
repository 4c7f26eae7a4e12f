"""The train step and the evaluation step of one camera group.

The counterparts of ``gsplat_tpu/train.py:38-155`` and ``:293-310``:

- ``AdamState``/``init_adam``/``adam_update``: dense Adam with one learning
  rate per parameter group, written out with JAX's own float32 arithmetic
  (``torch.optim.Adam`` rounds differently);
- ``TrainState``, ``make_loss_fn`` ((1 − w)·L1 + w·(1 − SSIM) plus the scale
  and opacity regularizers) and ``make_train_step`` (loss, backward, Adam,
  the max/mean |∇pos| accumulation for densification);
- ``lrs_at``: the Trainer's per-group learning rates at an iteration;
- ``make_eval_step``: one camera rendered, then PSNR and SSIM.

Gradients flow through the hand-written backward rasterizer on CUDA tensors
and through its plain twin on CPU tensors (``ops/rasterize.CompositeTiles``).
The K-step ``window_scan`` (TPU dispatch batching), densification and the
Trainer with its CLI are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gsplat_tpu_torch.config import TrainConfig
from gsplat_tpu_torch.models.splatter import Splatter, render_cropped
from gsplat_tpu_torch.ops.losses import l1_loss, psnr, ssim

GROUP_ORDER = ("opa", "rgb", "pos", "scale", "quat")  # train.py:56-62


class AdamState(NamedTuple):
    mu: dict
    nu: dict
    t: torch.Tensor  # () int32: steps since the last (re)init


def init_adam(params: dict) -> AdamState:
    dev = params["pos"].device
    return AdamState(mu={k: torch.zeros_like(v) for k, v in params.items()},
                     nu={k: torch.zeros_like(v) for k, v in params.items()},
                     t=torch.zeros((), dtype=torch.int32, device=dev))


def adam_update(params: dict, grads: dict, state: AdamState, lrs, b1: float,
                b2: float, eps: float):
    """Dense Adam with per-group learning rates (``lrs``: (5,) in
    ``GROUP_ORDER``) → (new params, new AdamState); new tensors, nothing is
    updated in place.  The expressions of ``gsplat_tpu/train.py:53-66``:
    ``(mu/bc1)/(sqrt(nu/bc2) + eps)`` with ``bc = 1 − b**t``."""
    t = state.t + 1
    tf = t.to(torch.float32)
    bc1 = 1.0 - b1 ** tf
    bc2 = 1.0 - b2 ** tf
    new_p, new_mu, new_nu = {}, {}, {}
    for i, k in enumerate(GROUP_ORDER):
        g = grads[k]
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * g * g
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        new_p[k] = params[k] - lrs[i] * update
        new_mu[k], new_nu[k] = mu, nu
    return new_p, AdamState(mu=new_mu, nu=new_nu, t=t)


class TrainState(NamedTuple):
    params: dict
    live: torch.Tensor
    opt: AdamState
    accum_grad: torch.Tensor    # (N, 3) accumulated |pos grad|
    grad_counter: torch.Tensor  # (N,)   per-gaussian visibility counts


def init_train_state(params: dict, live: torch.Tensor) -> TrainState:
    """A fresh state over a table's parameters (the Trainer's start,
    ``gsplat_tpu/train.py:374-380``): zero moments and accumulators."""
    return TrainState(params=dict(params), live=live,
                      opt=init_adam(params),
                      accum_grad=torch.zeros_like(params["pos"]),
                      grad_counter=torch.zeros(
                          live.shape[0], dtype=torch.float32,
                          device=live.device))


def lrs_at(tcfg: TrainConfig, i_iter: int, device="cpu") -> torch.Tensor:
    """(5,) float32 learning rates in ``GROUP_ORDER`` at iteration
    ``i_iter`` (the Trainer's ``lrs_at``, ``gsplat_tpu/train.py:429-433``)."""
    base = tcfg.group_lrs()
    return torch.tensor([base[g] * tcfg.lr_lambda(g, i_iter)
                         for g in GROUP_ORDER], dtype=torch.float32,
                        device=device)


def make_loss_fn(grid, cfg, tcfg: TrainConfig, bspec, rspec):
    """Loss closure: (params, live, rot, tran, gt) → (loss, (metrics, aux,
    img)).  The metrics are detached."""
    ssim_w = tcfg.ssim_weight

    def loss_fn(params, live, rot, tran, gt):
        img, aux = render_cropped(params, live, rot, tran, grid, cfg,
                                  bspec, rspec)
        l1 = l1_loss(img, gt)
        if ssim_w > 0:
            s = ssim(img, gt, data_range=1.0, layout="chw")
            loss = (1 - ssim_w) * l1 + ssim_w * (1.0 - s)
        else:
            s = torch.ones((), dtype=torch.float32, device=img.device)
            loss = l1
        n_live = torch.clamp_min(live.sum(), 1)
        if tcfg.scale_reg > 0:
            loss = loss + tcfg.scale_reg * torch.sum(
                torch.abs(params["scale"]) * live[:, None]) / (3 * n_live)
        if tcfg.opa_reg > 0:
            op = torch.sigmoid(params["opa"])
            loss = loss + tcfg.opa_reg * torch.sum(
                op * (1 - op) * live) / n_live
        metrics = {"l1": l1.detach(), "ssim": s.detach(),
                   "psnr": psnr(img.detach(), gt, data_range=1.0),
                   "loss": loss.detach()}
        return loss, (metrics, aux, img)

    return loss_fn


def make_train_step(splat: Splatter, tcfg: TrainConfig, group: int = 0):
    """The train step of one camera group: ``train_step(state, cam_idx,
    lrs) → (new state, metrics)``.

    Loss, gradients of every parameter group (autograd; the rasterizer's
    backward is ``ops/rasterize.CompositeTiles``), Adam, and the |∇pos|
    accumulation for densification (``gsplat_tpu/train.py:132-139``).  The
    metrics are 0-d tensors: the loss terms, the binning counters
    (``n_pairs``, ``n_clipped``, ``n_visible``, ``n_max_tiles``) and the
    per-group ``grad_mean``.  The input state is not modified.
    """
    cfg = splat.cfg
    cams = splat.camera_groups[group]
    grid = cams.grid
    bspec, rspec = splat.specs(grid)
    b1, b2, eps = tcfg.adam_b1, tcfg.adam_b2, tcfg.adam_eps
    loss_fn = make_loss_fn(grid, cfg, tcfg, bspec, rspec)

    def train_step(st: TrainState, cam_idx: int, lrs):
        rot = cams.w2c_rot[cam_idx]
        tran = cams.w2c_tran[cam_idx]
        gt = cams.images[cam_idx].to(torch.float32) / 255.0
        params = {k: st.params[k].detach().requires_grad_(True)
                  for k in GROUP_ORDER}
        with torch.enable_grad():
            loss, (metrics, aux, _img) = loss_fn(params, st.live, rot, tran,
                                                 gt)
            grads = dict(zip(GROUP_ORDER, torch.autograd.grad(
                loss, [params[k] for k in GROUP_ORDER], allow_unused=True,
                materialize_grads=True)))
        with torch.no_grad():
            new_params, new_opt = adam_update(st.params, grads, st.opt, lrs,
                                              b1, b2, eps)
            pg = torch.abs(grads["pos"])
            if tcfg.grad_accum_method == "mean":
                accum = st.accum_grad + pg
                counter = st.grad_counter + aux["visible"].to(torch.float32)
            else:  # max
                accum = torch.maximum(st.accum_grad, pg)
                counter = torch.ones_like(st.grad_counter)
            metrics = dict(metrics, n_pairs=aux["n_pairs"],
                           n_clipped=aux["n_clipped"],
                           n_max_tiles=aux["n_max_tiles"],
                           n_visible=aux["n_visible"],
                           grad_mean={k: torch.mean(torch.abs(grads[k]))
                                      for k in GROUP_ORDER})
        return TrainState(new_params, st.live, new_opt, accum,
                          counter), metrics

    return train_step


def make_eval_step(splat: Splatter, group: int = 0):
    cfg = splat.cfg
    cams = splat.camera_groups[group]
    grid = cams.grid
    bspec, rspec = splat.specs(grid)

    @torch.no_grad()
    def eval_step(params, live, cam_idx: int):
        """→ (image (3, H, W), PSNR, SSIM), the metrics as 0-d tensors."""
        rot = cams.w2c_rot[cam_idx]
        tran = cams.w2c_tran[cam_idx]
        gt = cams.images[cam_idx].to(torch.float32) / 255.0
        img, _ = render_cropped(params, live, rot, tran, grid, cfg,
                                bspec, rspec)
        return img, psnr(img, gt, data_range=1.0), \
            ssim(img, gt, data_range=1.0, layout="chw")

    return eval_step
