"""Training: the train and evaluation steps, the Trainer and its CLI.

The counterparts of ``gsplat_tpu/train.py``:

- ``AdamState``/``init_adam``/``adam_update``: dense Adam with one learning
  rate per parameter group, written out with JAX's own float32 arithmetic
  (``torch.optim.Adam`` rounds differently);
- ``TrainState``, ``make_loss_fn`` ((1 − w)·L1 + w·(1 − SSIM) plus the scale
  and opacity regularizers) and ``make_train_step`` (loss, backward, Adam,
  the max/mean |∇pos| accumulation for densification);
- ``lrs_at``: the Trainer's per-group learning rates at an iteration;
- ``make_eval_step``: one camera rendered, then PSNR and SSIM;
- ``bounded_k_growth`` and ``Trainer`` (``:313-846``): the camera splits,
  the schedule, adaptive density control with capacity growth, opacity
  resets, test/evaluate, checkpoints and the training loop, on one device
  or, with ``TrainConfig.dp`` > 1, as one rank of a data-parallel group
  (``parallel/data_parallel.py``);
- ``build_argparser``/``configs_from_args``/``main`` (``:853-1058``): the
  CLI, ``python -m gsplat_tpu_torch.train --data <scene>``; ``--gui 1``
  serves the scene (``viewer.run_viewer``), ``--dp N`` trains on N ranks.

Gradients flow through the hand-written backward rasterizers (RGB or SH) on
CUDA tensors and through their plain twin on CPU tensors
(``ops/rasterize.CompositeTiles``).  With SH color the ``rgb`` group is the
(N, 27) coefficient table, and each step reads its camera's ``sh_vecs``.
Left out: the K-step ``window_scan``/``train_window`` (TPU dispatch
batching: ``Trainer.train`` and the viewer's live training take one step at
a time; ``Trainer.train`` keeps the window's semantics, the last step's
losses and the window max of the binning counters) and the static budget
retunes (the port has no static budgets).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from pprint import pprint
from typing import NamedTuple

import numpy as np
import torch

from gsplat_tpu_torch.config import SplatConfig, TrainConfig
from gsplat_tpu_torch.models.gaussians import adaptive_control, \
    grow_capacity, reset_opacity
from gsplat_tpu_torch.models.splatter import Splatter, gt_to_float, \
    render_cropped
from gsplat_tpu_torch.ops.binning import sqrt_rn
from gsplat_tpu_torch.ops.losses import l1_loss, psnr, ssim
from gsplat_tpu_torch.utils import timer
from gsplat_tpu_torch.utils.image_io import write_png
from gsplat_tpu_torch.utils.timer import StageTimer, span

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


# (beta, device) -> the f32 table of bias_correction
_BIAS_CORRECTIONS: dict = {}


def bias_correction(b: float, t: torch.Tensor) -> torch.Tensor:
    """Adam's ``1 − b**t`` in f32 for step counts ``t`` (an int tensor), the
    same bits on every device.  CUDA's ``powf`` rounds some of these one ulp
    away from the CPU's, so the values are computed once on the CPU, each as
    the 0-d expression the CPU evaluates, up to the first ``t`` at which
    ``1 − b**t`` rounds to 1 (it stays 1 after), and looked up on ``t``'s
    device."""
    key = (b, t.device)
    if key not in _BIAS_CORRECTIONS:
        vals = []
        for i in range(1 << 20):
            vals.append(1.0 - b ** torch.tensor(float(i)))
            if float(vals[-1]) == 1.0:
                break
        else:
            raise ValueError(f"Adam beta {b}: 1 - beta**t is not 1 in f32 "
                             f"by t = 2**20")
        _BIAS_CORRECTIONS[key] = torch.stack(vals).to(t.device)
    table = _BIAS_CORRECTIONS[key]
    return table[t.clamp(max=table.numel() - 1).long()]


def adam_update(params: dict, grads: dict, state: AdamState, lrs, b1: float,
                b2: float, eps: float):
    """Dense Adam with per-group learning rates (``lrs``: (5,) in
    ``GROUP_ORDER``) → (new params, new AdamState); new tensors, nothing is
    updated in place.  The expressions of ``gsplat_tpu/train.py:53-66``:
    ``(mu/bc1)/(sqrt(nu/bc2) + eps)`` with ``bc = 1 − b**t``, the same
    bits on every device: ``bc`` from ``bias_correction``, a tensor on the
    state's device (so each division is an IEEE one), the root
    ``sqrt_rn``."""
    t = state.t + 1
    bc1 = bias_correction(b1, t)
    bc2 = bias_correction(b2, t)
    new_p, new_mu, new_nu = {}, {}, {}
    for i, k in enumerate(GROUP_ORDER):
        g = grads[k]
        mu = b1 * state.mu[k] + (1 - b1) * g
        nu = b2 * state.nu[k] + (1 - b2) * g * g
        update = (mu / bc1) / (sqrt_rn(nu / bc2) + eps)
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


def lrs_at(tcfg: TrainConfig, i_iter: int, device="cuda") -> torch.Tensor:
    """(5,) float32 learning rates in ``GROUP_ORDER`` at iteration
    ``i_iter`` (the Trainer's ``lrs_at``, ``gsplat_tpu/train.py:429-433``)."""
    base = tcfg.group_lrs()
    return torch.tensor([base[g] * tcfg.lr_lambda(g, i_iter)
                         for g in GROUP_ORDER], dtype=torch.float32,
                        device=device)


def make_loss_fn(grid, cfg, tcfg: TrainConfig, bspec, rspec):
    """Loss closure: (params, live, rot, tran, gt, shv) → (loss, (metrics,
    aux, img)); ``shv`` is the camera's ``sh_vecs`` (4, 3), needed with SH
    color.  The metrics are detached."""
    ssim_w = tcfg.ssim_weight

    def loss_fn(params, live, rot, tran, gt, shv=None):
        img, aux = render_cropped(params, live, rot, tran, grid, cfg,
                                  bspec, rspec, shv)
        with span("step.loss"):
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
                    torch.abs(params["scale"]) * live[:, None]) \
                    / (3 * n_live)
            if tcfg.opa_reg > 0:
                op = torch.sigmoid(params["opa"])
                loss = loss + tcfg.opa_reg * torch.sum(
                    op * (1 - op) * live) / n_live
            metrics = {"l1": l1.detach(), "ssim": s.detach(),
                       "psnr": psnr(img.detach(), gt, data_range=1.0),
                       "loss": loss.detach()}
        return loss, (metrics, aux, img)

    return loss_fn


def make_grad_fn(splat: Splatter, tcfg: TrainConfig, group: int = 0):
    """The loss and its gradients on one camera of a group:
    ``grad_fn(state, cam_idx) → (grads, metrics, aux)``, with the gradient
    of every parameter group (autograd; the rasterizer's backward is
    ``ops/rasterize.CompositeTiles``), the detached loss metrics and the
    render's visibility mask and binning counters."""
    cfg = splat.cfg
    cams = splat.camera_groups[group]
    grid = cams.grid
    bspec, rspec = splat.specs(grid)
    loss_fn = make_loss_fn(grid, cfg, tcfg, bspec, rspec)

    def grad_fn(st: TrainState, cam_idx: int):
        rot = cams.w2c_rot[cam_idx]
        tran = cams.w2c_tran[cam_idx]
        gt = gt_to_float(cams.images[cam_idx])
        params = {k: st.params[k].detach().requires_grad_(True)
                  for k in GROUP_ORDER}
        with torch.enable_grad():
            loss, (metrics, aux, _img) = loss_fn(params, st.live, rot, tran,
                                                 gt, cams.sh_vecs[cam_idx])
            with span("step.backward"):
                grads = dict(zip(GROUP_ORDER, torch.autograd.grad(
                    loss, [params[k] for k in GROUP_ORDER],
                    allow_unused=True, materialize_grads=True)))
        return grads, metrics, aux

    return grad_fn


@torch.no_grad()
def apply_grads(st: TrainState, grads: dict, visible: torch.Tensor, lrs,
                tcfg: TrainConfig) -> TrainState:
    """Adam and the |∇pos| accumulation for densification
    (``gsplat_tpu/train.py:132-139``): ``visible`` is the float visibility
    count the "mean" method adds up.  The input state is not modified."""
    new_params, new_opt = adam_update(st.params, grads, st.opt, lrs,
                                      tcfg.adam_b1, tcfg.adam_b2,
                                      tcfg.adam_eps)
    pg = torch.abs(grads["pos"])
    if tcfg.grad_accum_method == "mean":
        accum = st.accum_grad + pg
        counter = st.grad_counter + visible
    else:  # max
        accum = torch.maximum(st.accum_grad, pg)
        counter = torch.ones_like(st.grad_counter)
    return TrainState(new_params, st.live, new_opt, accum, counter)


COUNTERS = ("n_pairs", "n_clipped", "n_max_tiles", "n_visible")


def window_metrics(window: dict | None, metrics: dict) -> dict:
    """Fold a step's metrics into its window's: the step's losses and the
    max of each binning counter over the window's steps (``window_scan``,
    ``gsplat_tpu/train.py:211-221``: an overflow in any step of the window
    reaches the K guard, not only one on its last step)."""
    if window is None:
        return metrics
    return dict(metrics, **{k: torch.maximum(window[k], metrics[k])
                            for k in COUNTERS})


@torch.no_grad()
def step_metrics(metrics: dict, counters: dict, grads: dict) -> dict:
    """A step's metrics: the loss terms, the binning counters and the
    per-group mean |gradient|."""
    return dict(metrics, **{k: counters[k] for k in COUNTERS},
                grad_mean={k: torch.mean(torch.abs(grads[k]))
                           for k in GROUP_ORDER})


def make_train_step(splat: Splatter, tcfg: TrainConfig, group: int = 0):
    """The train step of one camera group: ``train_step(state, cam_idx,
    lrs) → (new state, metrics)``.

    Loss and gradients (:func:`make_grad_fn`), then Adam and the |∇pos|
    accumulation (:func:`apply_grads`).  The metrics are 0-d tensors: the
    loss terms, the binning counters (``n_pairs``, ``n_clipped``,
    ``n_visible``, ``n_max_tiles``) and the per-group ``grad_mean``.  The
    input state is not modified.
    """
    grad_fn = make_grad_fn(splat, tcfg, group)

    def train_step(st: TrainState, cam_idx: int, lrs):
        grads, metrics, aux = grad_fn(st, cam_idx)
        with span("step.adam"):
            new = apply_grads(st, grads, aux["visible"].to(torch.float32),
                              lrs, tcfg)
            return new, step_metrics(metrics, aux, grads)

    return train_step


def make_eval_step(splat: Splatter, group: int = 0, preset: bool = False):
    """The evaluation step of one camera group; ``preset`` renders through
    the bf16 render preset (JAX's ``cfg.packed_bf16``), RGB or SH."""
    cfg = splat.cfg
    cams = splat.camera_groups[group]
    grid = cams.grid
    bspec, rspec = splat.specs(grid)

    @torch.no_grad()
    def eval_step(params, live, cam_idx: int):
        """→ (image (3, H, W), PSNR, SSIM), the metrics as 0-d tensors."""
        rot = cams.w2c_rot[cam_idx]
        tran = cams.w2c_tran[cam_idx]
        gt = gt_to_float(cams.images[cam_idx])
        img, _ = render_cropped(params, live, rot, tran, grid, cfg,
                                bspec, rspec, cams.sh_vecs[cam_idx], preset)
        return img, psnr(img, gt, data_range=1.0), \
            ssim(img, gt, data_range=1.0, layout="chw")

    return eval_step


def bounded_k_growth(cfg: SplatConfig, capacity: int, need: int) -> int:
    """The next K (tiles a gaussian may cover) when the clip guard fires
    (``gsplat_tpu/train.py:313-338``): ×1.5 rounded even, at least +2, up
    to the observed coverage ``need`` but at most 2× per event, capped by
    ``cfg.max_tiles_cap`` and by the row budget ``cfg.max_plane_rows`` on
    ``capacity · K`` (JAX's dense bound: the port has no column caps).
    Returns the current K when no bounded growth is possible."""
    k = cfg.max_tiles_per_gaussian
    k_new = max(k + 2, (int(k * 1.5) + 1) // 2 * 2,
                min((need + 1) // 2 * 2, 2 * k))
    k_new = min(k_new, max(int(cfg.max_tiles_cap), k))
    while k_new > k and capacity * k_new > cfg.max_plane_rows:
        k_new -= 2
    return max(k_new, k)


class Trainer:
    """The training loop (``gsplat_tpu/train.py:341-846``, reference
    ``train.py:16-291``), on the device of the Splatter's table.

    With ``tcfg.dp`` > 1 it is one rank of a data-parallel group: the
    default process group must be initialized with that world size.  Every
    rank then draws the same ``dp`` cameras a step from the same seeded
    generator (JAX's (K, D) camera plane, ``:526-531``) and takes the one
    at its rank; the step averages the gradients over the ranks
    (``parallel/data_parallel.make_dp_train_step``); after each host event
    rank 0's state is broadcast, and only rank 0 writes files.
    """

    def __init__(self, splat: Splatter, tcfg: TrainConfig):
        self.splat = splat
        self.tcfg = tcfg
        self.device = splat.table.device
        self.rank, self.world = 0, 1
        if tcfg.dp and tcfg.dp > 1:
            import torch.distributed as dist

            if not dist.is_initialized() \
                    or dist.get_world_size() != tcfg.dp:
                raise RuntimeError(
                    f"TrainConfig.dp={tcfg.dp} needs an initialized default "
                    f"process group of {tcfg.dp} ranks "
                    "(torch.distributed.init_process_group)")
            self.rank, self.world = dist.get_rank(), tcfg.dp
        # flat camera index over all intrinsics groups (group-major); every
        # 8th is a test camera (reference train.py:68)
        self.flat_cams = [(g, i)
                          for g, grp in enumerate(splat.camera_groups)
                          for i in range(grp.n_cameras)]
        n_cam = len(self.flat_cams)
        self.test_split = np.arange(0, n_cam, 8)
        self.train_split = np.array(
            sorted(set(range(n_cam)) - set(self.test_split.tolist())))
        self._group_train = {}   # group → its train cameras' local ids
        for fi in self.train_split:
            g, i = self.flat_cams[fi]
            self._group_train.setdefault(g, []).append(i)
        self.rng = np.random.default_rng(tcfg.seed)     # camera draws
        self.noise = torch.Generator(device=self.device)  # split samples
        self.noise.manual_seed(tcfg.seed)
        self.state = init_train_state(splat.table.params(), splat.table.live)
        self._replicate_state()
        self._step_cache = {}
        self._eval_cache = {}
        self._last_metrics = None
        self.last_densify = None      # DensifyStats of the latest event
        self.history = {"l1": [], "ssim": [], "psnr": []}

    def _train_step_for(self, g: int):
        if g not in self._step_cache:
            if self.world > 1:
                from gsplat_tpu_torch.parallel.data_parallel import \
                    make_dp_train_step
                self._step_cache[g] = make_dp_train_step(
                    self.splat, self.tcfg, group=g)
            else:
                self._step_cache[g] = make_train_step(self.splat, self.tcfg,
                                                      group=g)
        return self._step_cache[g]

    def _eval_step_for(self, g: int):
        if g not in self._eval_cache:
            self._eval_cache[g] = make_eval_step(self.splat, group=g)
        return self._eval_cache[g]

    def _rebuild_after_capacity_change(self):
        self._step_cache.clear()
        self._eval_cache.clear()

    def lrs_at(self, i_iter: int) -> torch.Tensor:
        return lrs_at(self.tcfg, i_iter, self.device)

    def _sync_table_from_state(self):
        """Write the optimizer-side params back into the splat table."""
        live = self.state.live
        self.splat.table = dataclasses.replace(
            self.splat.table, **self.state.params, live=live,
            n_live=int(live.sum()))

    def _replicate_state(self):
        """Data-parallel: every rank takes rank 0's state, K and table (no
        op on one device).  JAX's replicated sharding kept the replicas
        equal (``_replicate_state``, ``gsplat_tpu/train.py:388-394``); here
        it is a broadcast after each event that rebuilds the state."""
        if self.world == 1:
            return
        from gsplat_tpu_torch.parallel.data_parallel import replicate_state

        cfg = self.splat.cfg
        cap = self.state.live.shape[0]
        self.state, k = replicate_state(self.state,
                                        cfg.max_tiles_per_gaussian)
        self._sync_table_from_state()
        if k != cfg.max_tiles_per_gaussian \
                or cap != self.state.live.shape[0]:
            cfg.max_tiles_per_gaussian = k
            self._rebuild_after_capacity_change()

    # per-iteration event predicates (reference train.py:87-91)
    def _pre_clear(self, i: int) -> bool:
        t = self.tcfg
        return (i > 600 and
                (i + t.grad_accum_iters - 1) % t.n_adaptive_control == 0)

    def _has_post_event(self, i: int) -> bool:
        t = self.tcfg
        return ((i % t.n_opa_reset == 0 and i > 0)
                or (i > 600 and i % t.n_adaptive_control == 0))

    def _post_step(self, i_iter: int):
        t = self.tcfg
        reset_opa = i_iter % t.n_opa_reset == 0 and i_iter > 0
        in_reset = (i_iter >= t.n_opa_reset
                    and i_iter % t.n_opa_reset < t.reset_interval)
        ac_delete = i_iter > 600 and i_iter % t.n_adaptive_control == 0
        ac = (i_iter > 600 and i_iter < t.adaptive_control_end_iter
              and i_iter % t.n_adaptive_control == 0)
        if ac or ac_delete:
            with span("trainer.densify"):
                self._densify(i_iter, ac, in_reset)
        if reset_opa:
            with span("trainer.opacity_reset"):
                self._sync_table_from_state()
                self.splat.table = reset_opacity(self.splat.table)
                self.state = self.state._replace(
                    params=self.splat.table.params())
        if ac or ac_delete or reset_opa:
            self._replicate_state()

    def _draw_camera(self, group: int | None = None):
        """→ (group, camera id) of this step: from the train split, or with
        ``group`` from that group's train cameras (the later steps of a
        window, which keeps one group: JAX's ``train_window``,
        ``gsplat_tpu/train.py:524-535``).  Data-parallel: one camera a rank,
        all from the same generator on every rank, the rest from the first
        one's group (JAX's (K, D) camera plane); this rank's."""
        if group is None:
            g, cam = self.flat_cams[int(self.rng.choice(self.train_split))]
        else:
            g, cam = group, int(self.rng.choice(self._group_train[group]))
        if self.world > 1:
            pool = self._group_train[g]
            cams = [cam] + [int(self.rng.choice(pool))
                            for _ in range(self.world - 1)]
            cam = cams[self.rank]
        return g, cam

    def _step(self, i_iter: int, group: int | None = None):
        """The step of iteration ``i_iter`` on a camera drawn as
        :meth:`_draw_camera` draws it, without its host events → (the
        camera's group, the step's metrics)."""
        with span("trainer.step", id=i_iter):
            if self._pre_clear(i_iter):
                self.state = self.state._replace(
                    accum_grad=torch.zeros_like(self.state.accum_grad),
                    grad_counter=torch.zeros_like(self.state.grad_counter))
            g, cam = self._draw_camera(group)
            step = self._train_step_for(g)
            self.state, metrics = step(self.state, cam, self.lrs_at(i_iter))
        return g, metrics

    def train_step(self, i_iter: int):
        """One step at iteration ``i_iter``, then the iteration's host
        events → the step's metrics."""
        _, metrics = self._step(i_iter)
        self._last_metrics = metrics
        self._post_step(i_iter)
        return metrics

    def _split_noise(self, capacity: int) -> torch.Tensor:
        """The standard normal noise of the split samples, (capacity, 2,
        3), from the trainer's generator."""
        return torch.randn((capacity, 2, 3), generator=self.noise,
                           device=self.device)

    def _densify(self, i_iter: int, ac: bool, in_reset: bool):
        """Adaptive density control at ``i_iter`` (``gsplat_tpu/train.py:
        544-633``): delete, clone and split, growing the table when the
        proposals overflow it, then the K guard and a fresh Adam."""
        t = self.tcfg
        cfg = self.splat.cfg
        self._sync_table_from_state()
        grad_avg = self.state.accum_grad / (
            self.state.grad_counter[:, None] + 1e-3)
        use_clone = t.use_clone and ac and not in_reset
        use_split = t.use_split and ac and not in_reset

        def run_control(tbl, grads):
            return adaptive_control(
                tbl, grads, self._split_noise(tbl.capacity),
                taus=t.split_thresh, delete_thresh=t.delete_thresh,
                grad_thresh=t.grad_thresh, clone_dt=t.clone_dt,
                use_clone=use_clone, use_split=use_split,
                scale_activation=cfg.scale_activation,
                grad_aggregation=t.grad_aggregation)

        pre_table = self.splat.table
        new_table, stats = run_control(pre_table, grad_avg)
        mc = int(cfg.max_capacity or 0)
        grown = False
        if stats.overflowed and not (mc and pre_table.capacity >= mc):
            # The reference never drops proposals (torch.cat grows the
            # tensors, splatter.py:225-228): grow the pre-control table to
            # fit them and run the control again.  At a max_capacity
            # ceiling the clamped result stands.
            pre_table = grow_capacity(pre_table, cfg.capacity_round,
                                      min_capacity=int(stats.n_wanted * 1.1)
                                      + 1, max_capacity=mc)
            pad_n = pre_table.capacity - grad_avg.shape[0]
            if pad_n > 0:
                grad_avg = torch.cat([grad_avg, grad_avg.new_zeros(pad_n, 3)])
            new_table, stats = run_control(pre_table, grad_avg)
            grown = True
        self.splat.table = new_table
        grown = self.splat.maybe_grow() or grown
        retuned = False
        if self._last_metrics is not None:
            # K guard: grow K when the per-gaussian tile cap clips more than
            # 0.5% of the pairs
            m = self._last_metrics
            n_clip, n_pairs = int(m["n_clipped"]), max(int(m["n_pairs"]), 1)
            if n_clip > 0.005 * n_pairs:
                k_new = bounded_k_growth(cfg, self.splat.table.capacity,
                                         int(m["n_max_tiles"]))
                if k_new > cfg.max_tiles_per_gaussian:
                    cfg.max_tiles_per_gaussian = k_new
                    retuned = True
        if grown or retuned:
            self._rebuild_after_capacity_change()
        tbl = self.splat.table
        self.state = init_train_state(tbl.params(), tbl.live)  # a new Adam
        self.last_densify = stats
        if t.debug and self.rank == 0:
            print(f"[densify @{i_iter}] del={stats.n_deleted} "
                  f"clone={stats.n_cloned} split={stats.n_split} "
                  f"n_live={tbl.n_live} capacity={tbl.capacity}")

    # ------------------------------------------------------------------
    def test(self, camera_id: int, group: int = 0):
        img, p, s = self._eval_step_for(group)(
            self.state.params, self.state.live, camera_id)
        return {"image": img, "psnr": float(p), "ssim": float(s)}

    @torch.no_grad()
    def evaluate(self, fps_repeats: int = 3):
        """Test-split PSNR and SSIM means, and render FPS: the test cameras
        rendered ``fps_repeats`` times after one warm-up pass, timed by CUDA
        events on the card (``time.perf_counter`` on the CPU).  ``fps`` is
        the render alone (project, pack, composite, crop), without the
        metrics."""
        psnrs, ssims = [], []
        by_group = {}
        for fid in self.test_split:
            g, cid = self.flat_cams[fid]
            by_group.setdefault(g, []).append(cid)
        params, live = self.state.params, self.state.live
        n_frames, seconds = 0, 0.0
        for g, cids in by_group.items():
            step = self._eval_step_for(g)
            for cid in cids:
                _, p, s = step(params, live, cid)
                psnrs.append(float(p))
                ssims.append(float(s))
            cams = self.splat.camera_groups[g]
            bspec, rspec = self.splat.specs(cams.grid)

            def render(cid):
                return render_cropped(params, live, cams.w2c_rot[cid],
                                      cams.w2c_tran[cid], cams.grid,
                                      self.splat.cfg, bspec, rspec,
                                      cams.sh_vecs[cid])[0]

            for cid in cids:                            # warm-up
                render(cid)
            with StageTimer("evaluate_render", device=self.device) as st:
                for _ in range(fps_repeats):
                    for cid in cids:
                        render(cid)
            n_frames += fps_repeats * len(cids)
            seconds += st.interval
        m = self._last_metrics or {}
        return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims)),
                "fps": n_frames / max(seconds, 1e-9), "fps_frames": n_frames,
                "n_pairs": int(m.get("n_pairs", 0))}

    def save(self, path=None):
        from gsplat_tpu_torch.utils.checkpoint import save_checkpoint

        self._sync_table_from_state()
        path = path or os.path.join(self.tcfg.exp, "ckpt.npz")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        save_checkpoint(self.splat.table, path)

    def save_full(self, path: str, i_iter: int):
        """The whole training state (params, live mask, Adam moments and
        step, accumulators, K) in JAX's ``save_full`` format, so training
        resumes where it stopped (``gsplat_tpu/train.py:698-721``)."""
        from gsplat_tpu_torch.utils.checkpoint import save_full_state

        self._sync_table_from_state()
        save_full_state(path, self.state, i_iter,
                        self.splat.cfg.max_tiles_per_gaussian)

    def load_full(self, path: str) -> int:
        """Restore a :meth:`save_full` file, the port's or JAX's (whose TPU
        budget keys are ignored) → the saved iteration."""
        from gsplat_tpu_torch.utils.checkpoint import load_full_state

        self.state, i_iter, k = load_full_state(path, self.device)
        if k is not None:
            self.splat.cfg.max_tiles_per_gaussian = k
        self._sync_table_from_state()
        self._rebuild_after_capacity_change()
        return i_iter

    def save_render(self, i_iter: int, camera_id: int = 0):
        """Write a render of camera ``camera_id`` to
        ``{exp}/imgs/train_{i_iter}.png`` (reference train.py:223-228)."""
        img, _, _ = self._eval_step_for(0)(self.state.params,
                                           self.state.live, camera_id)
        arr = (img.clamp(0, 1).permute(1, 2, 0).cpu().numpy() * 255
               ).astype(np.uint8)
        d = os.path.join(self.tcfg.exp, "imgs")
        os.makedirs(d, exist_ok=True)
        write_png(os.path.join(d, f"train_{i_iter}.png"), arr)

    # ------------------------------------------------------------------
    def _is_host_boundary(self, i: int) -> bool:
        """Steps after which the loop logs or acts on the host."""
        t = self.tcfg
        return (self._has_post_event(i)
                or (i == 400 and t.render_downsample_start
                    != t.render_downsample)
                or bool(t.n_iters_test and i % t.n_iters_test == 0 and i > 0)
                or bool(t.n_save_train_img
                        and i % t.n_save_train_img == 0 and i > 0))

    def train(self, n_iters=None, metrics_every=20, log=print, start=0):
        """Iterations ``start`` … ``n_iters`` − 1 in windows of at most
        ``metrics_every`` steps that end at every host event, as JAX's
        ``train_window``s do (``gsplat_tpu/train.py:775-846``): one step at a
        time, then the host events of the window's last iteration, read
        with the window's metrics (:func:`window_metrics`: the densify's K
        guard sees the window max of the binning counters).  Each window is
        logged; at iteration 400 it moves to the target image pyramid level,
        and it evaluates and saves on the TEST and save cadences.  With
        ``tcfg.debug`` it turns the spans on (``utils/timer.py``), steps one
        iteration a window and prints the spans' per-name means every 100
        iterations."""
        t = self.tcfg
        n_iters = n_iters or t.n_iters
        if (start > 400 and t.render_downsample_start != t.render_downsample
                and self.splat.cfg.render_downsample != t.render_downsample):
            # resumed past the iter-400 pyramid switch: the fresh Splatter
            # was built at the warm-start level, apply the switch again
            self.splat.switch_resolution(t.render_downsample)
            self._rebuild_after_capacity_change()
        if t.debug:
            timer.enable(True)
        t_start = time.perf_counter()
        i = start
        while i < n_iters:
            j = i
            while (not t.debug and j < n_iters - 1
                   and j - i + 1 < metrics_every
                   and not self._is_host_boundary(j)):
                j += 1
            with span("trainer.window", id=j):
                g, metrics = None, None
                for k in range(i, j + 1):   # no host event before j
                    g, m = self._step(k, g)
                    metrics = window_metrics(metrics, m)
                self._last_metrics = metrics
                self._post_step(j)
                with span("sync.log"):
                    l1, p = float(metrics["l1"]), float(metrics["psnr"])
                    n_pairs = int(metrics["n_pairs"])
                self.history["l1"].append(l1)
                self.history["psnr"].append(p)
                its = (j + 1 - start) / (time.perf_counter() - t_start)
                log(f"iter {j}: l1={l1:.4f} psnr={p:.2f} "
                    f"pairs={n_pairs} {its:.1f} it/s")
            if (j == 400 and t.render_downsample_start
                    != t.render_downsample):
                # reference train.py:233-234: the target pyramid level after
                # a coarse warm start
                self.splat.switch_resolution(t.render_downsample)
                self._rebuild_after_capacity_change()
            if t.n_iters_test and j % t.n_iters_test == 0 and j > 0:
                ev = self.evaluate()
                log(f"TEST @{j}: psnr={ev['psnr']:.4f} ssim={ev['ssim']:.4f} "
                    f"fps={ev['fps']:.1f}")
            if (t.n_save_train_img and j % t.n_save_train_img == 0 and j > 0
                    and self.rank == 0):
                self.save()
                self.save_render(j)
            if t.debug and j % 100 == 0 and j > 0:
                pprint(timer.summary(timer.take()))
            i = j + 1
        return self.history


# ---------------------------------------------------------------------------
# CLI (flag parity with reference train.py:296-361)
# ---------------------------------------------------------------------------

def build_argparser():
    """The flags of ``gsplat_tpu/train.py:853-976`` whose fields the port
    keeps, and ``--device``.  The TPU layout flags (``--use_pallas``,
    ``--fused_pack``, ``--gather_colors``, ``--gather_geom``,
    ``--quant_depth``, ``--bf16_pack``, ``--cull_sublsb``, ``--pad_rows``)
    are not flags here: argparse rejects them."""
    p = argparse.ArgumentParser(
        description="3D gaussian splatting on one GPU (PyTorch + CUDA)")
    t = TrainConfig()
    s = SplatConfig()
    p.add_argument("--n_iters", type=int, default=t.n_iters)
    p.add_argument("--n_iters_warmup", type=int, default=t.n_iters_warmup)
    p.add_argument("--n_iters_test", type=int, default=t.n_iters_test)
    p.add_argument("--n_history_track", type=int, default=t.n_history_track)
    p.add_argument("--n_save_train_img", type=int, default=t.n_save_train_img)
    p.add_argument("--n_adaptive_control", type=int,
                   default=t.n_adaptive_control)
    p.add_argument("--render_downsample_start", type=int, default=4)
    p.add_argument("--render_downsample", type=int, default=4)
    p.add_argument("--jacobian_track", type=int, default=0,
                   help="accepted for reference-CLI parity; the projection "
                        "backward is autograd, there is no separate "
                        "jacobian to track")
    p.add_argument("--data", type=str, default=t.data)
    p.add_argument("--scale_init_value", type=float,
                   default=s.scale_init_value)
    p.add_argument("--opa_init_value", type=float, default=s.opa_init_value)
    p.add_argument("--tile_culling_method", type=str, default="prob2",
                   choices=["dist", "prob", "prob2"])
    p.add_argument("--tile_culling_dist_thresh", type=float, default=0.5)
    p.add_argument("--tile_culling_prob_thresh", type=float, default=0.05)
    p.add_argument("--lr", type=float, default=t.lr)
    p.add_argument("--lr_factor_for_scale", type=float, default=1.0)
    p.add_argument("--lr_factor_for_rgb", type=float, default=10.0)
    p.add_argument("--lr_factor_for_opa", type=float, default=10.0)
    p.add_argument("--lr_factor_for_quat", type=float, default=1.0)
    p.add_argument("--lr_decay", type=str, default="exp",
                   choices=["none", "official", "exp"])
    p.add_argument("--delete_thresh", type=float, default=t.delete_thresh)
    p.add_argument("--n_opa_reset", type=int, default=t.n_opa_reset)
    p.add_argument("--reset_interval", type=int, default=t.reset_interval)
    p.add_argument("--split_thresh", type=float, default=t.split_thresh)
    p.add_argument("--ssim_weight", type=float, default=t.ssim_weight)
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--use_sh_coeff", type=int, default=0)
    p.add_argument("--scale_reg", type=float, default=0.0)
    p.add_argument("--opa_reg", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=t.seed)
    p.add_argument("--ckpt", type=str, default="")
    p.add_argument("--scale_activation", type=str, default="abs",
                   choices=["abs", "exp"])
    p.add_argument("--fast_drawing", type=int, default=1,
                   help="render-only surfaces (render_offscreen) draw RGB "
                        "models through the bf16 render preset; training "
                        "math is always f32")
    p.add_argument("--exp", type=str, default="default")
    p.add_argument("--grad_accum_iters", type=int, default=t.grad_accum_iters)
    p.add_argument("--grad_accum_method", type=str, default="max",
                   choices=["mean", "max"])
    p.add_argument("--grad_thresh", type=float, default=t.grad_thresh)
    p.add_argument("--use_clone", type=int, default=0)
    p.add_argument("--use_split", type=int, default=1)
    p.add_argument("--clone_dt", type=float, default=t.clone_dt)
    p.add_argument("--grad_aggregation", type=str, default="max",
                   choices=["max", "mean"])
    p.add_argument("--adaptive_control_end_iter", type=int,
                   default=t.adaptive_control_end_iter)
    p.add_argument("--chunk_size", type=int, default=128,
                   help="pairs per step of the plain (CPU) compositor")
    p.add_argument("--max_tiles_per_gaussian", type=int, default=6)
    p.add_argument("--max_tiles_cap", type=int, default=64,
                   help="hard ceiling for automatic K growth")
    p.add_argument("--max_plane_rows", type=int, default=16_777_216,
                   help="bound of capacity · K for K growth")
    p.add_argument("--capacity_round", type=int, default=65536,
                   help="gaussian table capacity bucket (smaller for tiny "
                        "scenes)")
    p.add_argument("--max_capacity", type=int, default=0,
                   help="hard table-capacity ceiling (0 = none); at the "
                        "ceiling densify proposals that do not fit are "
                        "dropped")
    p.add_argument("--metrics_every", type=int, default=20)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the table, the images and the kernels "
                        "(cuda, cuda:N, or cpu for the plain versions)")
    p.add_argument("--gui", type=int, default=0,
                   help="serve the scene in the viser viewer instead of "
                        "training")
    p.add_argument("--test", type=int, default=0,
                   help="with --gui 1: load the cameras without images")
    p.add_argument("--gui_port", type=int, default=6789)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ranks, one camera each a step: rank "
                        "r on cuda:r (NCCL), or with --device cpu on the "
                        "CPU (gloo); 0 or 1 = one device")
    return p


def configs_from_args(a) -> tuple[SplatConfig, TrainConfig]:
    scfg = SplatConfig(
        use_sh_coeff=bool(a.use_sh_coeff),
        opa_init_value=a.opa_init_value,
        scale_init_value=a.scale_init_value,
        tile_culling_method=a.tile_culling_method,
        tile_culling_dist_thresh=a.tile_culling_dist_thresh,
        tile_culling_prob_thresh=a.tile_culling_prob_thresh,
        scale_activation=a.scale_activation,
        fast_drawing=bool(a.fast_drawing),
        # start at the warm-up pyramid level; the trainer switches to
        # render_downsample at iteration 400 (reference train.py:233-234)
        render_downsample=a.render_downsample_start,
        max_tiles_per_gaussian=a.max_tiles_per_gaussian,
        max_tiles_cap=a.max_tiles_cap,
        max_plane_rows=a.max_plane_rows,
        chunk_size=a.chunk_size,
        capacity_round=a.capacity_round,
        max_capacity=a.max_capacity,
    )
    tcfg = TrainConfig(
        n_iters=a.n_iters, n_iters_warmup=a.n_iters_warmup,
        n_iters_test=a.n_iters_test, n_history_track=a.n_history_track,
        n_save_train_img=a.n_save_train_img,
        n_adaptive_control=a.n_adaptive_control,
        render_downsample_start=a.render_downsample_start,
        render_downsample=a.render_downsample,
        lr=a.lr, lr_factor_for_scale=a.lr_factor_for_scale,
        lr_factor_for_rgb=a.lr_factor_for_rgb,
        lr_factor_for_opa=a.lr_factor_for_opa,
        lr_factor_for_quat=a.lr_factor_for_quat, lr_decay=a.lr_decay,
        delete_thresh=a.delete_thresh, n_opa_reset=a.n_opa_reset,
        reset_interval=a.reset_interval, split_thresh=a.split_thresh,
        grad_accum_iters=a.grad_accum_iters,
        grad_accum_method=a.grad_accum_method, grad_thresh=a.grad_thresh,
        use_clone=bool(a.use_clone), use_split=bool(a.use_split),
        clone_dt=a.clone_dt, grad_aggregation=a.grad_aggregation,
        adaptive_control_end_iter=a.adaptive_control_end_iter,
        ssim_weight=a.ssim_weight, scale_reg=a.scale_reg, opa_reg=a.opa_reg,
        seed=a.seed, exp=a.exp, data=a.data,
        ckpt=a.ckpt or None, debug=bool(a.debug), dp=a.dp,
    )
    return scfg, tcfg


def _load_splat(args, scfg, tcfg, device) -> Splatter:
    data_path = os.path.join(args.data, "sparse", "0")
    img_path = os.path.join(args.data,
                            f"images_{args.render_downsample_start}")
    return Splatter(data_path, img_path, scfg, load_ckpt=tcfg.ckpt,
                    test=bool(args.test), device=device)


def _train(args, device, log=print):
    """Build the scene and train it; rank 0 (or the one device) saves."""
    np.random.seed(args.seed)
    scfg, tcfg = configs_from_args(args)
    trainer = Trainer(_load_splat(args, scfg, tcfg, device), tcfg)
    trainer.train(metrics_every=args.metrics_every, log=log)
    if trainer.rank == 0:
        trainer.save()
    return trainer


def _dp_worker(rank: int, args, init_method: str, threads: int):
    """Rank ``rank`` of ``main``'s ``--dp`` group: cuda:rank with NCCL, or
    the CPU with gloo; it checks at the end that the replicas are equal."""
    import torch.distributed as dist

    from gsplat_tpu_torch.parallel.data_parallel import replicas_equal

    if args.device == "cpu":
        device, backend = "cpu", "gloo"
        torch.set_num_threads(threads)
    else:
        device, backend = f"cuda:{rank}", "nccl"
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=args.dp, rank=rank)
    try:
        trainer = _train(args, device,
                         log=print if rank == 0 else (lambda msg: None))
        if not replicas_equal(trainer.state):
            raise RuntimeError("data-parallel replicas differ after "
                               "training")
    finally:
        dist.destroy_process_group()


def _train_data_parallel(args):
    """``--dp N``: N ranks started with ``torch.multiprocessing`` (spawn),
    meeting at a file store in a temporary directory."""
    n = args.dp
    if args.device != "cpu":
        if args.device != "cuda":
            raise SystemExit(f"--dp {n} puts rank r on cuda:r: pass "
                             f"--device cuda or --device cpu, not "
                             f"{args.device}")
        visible = torch.cuda.device_count()
        if visible < n:
            raise SystemExit(f"--dp {n} needs {n} GPUs, one a rank; "
                             f"{visible} visible")
    threads = max(1, torch.get_num_threads() // n)
    with tempfile.TemporaryDirectory() as d:
        torch.multiprocessing.spawn(
            _dp_worker, nprocs=n, join=True,
            args=(args, "file://" + os.path.join(d, "store"), threads))


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.test and not args.gui:
        raise SystemExit(
            "--test 1 requires --gui 1 (reference train.py:395 asserts the "
            "same); for headless rendering use "
            "gsplat_tpu_torch.viewer.render_offscreen")
    if args.gui:
        from gsplat_tpu_torch.viewer import run_viewer

        np.random.seed(args.seed)
        scfg, tcfg = configs_from_args(args)
        run_viewer(_load_splat(args, scfg, tcfg, args.device),
                   port=args.gui_port)
        return
    if args.dp > 1:
        _train_data_parallel(args)
        return
    _train(args, args.device)


if __name__ == "__main__":
    main()
