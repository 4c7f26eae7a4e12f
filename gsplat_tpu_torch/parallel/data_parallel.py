"""Camera-level data-parallel training, one process per GPU.

The port of ``gsplat_tpu/parallel/data_parallel.py``.  JAX runs one process
over a device mesh and gets from its sharding what is written out here:

- every rank renders its own camera against its replica of the gaussian
  table and computes the gradients of the loss;
- **one** ``all_reduce`` of a flat buffer (sum, then ÷ world size) averages
  the five gradient groups, the float visibility count (``grad_accum_method
  = "mean"``) and the loss metrics: JAX's ``pmean`` (``:59-67``,
  ``gsplat_tpu/train.py:176-179``);
- a second ``all_reduce(MAX)`` of the binning counters, so the K guard sees
  the worst rank (``gsplat_tpu/train.py:180-184``);
- the Adam update and |∇pos| accumulation of the one-device step
  (``train.apply_grads``), the same on every rank, so replicas stay equal;
- ``replicate_state``: rank 0's state broadcast to every rank, after the
  host events that rebuild it (JAX's replicated sharding, ``:143-145``).

Every rank holds the scene's images, as JAX's Trainer window does
(``:111-113``), so ``DPCameras`` and ``shard_cameras`` have no counterpart.
The effective batch is the world size: that many cameras a step.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gsplat_tpu_torch.train import COUNTERS, GROUP_ORDER, AdamState, \
    TrainState, apply_grads, make_grad_fn, step_metrics
from gsplat_tpu_torch.utils.timer import span

METRICS = ("l1", "ssim", "psnr", "loss")


def make_dp_train_step(splat, tcfg, group: int = 0, process_group=None):
    """The per-rank data-parallel step of one camera group:
    ``dp_step(state, cam_idx, lrs) → (new state, metrics)``, the signature
    of ``train.make_train_step``, with ``cam_idx`` this rank's camera.

    The gradients, the visibility count and the loss metrics are averaged
    over ``process_group`` (default: the default group) in one
    ``all_reduce``; the binning counters are their maximum over the ranks.
    """
    grad_fn = make_grad_fn(splat, tcfg, group)
    mean_accum = tcfg.grad_accum_method == "mean"

    def dp_step(st: TrainState, cam_idx: int, lrs):
        grads, metrics, aux = grad_fn(st, cam_idx)
        world = dist.get_world_size(process_group)
        with torch.no_grad():
            parts = [grads[k].reshape(-1) for k in GROUP_ORDER]
            if mean_accum:
                parts.append(aux["visible"].to(torch.float32))
            parts.append(torch.stack([metrics[k] for k in METRICS]))
            flat = torch.cat(parts)
            dist.all_reduce(flat, group=process_group)
            flat /= world
            counters = torch.stack([aux[k].to(torch.int64)
                                    for k in COUNTERS])
            dist.all_reduce(counters, op=dist.ReduceOp.MAX,
                            group=process_group)
            sizes = [grads[k].numel() for k in GROUP_ORDER]
            if mean_accum:
                sizes.append(st.grad_counter.numel())
            sizes.append(len(METRICS))
            pieces = torch.split(flat, sizes)
            grads = {k: p.view_as(grads[k])
                     for k, p in zip(GROUP_ORDER, pieces)}
            visible = pieces[len(GROUP_ORDER)] if mean_accum else None
            metrics = dict(zip(METRICS, pieces[-1].unbind()))
            with span("step.adam"):
                new = apply_grads(st, grads, visible, lrs, tcfg)
                return new, step_metrics(
                    metrics, dict(zip(COUNTERS, counters.unbind())), grads)

    return dp_step


def _float_leaves(st: TrainState) -> list:
    return ([st.params[k] for k in GROUP_ORDER]
            + [st.opt.mu[k] for k in GROUP_ORDER]
            + [st.opt.nu[k] for k in GROUP_ORDER]
            + [st.accum_grad, st.grad_counter])


def replicate_state(st: TrainState, k: int, process_group=None):
    """Rank 0's ``TrainState`` and K (tiles a gaussian may cover) on every
    rank of ``process_group`` → (state, K), new tensors on each rank's
    device; the input is not modified.

    Rank 0 broadcasts its capacity, Adam step and K first, so a rank whose
    table grew differently takes rank 0's capacity; then one buffer of
    every float leaf (parameters, moments, accumulators) and the live
    mask."""
    dev = st.live.device
    src = dist.get_global_rank(process_group, 0) \
        if process_group is not None else 0
    head = torch.tensor([st.live.shape[0], int(st.opt.t), k],
                        dtype=torch.int64, device=dev)
    dist.broadcast(head, src, group=process_group)
    cap, t, k = (int(v) for v in head.cpu())
    leaves = _float_leaves(st)
    shapes = [(cap,) + tuple(x.shape[1:]) for x in leaves]
    if cap == st.live.shape[0]:
        flat = torch.cat([x.reshape(-1) for x in leaves])
        live = st.live.to(torch.uint8)
    else:
        flat = torch.empty(sum(torch.Size(s).numel() for s in shapes),
                           dtype=torch.float32, device=dev)
        live = torch.empty(cap, dtype=torch.uint8, device=dev)
    dist.broadcast(flat, src, group=process_group)
    dist.broadcast(live, src, group=process_group)
    out = [p.view(s) for p, s in zip(
        torch.split(flat, [torch.Size(s).numel() for s in shapes]), shapes)]
    n = len(GROUP_ORDER)
    params, mu, nu = (dict(zip(GROUP_ORDER, out[i * n:(i + 1) * n]))
                      for i in range(3))
    opt = AdamState(mu=mu, nu=nu, t=torch.tensor(t, dtype=torch.int32,
                                                 device=dev))
    return TrainState(params=params, live=live.bool(), opt=opt,
                      accum_grad=out[3 * n], grad_counter=out[3 * n + 1]), k


def replicas_equal(st: TrainState, process_group=None) -> bool:
    """True on every rank when every rank's state equals rank 0's bit for
    bit (NaN payloads included: densification's dead slots turn NaN)."""
    ref, _ = replicate_state(st, 0, process_group)
    same = ref.live.shape == st.live.shape and int(ref.opt.t) == int(
        st.opt.t) and torch.equal(ref.live, st.live) and all(
        torch.equal(a.view(torch.int32), b.view(torch.int32))
        for a, b in zip(_float_leaves(ref), _float_leaves(st)))
    flag = torch.tensor([int(same)], dtype=torch.int64,
                        device=st.live.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=process_group)
    return bool(flag.item())
