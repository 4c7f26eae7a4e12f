"""Checkpoint IO — the JAX package's format (``.npz``) and reference
``ckpt.pth`` interop.

The same files as ``gsplat_tpu/utils/checkpoint.py``: the five raw parameter
arrays ``{pos, opa, rgb, quat, scale}`` of the live rows, written as a
compressed ``.npz`` or with ``torch.save`` as ``.pth``.  Loading pads them
back into a fixed-capacity table.  The Trainer's whole state (``Trainer.
save_full``/``load_full``) uses the keys of JAX's ``save_full``
(``gsplat_tpu/train.py:698-750``), so either package resumes the other's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gsplat_tpu_torch.models.gaussians import GaussianTable, table_from_numpy
from gsplat_tpu_torch.train import GROUP_ORDER, AdamState, TrainState
from gsplat_tpu_torch.utils.so3 import inverse_sigmoid

KEYS = ("pos", "opa", "rgb", "quat", "scale")


def _live_arrays(table: GaussianTable) -> dict:
    live = table.live.cpu().numpy()
    return {k: getattr(table, k).detach().cpu().numpy()[live] for k in KEYS}


def save_checkpoint(table: GaussianTable, path: str):
    arrays = _live_arrays(table)
    if str(path).endswith(".pth"):
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in arrays.items()}, path)
    else:
        np.savez_compressed(path, **arrays)


def _from_arrays(arrays: dict, capacity_round: int, device,
                 headroom: float = 1.25) -> GaussianTable:
    n = arrays["pos"].shape[0]
    cap = max(int(math.ceil(n * headroom / capacity_round)) * capacity_round,
              capacity_round)

    def pad(x, fill=0.0):
        out = np.full((cap,) + x.shape[1:], fill, np.float32)
        out[:n] = x
        return out

    quat = np.zeros((cap, 4), np.float32)
    quat[:, 0] = 1.0
    quat[:n] = arrays["quat"]
    live = np.zeros((cap,), bool)
    live[:n] = True
    return table_from_numpy({
        "pos": pad(arrays["pos"]),
        "rgb": pad(arrays["rgb"]),
        "opa": pad(arrays["opa"].reshape(n), fill=inverse_sigmoid(1e-4)),
        "quat": quat,
        "scale": pad(arrays["scale"]),
        "live": live,
    }, n, device)


def load_checkpoint(path: str, capacity_round: int = 65536,
                    device="cuda") -> GaussianTable:
    if str(path).endswith(".pth"):
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        arrays = {k: ckpt[k].detach().float().numpy() for k in KEYS}
    else:
        with np.load(path) as z:
            arrays = {k: z[k] for k in KEYS}
    return _from_arrays(arrays, capacity_round, device)


def table_from_jax_arrays(d: dict, device) -> GaussianTable:
    """The JAX package's ``GaussianTable`` fields, as numpy arrays (``pos``,
    ``rgb``, ``opa``, ``quat``, ``scale``, ``live`` and optionally
    ``n_live``), → the port's table on ``device``, values unchanged."""
    arrays = {k: np.asarray(d[k], np.float32) for k in
              ("pos", "rgb", "opa", "quat", "scale")}
    arrays["live"] = np.asarray(d["live"], bool)
    n_live = int(d["n_live"]) if "n_live" in d else int(arrays["live"].sum())
    return table_from_numpy(arrays, n_live, device)


def train_state_from_jax_arrays(st, device) -> TrainState:
    """The JAX package's ``TrainState`` with numpy leaves (``params``,
    ``live``, ``opt.mu``/``opt.nu``/``opt.t``, ``accum_grad``,
    ``grad_counter``; e.g. ``jax.tree.map(np.asarray, state)``) → the
    port's ``TrainState`` on ``device``, values unchanged, so both packages
    can step from one optimizer state."""
    def f32(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    def group(d):
        return {k: f32(v) for k, v in d.items()}

    return TrainState(
        params=group(st.params),
        live=torch.from_numpy(np.array(st.live, bool)).to(device),
        opt=AdamState(mu=group(st.opt.mu), nu=group(st.opt.nu),
                      t=torch.tensor(int(st.opt.t), dtype=torch.int32,
                                     device=device)),
        accum_grad=f32(st.accum_grad),
        grad_counter=f32(st.grad_counter))


def save_full_state(path: str, st: TrainState, i_iter: int, k: int):
    """The whole training state as JAX's ``save_full`` writes it: params
    ``p_*``, Adam moments ``mu_*``/``nu_*`` and ``adam_t``, ``live``, the
    accumulators, ``i_iter`` and K (``cfg_k``).  JAX's TPU budget keys are
    written unset (-1, 0, empty), which JAX reads as "no budget"."""
    def np_(x):
        return x.detach().cpu().numpy()

    np.savez_compressed(
        path, i_iter=i_iter, live=np_(st.live),
        accum_grad=np_(st.accum_grad), grad_counter=np_(st.grad_counter),
        adam_t=np.int32(int(st.opt.t)),
        cfg_pair_capacity=np.int64(-1), cfg_visible_rows=np.int64(0),
        cfg_col_caps=np.zeros((0,), np.int64), cfg_k=np.int64(k),
        **{f"p_{k_}": np_(v) for k_, v in st.params.items()},
        **{f"mu_{k_}": np_(v) for k_, v in st.opt.mu.items()},
        **{f"nu_{k_}": np_(v) for k_, v in st.opt.nu.items()})


def load_full_state(path: str, device) -> tuple[TrainState, int, int]:
    """A ``save_full`` file, the port's or JAX's → (TrainState on
    ``device``, the saved iteration, K or None where the file has none).
    The TPU budget keys are ignored."""
    with np.load(path) as z:
        def t(key, dtype=torch.float32):
            return torch.from_numpy(np.array(z[key])).to(device, dtype)

        st = TrainState(
            params={k: t(f"p_{k}") for k in GROUP_ORDER},
            live=t("live", torch.bool),
            opt=AdamState(mu={k: t(f"mu_{k}") for k in GROUP_ORDER},
                          nu={k: t(f"nu_{k}") for k in GROUP_ORDER},
                          t=t("adam_t", torch.int32)),
            accum_grad=t("accum_grad"), grad_counter=t("grad_counter"))
        return st, int(z["i_iter"]), \
            int(z["cfg_k"]) if "cfg_k" in z else None
