"""The system under test, ``gsplat_tpu_torch``, as the benchmark drives it.

This is the only module of the benchmark that imports the program, and it
reaches it through its entry points: the configuration dataclasses, the
gaussian table, ``Splatter.from_scene`` with ``SceneCameras`` on a
``TileGrid``, ``Trainer`` and ``viewer.render_offscreen``.  The benchmark
hands it the arrays it made; the program's tensors never go back to the
reference.

Besides the entry points it reads, and a change to the program has to
keep: ``Trainer.state`` (``params``, ``live``, ``opt.mu``,
``accum_grad``, ``grad_counter``), ``Trainer.splat.table``,
``Trainer.splat.cfg.max_tiles_per_gaussian``, ``Trainer.tcfg.adam_b1``,
``Trainer._last_metrics["loss"]`` (the last window's last step), the
method ``Trainer._densify(i_iter, ...)``, which the densify check wraps,
and ``ops.cuda_build.BUILD_INFO``.  Where one is missing a run stops and
names it.
"""

from __future__ import annotations

import numpy as np
import torch

from splatbench import reference as ref
from splatbench.scene import PARAMS


def splat_config(config):
    from gsplat_tpu_torch.config import SplatConfig

    return SplatConfig(capacity_round=config["capacity_round"],
                       **config["splat"])


def train_config(config, seed: int):
    from gsplat_tpu_torch.config import TrainConfig

    return TrainConfig(seed=seed, **config["train"])


def scene_cameras(config, cams, images, device):
    """The ring as the program's ``SceneCameras`` (images: (M, 3, H, W)
    uint8 on the device, or None)."""
    from gsplat_tpu_torch.models.camera import TileGrid
    from gsplat_tpu_torch.models.splatter import SceneCameras

    grid = ref.Grid(config["width"], config["height"], config["focal"],
                    config["focal"])

    def f32(a):
        return torch.as_tensor(np.stack(a), dtype=torch.float32,
                               device=device)

    return SceneCameras(
        w2c_rot=f32([r for r, _ in cams]), w2c_tran=f32([t for _, t in cams]),
        sh_vecs=f32([ref.ray_vectors(r, t, grid) for r, t in cams]),
        images=images,
        grid=TileGrid(width=config["width"], height=config["height"],
                      focal_x=config["focal"], focal_y=config["focal"]),
        names=[f"ring_{i:03d}" for i in range(len(cams))])


def splatter(config, table: dict, cameras):
    """A ``Splatter`` over a copy of ``table`` (the benchmark's dict of
    tensors) and a fresh copy of the configuration."""
    from gsplat_tpu_torch.models.gaussians import GaussianTable
    from gsplat_tpu_torch.models.splatter import Splatter

    t = GaussianTable(n_live=int(table["n_live"]),
                      live=table["live"].clone(),
                      **{k: table[k].clone() for k in PARAMS})
    return Splatter.from_scene(splat_config(config), t, [cameras])


def trainer(config, table, cameras, seed: int):
    """A new Trainer over a copy of the set-up table and configuration."""
    from gsplat_tpu_torch.train import Trainer

    return Trainer(splatter(config, table, cameras),
                   train_config(config, seed))


def render(splat, w2c, config, fast=None) -> np.ndarray:
    """One viewer request → the (H, W, 3) image on the host."""
    from gsplat_tpu_torch.viewer import render_offscreen

    return render_offscreen(splat, w2c, config["width"], config["height"],
                            config["focal"], config["focal"], fast=fast)


def observe(trainer_obj, method: str, before=None, after=None):
    """Wrap one method of one Trainer object to observe it: ``before`` and
    ``after`` are called with the trainer, the arguments and (after) the
    result.  The program runs unchanged."""
    inner = getattr(trainer_obj, method, None)
    if inner is None:
        raise RuntimeError(f"splatbench: the program's Trainer has no "
                           f"{method!r}, which the benchmark observes")

    def wrapped(*args, **kwargs):
        if before is not None:
            before(trainer_obj, args)
        out = inner(*args, **kwargs)
        if after is not None:
            after(trainer_obj, args, out)
        return out

    setattr(trainer_obj, method, wrapped)


def loss_of_last_step(trainer_obj) -> float:
    """The loss of the Trainer's last logged window's last step."""
    m = getattr(trainer_obj, "_last_metrics", None)
    if m is None or "loss" not in m:
        raise RuntimeError("splatbench: the program's Trainer keeps no "
                           "_last_metrics['loss'], which the check reads")
    return float(m["loss"])


def state_arrays(trainer_obj) -> dict:
    """The Trainer's parameters, live mask and accumulators (its tensors,
    not copies)."""
    st = trainer_obj.state
    return dict(st.params, live=st.live, accum_grad=st.accum_grad,
                grad_counter=st.grad_counter)


def first_moment(trainer_obj) -> dict:
    return dict(trainer_obj.state.opt.mu)


def params(trainer_obj) -> dict:
    return dict(trainer_obj.state.params)


def live(trainer_obj) -> torch.Tensor:
    return trainer_obj.state.live


def tiles_cap(trainer_obj) -> int:
    return int(trainer_obj.splat.cfg.max_tiles_per_gaussian)


def n_live(trainer_obj) -> int:
    return int(trainer_obj.splat.table.n_live)


def build_seconds() -> float:
    """Seconds this process spent compiling the program's kernels."""
    from gsplat_tpu_torch.ops.cuda_build import BUILD_INFO

    return sum(v["seconds"] for v in BUILD_INFO.values())
