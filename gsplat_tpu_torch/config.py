"""Configuration dataclasses for the PyTorch port.

A trimmed copy of ``gsplat_tpu/config.py`` rather than an import of it, so
the port stands alone beside the JAX package.  The JAX config also carries
static-shape budgets (``visible_rows``, ``col_caps``, ``pad_rows``,
``pair_capacity``/``pair_factor``) and TPU layout switches (``plane_mode``,
``fused_pack``, ``bf16_pack``, ``quant_depth``, ``cull_sublsb``,
``gather_*``, ``post_align``, ``px_split``, ``packed_bf16``, ``use_pallas``).
The port works on dynamic shapes and picks its compositor from the tensor's
device, so none of those would do anything here and they are left out; the
render preset that ``packed_bf16`` switched on is chosen by
``fast_drawing`` where JAX's viewer chose it, and by the ``preset``
argument of ``Splatter.render`` and ``train.make_eval_step`` elsewhere.

Every field kept has the same name and default as in the JAX config; a test
(``tests/test_torch_geometry.py``) holds the two in step.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class SplatConfig:
    # --- scene / model options (reference splatter.py:324-345) ---
    near: float = 0.3
    use_sh_coeff: bool = False
    render_weight_normalize: bool = False
    opa_init_value: float = 0.3
    scale_init_value: float = 1.0
    tile_culling_method: str = "prob2"      # dist | prob | prob2
    tile_culling_dist_thresh: float = 0.5
    tile_culling_prob_thresh: float = 0.05
    scale_activation: str = "abs"           # abs | exp
    # render-only surfaces (viewer.render_offscreen) draw RGB models through
    # the bf16 render preset (bf16 pair values, tile-relative positions, f32
    # math); SH models keep the f32 route, as in JAX's Fast Mode
    fast_drawing: bool = True
    render_downsample: int = 4

    # Maximum number of (gaussian, tile) pairs emitted per gaussian: tiles
    # beyond the first K of a gaussian's bbox (row-major) are dropped and
    # counted in ``n_clipped``, exactly as in the JAX package.
    max_tiles_per_gaussian: int = 6
    # Bounds of the trainer's K growth (train.bounded_k_growth): a hard
    # ceiling, and a budget of candidate rows (capacity · K) that a
    # degenerate splat covering thousands of tiles must not push K past.
    max_tiles_cap: int = 64
    max_plane_rows: int = 16_777_216
    # Pairs per step of the plain compositor (composite_tiles_torch walks
    # the j-th chunk of every tile at once).
    chunk_size: int = 128
    tile_h: int = 16
    tile_w: int = 16
    # gaussian table capacity is rounded up to a multiple of this
    capacity_round: int = 65536
    # Hard ceiling on table capacity (0 = none).  At the ceiling,
    # densification proposals that do not fit are dropped; without one the
    # trainer grows the table and runs the control again.
    max_capacity: int = 0

    @property
    def tile_px(self) -> int:
        return self.tile_h * self.tile_w


@dataclasses.dataclass
class TrainConfig:
    # --- iteration counts (reference train.py:297-303) ---
    n_iters: int = 7001
    n_iters_warmup: int = 300
    n_iters_test: int = 200
    n_history_track: int = 100
    n_save_train_img: int = 100
    n_adaptive_control: int = 100
    render_downsample_start: int = 4
    render_downsample: int = 4

    # --- learning rates (train.py:314-319) ---
    lr: float = 0.003
    lr_factor_for_scale: float = 1.0
    lr_factor_for_rgb: float = 10.0
    lr_factor_for_opa: float = 10.0
    lr_factor_for_quat: float = 1.0
    lr_decay: str = "exp"                   # none | official | exp

    # --- densification / opacity reset (train.py:321-347) ---
    delete_thresh: float = 1.5
    n_opa_reset: int = 10000000
    reset_interval: int = 500
    split_thresh: float = 0.05
    grad_accum_iters: int = 50
    grad_accum_method: str = "max"          # mean | max
    grad_thresh: float = 0.0002
    use_clone: bool = False
    use_split: bool = True
    clone_dt: float = 0.01
    grad_aggregation: str = "max"           # max | mean
    adaptive_control_end_iter: int = 1000000000

    # --- losses (train.py:325-329) ---
    ssim_weight: float = 0.1
    scale_reg: float = 0.0
    opa_reg: float = 0.0

    # --- misc ---
    seed: int = 2023
    exp: str = "default"
    data: str = "colmap_garden/"
    ckpt: Optional[str] = None
    debug: bool = False
    # data-parallel training: ranks of the default process group, one
    # camera each per step (parallel/data_parallel.py); 0 or 1 = one device
    dp: int = 0

    adam_b1: float = 0.9
    adam_b2: float = 0.99                   # reference train.py:63 betas=(0.9, 0.99)
    adam_eps: float = 1e-8

    def lr_lambda(self, group: str, i_iter: int) -> float:
        """Per-group LR multiplier, matching reference train.py:27-55.

        Groups: opa, rgb, pos, scale, quat.
        """
        w = self.n_iters_warmup
        if i_iter <= w:
            return i_iter / w
        if self.lr_decay == "none":
            return 0.2 ** ((i_iter - w) // 2000)
        gamma = 0.01 ** (1.0 / (self.n_iters - w))
        if self.lr_decay == "official":
            # only opa + pos decay (reference train.py:30-37)
            if group in ("opa", "pos"):
                return gamma ** (i_iter - w)
            return 1.0
        # "exp": every group decays (train.py:47-55)
        return gamma ** (i_iter - w)

    def group_lrs(self) -> dict:
        return {
            "opa": self.lr * self.lr_factor_for_opa,
            "rgb": self.lr * self.lr_factor_for_rgb,
            "pos": self.lr * 1.0,
            "scale": self.lr * self.lr_factor_for_scale,
            "quat": self.lr * self.lr_factor_for_quat,
        }
