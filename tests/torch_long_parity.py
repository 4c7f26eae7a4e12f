"""The port's Trainer against the JAX package's over a long horizon, on the
CPU: iterations 0 … N − 1 of the at-scale run's configuration (the
reference's fast config, ``gsplat_tpu_torch/scripts/run_garden_7k.py``) on a
tiny ``garden_hard``-kind scene, every densify event included.

Three trainers take the same camera draws (one numpy generator each, same
seed) and the same split noise (JAX's keys, fed to the port):

- ``jax_f32``: the JAX package on its dense plane, f32 throughout (the
  configuration the parity tests hold the port to);
- ``jax_default``: the JAX package with its default layout (``colcap`` with
  ``bf16_pack`` and ``quant_depth`` on), the configuration of its own
  at-scale run ``runs/7k_hard_r5``;
- ``port``: ``gsplat_tpu_torch`` on the CPU (the plain compositor).

It prints, every 100 iterations and at every densify event, each trainer's
l1, live gaussians and K, and at every TEST cadence their test-split PSNR.
An 8,192-slot ceiling caps the table as ``run_garden_7k``'s ceiling caps
the at-scale run (without one the tiny scene's table doubles at every event).
Not a pytest test (it takes minutes; its output for 3001 iterations is
``runs/torch_long_parity_tiny/train.log``):

    python tests/torch_long_parity.py --n_iters 3001
"""

import argparse
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gsplat_tpu.config import SplatConfig as JCfg  # noqa: E402
from gsplat_tpu.config import TrainConfig as JTCfg  # noqa: E402
from gsplat_tpu.models.splatter import Splatter as JSplatter  # noqa: E402
from gsplat_tpu.train import Trainer as JTrainer  # noqa: E402

from gsplat_tpu_torch.config import SplatConfig, TrainConfig  # noqa: E402
from gsplat_tpu_torch.models.splatter import Splatter  # noqa: E402
from gsplat_tpu_torch.scripts import make_synth_scene  # noqa: E402
from gsplat_tpu_torch.train import Trainer  # noqa: E402

# a tiny scene of the garden_hard kind (tests/test_torch_scene_tools.py)
TINY = dict(n_gt=3000, n_points=400, n_cams=9, w=64, h=48, focal=60.0,
            capacity_round=1024, scale_px=1.6, opa=0.6, orbit=True,
            use_sh=True, sh_ampl=0.35, noise_std=2.0)
# the at-scale run's trainer flags (run_garden_7k.REFERENCE_FLAGS)
TKW = dict(grad_thresh=2e-6, ssim_weight=0.1, lr=0.002,
           grad_accum_method="mean", grad_accum_iters=300, split_thresh=0.08,
           n_save_train_img=0)
SKW = dict(capacity_round=1024, max_tiles_cap=40, max_capacity=8192)


def feed_jax_noise(tr, seed):
    """Make the port's trainer draw JAX's split noise (as
    tests/test_torch_trainer.py does)."""
    keys = [jax.random.PRNGKey(seed), None]
    densify = tr._densify

    def wrapped(i, ac, in_reset):
        keys[0], keys[1] = jax.random.split(keys[0])
        densify(i, ac, in_reset)

    tr._densify = wrapped
    tr._split_noise = lambda cap: torch.from_numpy(
        np.array(jax.random.normal(keys[1], (cap, 2, 3))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_iters", type=int, default=1001)
    ap.add_argument("--scene", default="")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    scene = a.scene or os.path.join(tempfile.mkdtemp(), "scene")
    if not os.path.exists(os.path.join(scene, "sparse", "0")):
        make_synth_scene.main(scene, device="cpu", log=lambda msg: None,
                              **TINY)
    paths = (os.path.join(scene, "sparse", "0"),
             os.path.join(scene, "images_4"))
    tkw = dict(TKW, n_iters=a.n_iters)
    trainers = {
        "jax_f32": JTrainer(JSplatter(*paths, JCfg(
            plane_mode="dense", use_pallas=False, **SKW)), JTCfg(**tkw)),
        "jax_default": JTrainer(JSplatter(*paths, JCfg(
            use_pallas=False, **SKW)), JTCfg(**tkw)),
        "port": Trainer(Splatter(*paths, SplatConfig(**SKW), device="cpu"),
                        TrainConfig(**tkw)),
    }
    feed_jax_noise(trainers["port"], TrainConfig().seed)
    n_test = TrainConfig().n_iters_test
    print("iter  " + "  ".join(f"{k:>28s}" for k in trainers)
          + "   (l1, n_live, K)", flush=True)
    for i in range(a.n_iters):
        m = {k: tr.train_step(i) for k, tr in trainers.items()}
        if i % TrainConfig().n_adaptive_control == 0:  # densify after 600
            print(f"{i:5d} " + "  ".join(
                f"{float(m[k]['l1']):.6f} {int(tr.splat.table.n_live):7d} "
                f"{tr.splat.cfg.max_tiles_per_gaussian:3d}"
                for k, tr in trainers.items()), flush=True)
        if i % n_test == 0 and i > 0:
            print(f"TEST @{i}: " + "  ".join(
                f"{k} {tr.evaluate(fps_repeats=1)['psnr']:.4f}"
                for k, tr in trainers.items()), flush=True)


if __name__ == "__main__":
    main()
