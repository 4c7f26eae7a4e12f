"""The at-scale quality run (``scripts/run_garden_7k.py`` of the JAX
package): 7001 densifying iterations of the Trainer at the reference's
headline workload shape, the Garden fast config (reference README.md:36:
``--grad_thresh 0.000002 --ssim_weight 0.1 --lr 0.002 --grad_accum_method
mean --grad_accum_iters 300 --split_thresh 0.08``; 506,627 gaussians at
1297x840, PSNR 24.91 at 7k), on one device.

    python -m gsplat_tpu_torch.scripts.run_garden_7k --preset garden_hard \\
        --exp runs/torch_7k_hard_rgb [--use_sh_coeff 1] [--device cuda]

No dataset ships with the repo: the scene is a preset of
``scripts/make_synth_scene.py``, built on first use in ``--scene`` (default
``<tmpdir>/<preset>_synth_torch``).  ``garden_hard`` is 1.2M SH ground-truth
gaussians with sensor noise rendered to 56 views at 1297x840, a degraded
140k-point init and a 524,288-slot capacity ceiling; the final PSNR
measures fitting power against an unreachable target, beside the oracle
ceiling the generator wrote.

Writes ``{exp}/train.log`` (appended), ``{exp}/full_state.npz`` every
``--save_every`` iterations after the step's whole post-step (so an
opacity reset of that iteration is inside it), ``{exp}/summary_partial.json``
with each save, and at the end ``ckpt.npz``, ``full_state.npz`` and
``summary.json``: the JAX summary's keys, plus ``device`` (the card's name
and power limit from nvidia-smi), ``peak_mem_gib`` and the TEST trajectory
``[[iter, psnr, ssim], ...]``.  With ``--resume 1`` (the default) a run
restarts from ``{exp}/full_state.npz`` at the iteration after the saved one.
``--stop_at N`` ends the run before iteration N with the learning-rate
schedule of ``--n_iters`` (a depth cut that follows the whole run).  Any
flag this script does not know goes to the trainer's CLI after the
reference's, so it overrides them (smaller cadences for a short check).

Left out: the JAX script's TPU route flags (``--fused_pack``,
``--gather_geom``, ``--cull_sublsb``), its tunnel probe (``--adaptive``)
and its XLA compile cache.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from gsplat_tpu_torch.bench import device_name
from gsplat_tpu_torch.models.splatter import Splatter
from gsplat_tpu_torch.scripts.make_synth_scene import PRESETS
from gsplat_tpu_torch.scripts.make_synth_scene import main as make_scene
from gsplat_tpu_torch.train import Trainer
from gsplat_tpu_torch.train import build_argparser as train_argparser
from gsplat_tpu_torch.train import configs_from_args

# the reference's fast config (README.md:36), as the JAX script passes it
REFERENCE_FLAGS = [
    "--grad_thresh", "0.000002", "--ssim_weight", "0.1", "--lr", "0.002",
    "--grad_accum_method", "mean", "--grad_accum_iters", "300",
    "--split_thresh", "0.08",
    # the synthetic init carries a fat tail of huge splats; growing K after
    # them explodes the pair count
    "--max_tiles_cap", "40",
    "--n_save_train_img", "1000",
]


def build_argparser():
    ap = argparse.ArgumentParser(
        description="the 7k-iteration densifying run on a synthetic scene")
    ap.add_argument("--scene", default="",
                    help="scene directory (built from --preset when it has "
                         "no sparse/0/points3D.bin)")
    ap.add_argument("--preset", default="garden_hard", choices=sorted(PRESETS))
    ap.add_argument("--exp", default="runs/torch_7k")
    ap.add_argument("--n_iters", type=int, default=7001)
    ap.add_argument("--stop_at", type=int, default=0,
                    help="end the run before this iteration (0: n_iters); "
                         "the schedule stays that of --n_iters, so a cut "
                         "run follows the whole run's trajectory")
    ap.add_argument("--use_sh_coeff", type=int, default=0)
    ap.add_argument("--max_capacity", type=int, default=-1,
                    help="table-capacity ceiling (-1: 524288 for "
                         "garden_hard, ~0.44x its 1.2M GT gaussians, else "
                         "none; 0: none)")
    ap.add_argument("--metrics_every", type=int, default=50)
    ap.add_argument("--save_every", type=int, default=200,
                    help="full-state checkpoint cadence (iterations)")
    ap.add_argument("--resume", type=int, default=1,
                    help="resume from {exp}/full_state.npz when present")
    ap.add_argument("--device", default="cuda",
                    help="device of the scene build and the training (cuda, "
                         "cuda:N, or cpu)")
    return ap


def main(argv=None):
    """Run (or resume) the quality run → (the summary dict, the Trainer)."""
    args, extra = build_argparser().parse_known_args(argv)
    if not args.scene:
        args.scene = os.path.join(tempfile.gettempdir(),
                                  f"{args.preset}_synth_torch")
    if args.max_capacity < 0:
        args.max_capacity = 524288 if args.preset == "garden_hard" else 0
    if not os.path.exists(os.path.join(args.scene, "sparse", "0",
                                       "points3D.bin")):
        make_scene(args.scene, device=args.device, **PRESETS[args.preset])

    os.makedirs(args.exp, exist_ok=True)
    log_f = open(os.path.join(args.exp, "train.log"), "a", buffering=1)
    test_traj = []

    def log(msg):
        print(msg, flush=True)
        log_f.write(msg + "\n")
        if msg.startswith("TEST @"):
            f = dict(kv.split("=") for kv in msg.split(":", 1)[1].split())
            test_traj.append([int(msg[6:msg.index(":")]), float(f["psnr"]),
                              float(f["ssim"])])

    flags = ["--data", args.scene, "--exp", args.exp,
             "--n_iters", str(args.n_iters),
             "--use_sh_coeff", str(args.use_sh_coeff),
             "--max_capacity", str(args.max_capacity),
             "--metrics_every", str(args.metrics_every),
             "--device", args.device] + REFERENCE_FLAGS + list(extra)
    a = train_argparser().parse_args(flags)
    scfg, tcfg = configs_from_args(a)
    try:
        t0 = time.time()
        splat = Splatter(os.path.join(args.scene, "sparse", "0"),
                         os.path.join(args.scene,
                                      f"images_{a.render_downsample_start}"),
                         scfg, device=args.device)
        log(f"scene loaded: n_live={splat.table.n_live} "
            f"capacity={splat.table.capacity} "
            f"K={splat.cfg.max_tiles_per_gaussian} ({time.time() - t0:.0f}s)")
        trainer = Trainer(splat, tcfg)
        full_path = os.path.join(args.exp, "full_state.npz")
        start = 0
        if args.resume and os.path.exists(full_path):
            start = trainer.load_full(full_path) + 1
            log(f"resumed from {full_path} at iter {start} "
                f"(n_live={trainer.splat.table.n_live} "
                f"capacity={trainer.splat.table.capacity})")
        summary = _train(args, a, trainer, start, t0, log, test_traj)
    finally:
        log_f.close()
    return summary, trainer


def _train(args, a, trainer, start, t0, log, test_traj):
    """The hooked training loop, the final evaluation and the summaries."""
    full_path = os.path.join(args.exp, "full_state.npz")

    def table():
        return trainer.splat.table

    cap_traj = [(start, table().n_live, table().capacity)]

    densify = trainer._densify

    def densify_logged(i_iter, ac, in_reset):
        densify(i_iter, ac, in_reset)
        cap_traj.append((i_iter, table().n_live, table().capacity))
        log(f"densify @{i_iter}: n_live={cap_traj[-1][1]} "
            f"capacity={cap_traj[-1][2]} "
            f"K={trainer.splat.cfg.max_tiles_per_gaussian} "
            f"t={time.time() - t0:.0f}s")

    end = args.stop_at or a.n_iters
    # steady it/s: the wall time of the last quarter of the run, past the
    # growth phase
    steady_from = max(start, end - max(end // 4, 500))
    steady_mark = [None]
    last_save = [start]
    post = trainer._post_step

    def post_save(i_iter):
        # save after the whole post-step, so that an opacity reset of this
        # iteration is inside the checkpoint; the cadence is the distance
        # since the last save
        post(i_iter)
        if i_iter - last_save[0] >= args.save_every:
            trainer.save_full(full_path, i_iter)
            last_save[0] = i_iter
            # a run cut by the wall clock still says how far it got
            with open(os.path.join(args.exp, "summary_partial.json"),
                      "w") as f:
                json.dump({
                    "iters_done": i_iter, "wall_s": time.time() - t0,
                    "it_per_s_incl_compiles": (i_iter - start)
                    / max(time.time() - t0, 1e-9),
                    "n_gaussians": table().n_live,
                    "capacity_trajectory": cap_traj,
                    "use_sh_coeff": args.use_sh_coeff,
                    "scene_preset": args.preset,
                    "test_trajectory": test_traj,
                }, f, indent=1)
        if steady_mark[0] is None and i_iter >= steady_from:
            steady_mark[0] = (i_iter, time.time())

    trainer._densify, trainer._post_step = densify_logged, post_save
    try:
        trainer.train(end, metrics_every=a.metrics_every, log=log,
                      start=start)
    finally:
        trainer._densify, trainer._post_step = densify, post
    wall = time.time() - t0
    steady_it_s = None
    if steady_mark[0] and end - steady_mark[0][0] > 100:
        steady_it_s = ((end - steady_mark[0][0])
                       / max(time.time() - steady_mark[0][1], 1e-9))
    ev = trainer.evaluate()
    trainer.save()
    # the last iteration trained is end - 1: a resume starts at end
    trainer.save_full(full_path, max(end - 1, start - 1))
    ceiling = None
    ceil_path = os.path.join(args.scene, "gt_ceiling.json")
    if os.path.exists(ceil_path):
        with open(ceil_path) as f:
            ceiling = json.load(f)
    dev = torch.device(args.device)
    summary = {
        "n_iters": end, "wall_s": wall,
        "it_per_s_incl_compiles": (end - start) / wall,
        "steady_it_per_s": steady_it_s,
        "final_psnr": ev["psnr"], "final_ssim": ev["ssim"],
        "final_fps": ev["fps"],
        "eval_fps_basis": ev.get("fps_frames"),
        "n_gaussians": table().n_live,
        "capacity_trajectory": cap_traj,
        "use_sh_coeff": args.use_sh_coeff,
        "scene_preset": args.preset,
        "max_capacity": args.max_capacity,
        "oracle_ceiling": ceiling,
        "device": device_name(dev),
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None),
        "test_trajectory": test_traj,
    }
    log("SUMMARY " + json.dumps(summary))
    with open(os.path.join(args.exp, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


if __name__ == "__main__":
    main()
