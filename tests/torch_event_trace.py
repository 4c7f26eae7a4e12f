"""Where the port and JAX's f32 route part at a densify event, step by step,
on the CPU: an event of ``tests/torch_long_parity.py``'s ``mid`` scene,
from one shared state.

JAX's ``jax_f32`` trainer (dense plane, f32) trains iterations 0 … START − 1
through ``Trainer.train`` (``--drive step``: ``train_step(i)``, as the
harness's step drive does); its state, K and camera generator are carried into
the port (``utils/checkpoint.train_state_from_jax_arrays``).  Both then take
``train_step(i)`` for i = START … EVENT − 1 on the same cameras, and the
script prints, per step, the l1 of both, JAX's dropped pairs (``n_dropped``:
its TPU slot budget) and the port's relative distance from JAX in the
accumulated |∇pos| and the visibility counter.  Before the event it prints
the K guard's inputs as each ``Trainer.train`` would hand them over (the
window max over START … EVENT, JAX's ``window_scan``) and as the last step
alone gives them (the port's ``train_step``); then both densify at EVENT
(``train_step(EVENT)``, the port fed JAX's split noise) and it prints the
masks' agreement, n_live, capacity, K, and each test view rendered right
after the event: PSNR from both, JAX's dropped pairs in that render, and the
image's max difference, with JAX's pair budget as it stands and with it
lifted above any view's pairs.  At the event it also prints how far the
two packages' ``adaptive_control`` inputs are apart and in which slots their
delete / clone / split decisions differ, with those slots' |∇pos| over
``grad_thresh`` (a decision that differs shifts every compacted row after
it, so the params after the event are compared slot by slot only as a
bound).  ``--lift 1`` starts from
``jax_f32_nobudget`` instead (the harness's budget-free JAX trainer).  Not
a pytest test (~15 min to event 700, ~2 GB):

    python tests/torch_event_trace.py [--start 600 --event 700 --lift 0 \
        --drive train]
"""

import argparse
import dataclasses
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import gsplat_tpu.train as jtrain  # noqa: E402
from gsplat_tpu.config import SplatConfig as JCfg  # noqa: E402
from gsplat_tpu.config import TrainConfig as JTCfg  # noqa: E402
from gsplat_tpu.models.splatter import Splatter as JSplatter  # noqa: E402
from gsplat_tpu.models.splatter import make_specs as j_make_specs  # noqa
from gsplat_tpu.models.splatter import render_cropped as j_render  # noqa

from gsplat_tpu_torch.config import SplatConfig, TrainConfig  # noqa: E402
from gsplat_tpu_torch.models.splatter import Splatter  # noqa: E402
from gsplat_tpu_torch.models.splatter import render_cropped  # noqa: E402
import gsplat_tpu_torch.train as ttrain  # noqa: E402
from gsplat_tpu_torch.train import Trainer  # noqa: E402
from gsplat_tpu_torch.utils.checkpoint import \
    train_state_from_jax_arrays  # noqa: E402

import torch_long_parity as H  # noqa: E402

NO_BUDGET = 1 << 18      # slots: above any mid view's pairs and pads


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def capture(store, name, control):
    """Wrap an ``adaptive_control``: keep the table and averaged gradient of
    its latest call under ``store[name]``."""
    def wrapped(table, grad, *args, **kw):
        store[name] = (table, grad)
        return control(table, grad, *args, **kw)
    return wrapped


def decisions(table, grad, t, cfg):
    """The delete / clone / split masks of ``adaptive_control``'s steps 1-2
    (``gsplat_tpu_torch/models/gaussians.py``) on either package's inputs,
    computed the port's way → (masks, each slot's |∇pos| statistic)."""
    from gsplat_tpu_torch.ops.projection import activate_scale
    from gsplat_tpu_torch.utils.so3 import inverse_sigmoid

    def f(x):
        return torch.from_numpy(np.array(x))

    s = activate_scale(f(table.scale), cfg.scale_activation)
    norm = torch.sqrt((s * s).sum(-1))
    keep = f(table.live) & (f(table.opa).reshape(-1) > inverse_sigmoid(0.02)) \
        & (norm < t.delete_thresh)
    g = f(grad).abs()
    g = g.amax(-1) if t.grad_aggregation == "max" else g.mean(-1)
    dense = keep & (g > t.grad_thresh)
    return {"keep": keep, "clone": dense & (norm <= t.split_thresh),
            "split": dense & (norm > t.split_thresh)}, g


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--start", type=int, default=600)
    ap.add_argument("--event", type=int, default=700)
    ap.add_argument("--scene", default="")
    ap.add_argument("--drive", choices=("train", "step"), default="train",
                    help="how JAX reaches START: Trainer.train (the harness's "
                         "--drive train) or train_step(i) (--drive step)")
    ap.add_argument("--lift", type=int, default=0,
                    help="1: JAX's pair budget lifted as the harness's "
                         "jax_f32_nobudget lifts it (so no pair drops)")
    a = ap.parse_args(argv)
    torch.set_num_threads(1)
    scene = a.scene or os.path.join(tempfile.mkdtemp(), "scene")
    sz = H.SCENES["mid"]
    if not os.path.exists(os.path.join(scene, "sparse", "0")):
        from gsplat_tpu_torch.scripts import make_synth_scene

        make_synth_scene.main(scene, device="cpu", log=lambda msg: None,
                              **sz["scene"])
    paths = (os.path.join(scene, "sparse", "0"),
             os.path.join(scene, "images_4"))
    skw = dict(capacity_round=sz["scene"]["capacity_round"],
               max_tiles_cap=H.MAX_TILES_CAP, max_capacity=sz["ceiling"],
               **sz["skw"])
    tkw = dict(H.TKW, **sz["tkw"])
    jt = jtrain.Trainer(JSplatter(*paths, JCfg(
        plane_mode="dense", use_pallas=False, **skw)), JTCfg(**tkw))
    if a.lift:
        H.lift_budget(jt)
    if a.drive == "train":
        jt.train(a.start, metrics_every=H.METRICS_EVERY, log=lambda s: None)
    else:
        for i in range(a.start):
            jt.train_step(i)
    print(f"jax_f32{'_nobudget' if a.lift else ''} trained 0-{a.start - 1} "
          f"(drive {a.drive}): "
          f"n_live "
          f"{int(jt.splat.table.n_live)}, K "
          f"{jt.splat.cfg.max_tiles_per_gaussian}, pair budget "
          f"{jt.splat.cfg.pair_capacity}", flush=True)

    tt = Trainer(Splatter(*paths, SplatConfig(**skw), device="cpu"),
                 TrainConfig(**tkw))
    tt.state = train_state_from_jax_arrays(
        jax.tree.map(np.asarray, jt.state), "cpu")
    tt._sync_table_from_state()
    tt.splat.cfg.max_tiles_per_gaussian = jt.splat.cfg.max_tiles_per_gaussian
    tt._rebuild_after_capacity_change()
    tt.rng.bit_generator.state = jt.rng.bit_generator.state
    # the port draws JAX's split noise, from JAX's key as it stands
    keys = [jt.sample_rng, None]
    densify = tt._densify

    def fed(i, ac, in_reset):
        keys[0], keys[1] = jax.random.split(keys[0])
        densify(i, ac, in_reset)

    tt._densify = fed
    tt._split_noise = lambda cap: torch.from_numpy(
        np.array(jax.random.normal(keys[1], (cap, 2, 3))))

    print("\nstep   l1 jax     l1 port    jax n_dropped  n_pairs j/p   "
          "accum rel  counter rel")
    window = {"jax": {}, "port": {}}
    for i in range(a.start, a.event):
        jm, tm = jt.train_step(i), tt.train_step(i)
        for name, m in (("jax", jm), ("port", tm)):
            for k in H.GUARD:
                window[name][k] = max(window[name].get(k, 0), int(m[k]))
        # live rows only: a densify leaves dead slots NaN (ROADMAP §3)
        lv = tt.state.live.numpy()
        acc = rel(tt.state.accum_grad.numpy()[lv],
                  np.asarray(jt.state.accum_grad)[lv])
        cnt = rel(tt.state.grad_counter.numpy()[lv],
                  np.asarray(jt.state.grad_counter)[lv])
        print(f"{i:5d} {float(jm['l1']):.7f} {float(tm['l1']):.7f} "
              f"{int(jm['n_dropped']):10d}   {int(jm['n_pairs']):6d} "
              f"{int(tm['n_pairs']):6d}   {acc:.2e}   {cnt:.2e}", flush=True)
        if i == a.event - H.METRICS_EVERY:
            window = {"jax": {}, "port": {}}   # the window that ends at EVENT

    # the event: its own step, then the densify (train_step(EVENT)), each
    # package's adaptive_control inputs kept
    inputs = {}
    jtrain.adaptive_control = capture(inputs, "jax", jtrain.adaptive_control)
    ttrain.adaptive_control = capture(inputs, "port",
                                      ttrain.adaptive_control)
    live0 = np.asarray(jt.state.live)
    jm, tm = jt.train_step(a.event), tt.train_step(a.event)
    for name, m in (("jax", jm), ("port", tm)):
        for k in H.GUARD:
            window[name][k] = max(window[name].get(k, 0), int(m[k]))
    print(f"\nK guard inputs at {a.event}: window max over "
          f"{a.event - H.METRICS_EVERY + 1}-{a.event} jax {window['jax']} "
          f"port {window['port']}; the last step alone jax "
          f"{ {k: int(jm[k]) for k in H.GUARD} } port "
          f"{ {k: int(tm[k]) for k in H.GUARD} }")
    jl, tl = np.asarray(jt.state.live), tt.state.live.numpy()
    print(f"densify @{a.event}: live masks equal {np.array_equal(jl, tl)} "
          f"({int((jl != tl).sum())} slots differ); n_live jax "
          f"{int(jt.splat.table.n_live)} port {tt.splat.table.n_live} (from "
          f"{int(live0.sum())}); capacity {int(jt.splat.table.capacity)} / "
          f"{tt.splat.table.capacity}; K {jt.splat.cfg.max_tiles_per_gaussian}"
          f" / {tt.splat.cfg.max_tiles_per_gaussian}; pair budget "
          f"{jt.splat.cfg.pair_capacity}")
    # the decisions from each package's inputs: which slots they differ in,
    # and how near the threshold those slots' gradients are
    (jtab, jgrad), (ttab, tgrad) = inputs["jax"], inputs["port"]
    lv_in = np.array(jtab.live)
    gap = {k: rel(np.array(getattr(ttab, k))[lv_in],
                  np.array(getattr(jtab, k))[lv_in])
           for k in ("pos", "opa", "scale")}
    print(f"  inputs (live rows before the event): |grad| rel "
          f"{rel(np.array(tgrad)[lv_in], np.array(jgrad)[lv_in]):.2e}; "
          + "; ".join(f"{k} rel {v:.2e}" for k, v in gap.items()))
    jm_, jg = decisions(jtab, jgrad, jt.tcfg, jt.splat.cfg)
    tm_, tg = decisions(ttab, tgrad, tt.tcfg, tt.splat.cfg)
    for k in jm_:
        diff = torch.nonzero(jm_[k] != tm_[k]).flatten()
        ratio = [f"{float(jg[i]) / jt.tcfg.grad_thresh:.4f}/"
                 f"{float(tg[i]) / jt.tcfg.grad_thresh:.4f}"
                 for i in diff[:6]]
        print(f"  decision {k}: {int(jm_[k].sum())} jax, {int(tm_[k].sum())} "
              f"port, {len(diff)} slots differ" + (
                  f" (|grad| / grad_thresh jax/port: {', '.join(ratio)})"
                  if len(diff) else ""))
    live = tl
    for k in jt.state.params:
        d = rel(tt.state.params[k].numpy()[live],
                np.asarray(jt.state.params[k])[live])
        print(f"  params {k}: rel {d:.2e} slot by slot (a decision that "
              f"differs shifts every compacted row after it)")

    # each test view right after the event, with JAX's budget as it stands
    # and lifted
    cams, tcams = jt.splat.cameras, tt.splat.cameras
    grid, cfg = cams.grid, jt.splat.cfg
    lifted = dataclasses.replace(cfg, pair_capacity=NO_BUDGET)
    specs = {"budget": jt.splat.specs(grid),
             "lifted": j_make_specs(grid, jt.splat.table.capacity, lifted,
                                    jt.splat.color_dim)}
    tb, tr_ = tt.splat.specs(tcams.grid)
    print(f"\ntest views after the event (PSNR jax budget / jax lifted / "
          f"port; JAX's dropped pairs; max |port - jax| per route)")
    for c in tt.test_split:
        c = int(c)
        gt = np.asarray(cams.images[c], np.float32) / 255.0
        with torch.no_grad():
            timg, _ = render_cropped(
                tt.state.params, tt.state.live, tcams.w2c_rot[c],
                tcams.w2c_tran[c], tcams.grid, tt.splat.cfg, tb, tr_,
                tcams.sh_vecs[c])
        timg = timg.numpy()
        row = [f"view {c:2d}:"]
        out = {}
        for name, (bspec, rspec) in specs.items():
            img, aux = j_render(jt.state.params, jt.state.live,
                                cams.w2c_rot[c], cams.w2c_tran[c],
                                cams.sh_vecs[c], grid,
                                lifted if name == "lifted" else cfg,
                                bspec, rspec)
            img = np.asarray(img)
            out[name] = (img, int(aux["n_dropped"]))
        for img in [out["budget"][0], out["lifted"][0], timg]:
            mse = float(np.mean((img - gt) ** 2))
            row.append(f"{10 * np.log10(1 / mse):.4f}")
        row.append(f"dropped {out['budget'][1]} / {out['lifted'][1]};")
        row.append(f"max diff {np.abs(timg - out['budget'][0]).max():.2e} / "
                   f"{np.abs(timg - out['lifted'][0]).max():.2e}")
        print("  " + " ".join(row), flush=True)


if __name__ == "__main__":
    main()
