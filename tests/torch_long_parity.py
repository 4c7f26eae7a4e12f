"""The port's Trainer against the JAX package's over a long horizon, on the
CPU: iterations 0 … N − 1 of the at-scale run's configuration (the
reference's fast config, ``gsplat_tpu_torch/scripts/run_garden_7k.py``, on
its 7001-iteration schedule) on a ``garden_hard``-kind scene, every densify
event included.

Six trainers take the same camera draws (one numpy generator each, same
seed) and the same split noise (JAX's keys, fed to the port):

- ``jax_f32``: the JAX package on its dense plane, f32 throughout (the
  configuration the parity tests hold the port to);
- ``jax_f32_twin``: ``jax_f32`` with every initial position moved by one
  ulp (``np.nextafter``).  Its distance from ``jax_f32`` is the noise floor
  of the chaotic trajectory; the port is judged against that floor;
- ``jax_default``: the JAX package with its default layout (``colcap`` with
  ``bf16_pack`` and ``quant_depth`` on), the configuration of its own
  at-scale run ``runs/7k_hard_r5``;
- ``jax_f32_nobudget``: ``jax_f32`` with its pair budget (the TPU's static
  slot capacity, ``SplatConfig.pair_capacity``, which JAX retunes at densify
  events and, in ``Trainer.train``, after an overflow) set at the start and
  after every densify event to twice the heaviest train view's pairs plus a
  chunk a tile, and never retuned down, so that no pair is dropped: the
  port's semantics, which has no budgets (the records list every step or
  window that still dropped one);
- ``jax_f32_nobudget_twin``: ``jax_f32_nobudget`` with the one-ulp move of
  ``jax_f32_twin``, the noise floor of the budget-free route;
- ``port``: ``gsplat_tpu_torch`` on the CPU (the plain compositor).

``--drive step`` calls ``train_step(i)`` for every iteration; ``--drive
train`` calls each package's own ``Trainer.train(n_iters,
metrics_every=50)``, as ``run_garden_7k`` does, so the JAX trainers run
``window_scan`` and feed their K guard the window max of the binning
counters.  The trainers do not interact, so each runs in a process of its
own (one thread each) and writes its records as JSON lines; the parent then
tables, at every densify event, each trainer's live gaussians, capacity, K,
clones, splits and deletions, the counters its K guard read and its
test-split PSNR after the event, and applies the decision rule of PERF.md:
the port agrees with ``jax_f32`` if, at every event, its live count is
within max(3%, 2 × |twin − jax_f32|) of ``jax_f32``'s and its test PSNR
within max(0.3 dB, 2 × the twin's gap).  The same rule is applied against
``jax_f32_nobudget``, with the gaps of its own twin.

Scenes (``SCENES``): ``tiny`` (3,000 GT gaussians, 9 views at 64x48, an
8,192-slot ceiling it fills at 1100) and ``mid`` (14,000 GT gaussians, 24
views at 128x96, a 32,768-slot ceiling: garden_hard's GT:init ratio and
GT gaussians a pixel).  ``mid`` departs from the reference flags in two
places, each to reach the at-scale regime: 8x8 tiles (16x12 of them, so a
large splat covers the 24-40 tiles that grow K as at 1297x840), and
``grad_thresh`` 8e-5 in place of 2e-6 (with 86x fewer gaussians than
garden_hard each one's accumulated gradient is far larger, and 2e-6
splits every gaussian at every event; 8e-5 densifies about garden_hard's
38% at the first event).  For ``mid`` the harness checks its own regime and
exits 1 if a check fails: every trainer's live count stays below 0.88 × the
ceiling through the run, ``jax_f32``'s still grows after iteration 1000,
and ``jax_f32``'s K reaches 24.  Not a pytest test (a JAX trainer takes
~3 h on one core for 3001 iterations); its outputs are
``runs/torch_long_parity_mid/{train,step}.log``:

    python tests/torch_long_parity.py --size mid --drive train \\
        --n_iters 3001 --out runs/torch_long_parity_mid/train

``--out`` keeps each trainer's records (``{name}.jsonl``); a trainer whose
records reached the end is not run again unless ``--fresh`` names it.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

TRAINERS = ("jax_f32", "jax_f32_twin", "jax_default", "jax_f32_nobudget",
            "jax_f32_nobudget_twin", "port")
# each reference of the decision rule and the twin that gives its noise floor
RULES = (("jax_f32", "jax_f32_twin"),
         ("jax_f32_nobudget", "jax_f32_nobudget_twin"))
GRAD_THRESH_MID = 8e-5
SCENES = {
    # tests/test_torch_scene_tools.py's scene
    "tiny": dict(scene=dict(n_gt=3000, n_points=400, n_cams=9, w=64, h=48,
                            focal=60.0, capacity_round=1024, scale_px=1.6,
                            opa=0.6, orbit=True, use_sh=True, sh_ampl=0.35,
                            noise_std=2.0),
                 ceiling=8192, skw={}, tkw={}),
    # garden_hard (1.2M GT, 140k init, 1297x840, focal 1000) at 128x96:
    # GT:init 8.6 and ~1.1 GT gaussians a pixel, as there
    "mid": dict(scene=dict(n_gt=14_000, n_points=1630, n_cams=24, w=128,
                           h=96, focal=100.0, capacity_round=1024,
                           scale_px=1.6, opa=0.6, orbit=True, use_sh=True,
                           sh_ampl=0.35, noise_std=2.0),
                ceiling=32_768, skw=dict(tile_h=8, tile_w=8),
                tkw=dict(grad_thresh=GRAD_THRESH_MID)),
}
# the at-scale run's trainer flags (run_garden_7k.REFERENCE_FLAGS), on its
# 7001-iteration learning-rate schedule
TKW = dict(grad_thresh=2e-6, ssim_weight=0.1, lr=0.002,
           grad_accum_method="mean", grad_accum_iters=300, split_thresh=0.08,
           n_save_train_img=0, n_iters=7001)
MAX_TILES_CAP = 40
METRICS_EVERY = 50                      # run_garden_7k's --metrics_every
GUARD = ("n_clipped", "n_pairs", "n_max_tiles")
ITER_RE = re.compile(r"iter (\d+): l1=([\d.]+) psnr=([\d.]+) pairs=(\d+)")
TEST_RE = re.compile(r"TEST @(\d+): psnr=([\d.]+) ssim=([\d.]+)")


# ---------------------------------------------------------------------------
# one trainer (a child process)
# ---------------------------------------------------------------------------

def feed_jax_noise(tr, seed):
    """Make the port's trainer draw JAX's split noise (as
    tests/test_torch_trainer.py does)."""
    import jax
    import numpy as np
    import torch

    keys = [jax.random.PRNGKey(seed), None]
    densify = tr._densify

    def wrapped(i, ac, in_reset):
        keys[0], keys[1] = jax.random.split(keys[0])
        densify(i, ac, in_reset)

    tr._densify = wrapped
    tr._split_noise = lambda cap: torch.from_numpy(
        np.array(jax.random.normal(keys[1], (cap, 2, 3))))


def make_trainer(name, paths, size):
    """→ (trainer, a function giving the latest event's (n_cloned, n_split,
    n_deleted))."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    sz = SCENES[size]
    skw = dict(capacity_round=sz["scene"]["capacity_round"],
               max_tiles_cap=MAX_TILES_CAP, max_capacity=sz["ceiling"],
               **sz["skw"])
    tkw = dict(TKW, **sz["tkw"])
    if name == "port":
        from gsplat_tpu_torch.config import SplatConfig, TrainConfig
        from gsplat_tpu_torch.models.splatter import Splatter
        from gsplat_tpu_torch.train import Trainer

        tr = Trainer(Splatter(*paths, SplatConfig(**skw), device="cpu"),
                     TrainConfig(**tkw))
        feed_jax_noise(tr, TrainConfig().seed)

        def stats():
            s = tr.last_densify
            return int(s.n_cloned), int(s.n_split), int(s.n_deleted)
        return tr, stats

    import gsplat_tpu.train as jtrain
    from gsplat_tpu.config import SplatConfig as JCfg
    from gsplat_tpu.config import TrainConfig as JTCfg
    from gsplat_tpu.models.splatter import Splatter as JSplatter

    if name == "jax_default":
        cfg = JCfg(use_pallas=False, **skw)
    else:
        cfg = JCfg(plane_mode="dense", use_pallas=False, **skw)
    splat = JSplatter(*paths, cfg)
    if name.endswith("_twin"):
        pos = np.asarray(splat.table.pos)
        splat.table = splat.table._replace(pos=jnp.asarray(
            np.nextafter(pos, np.float32(np.inf))))
    # JAX's _densify keeps its stats local: record the control's last call
    last = {}
    control = jtrain.adaptive_control

    def recorded(*args, **kw):
        out = control(*args, **kw)
        last["stats"] = out[1]
        return out

    jtrain.adaptive_control = recorded
    tr = jtrain.Trainer(splat, JTCfg(**tkw))
    if name.startswith("jax_f32_nobudget"):
        lift_budget(tr)

    def stats():
        s = last["stats"]
        return int(s.n_cloned), int(s.n_split), int(s.n_deleted)
    return tr, stats


def lift_budget(tr):
    """Keep a JAX trainer's pair budget above twice the heaviest train
    view's pairs plus a chunk a tile: now and after every densify event;
    its own retunes are switched off."""
    import jax.numpy as jnp

    from gsplat_tpu.ops.binning import _tile_bbox
    from gsplat_tpu.ops.projection import project_gaussians

    splat = tr.splat

    def provision():
        cams, cfg = splat.cameras, splat.cfg
        grid = cams.grid
        bspec, _ = splat.specs(grid)
        p, most = tr.state.params, 0
        for c in tr._group_train[0]:
            proj = project_gaussians(
                p["pos"], p["quat"], p["scale"], cams.w2c_rot[c],
                cams.w2c_tran[c], near=cfg.near,
                half_width=grid.width * 1.2 / 2 / grid.focal_x,
                half_height=grid.height * 1.2 / 2 / grid.focal_y,
                scale_activation=cfg.scale_activation)
            _, _, rw, rh = _tile_bbox(bspec, proj.mean2d, proj.cov2d,
                                      proj.visible & tr.state.live)
            most = max(most, int(jnp.minimum(
                rw * rh, cfg.max_tiles_per_gaussian).sum()))
        cfg.pair_capacity = 2 * most + bspec.n_tiles * cfg.chunk_size
        splat._specs_cache.clear()
        tr._rebuild_after_capacity_change()

    densify = tr._densify

    def provisioned(i, ac, in_reset):
        densify(i, ac, in_reset)
        provision()

    splat.retune_pair_capacity = lambda *a, **kw: False
    tr._densify = provisioned
    provision()


def run_one(name, drive, size, scene, n_iters, rec_path):
    """Train one trainer, writing its records to ``rec_path``."""
    import numpy as np
    import torch

    torch.set_num_threads(1)
    paths = (os.path.join(scene, "sparse", "0"),
             os.path.join(scene, "images_4"))
    tr, stats = make_trainer(name, paths, size)
    out = open(rec_path, "w")

    def emit(**rec):
        out.write(json.dumps(rec) + "\n")
        out.flush()

    def test_psnr():
        return float(np.mean([tr.test(int(c))["psnr"]
                              for c in tr.test_split]))

    densify = tr._densify

    def recorded(i, ac, in_reset):
        m = tr._last_metrics
        guard = {k: int(m[k]) for k in GUARD}
        k0 = tr.splat.cfg.max_tiles_per_gaussian
        densify(i, ac, in_reset)
        n_clone, n_split, n_del = stats()
        emit(kind="event", i=i, n_live=int(tr.splat.table.n_live),
             capacity=int(tr.splat.table.capacity), k_before=k0,
             k=tr.splat.cfg.max_tiles_per_gaussian, n_cloned=n_clone,
             n_split=n_split, n_deleted=n_del, guard=guard, psnr=test_psnr(),
             t=time.time())

    tr._densify = recorded
    if name != "port":
        # pairs a JAX trainer dropped to its slot budget, per step (step
        # drive) or window max (train drive)
        post = tr._post_step

        def post_step(i):
            dropped = int(tr._last_metrics.get("n_dropped", 0))
            if dropped:
                emit(kind="drop", i=i, n_dropped=dropped)
            post(i)

        tr._post_step = post_step
    t0 = time.time()
    emit(kind="start", name=name, drive=drive, size=size, n_iters=n_iters,
         n_live=int(tr.splat.table.n_live),
         capacity=int(tr.splat.table.capacity),
         k=tr.splat.cfg.max_tiles_per_gaussian, t=t0)
    if drive == "step":
        for i in range(n_iters):
            m = tr.train_step(i)
            if i % 100 == 0:
                emit(kind="iter", i=i, l1=float(m["l1"]),
                     n_pairs=int(m["n_pairs"]))
            if i % tr.tcfg.n_iters_test == 0 and i > 0:
                emit(kind="test", i=i, psnr=test_psnr())
    else:
        def log(line):
            mi, mt = ITER_RE.match(line), TEST_RE.match(line)
            if mi:
                emit(kind="iter", i=int(mi[1]), l1=float(mi[2]),
                     n_pairs=int(mi[4]))
            elif mt:
                emit(kind="test", i=int(mt[1]), psnr=float(mt[2]))
            else:
                emit(kind="log", line=line)
        tr.train(n_iters, metrics_every=METRICS_EVERY, log=log)
    emit(kind="done", seconds=time.time() - t0)
    out.close()


# ---------------------------------------------------------------------------
# the parent: build the scene, run the trainers, table them
# ---------------------------------------------------------------------------

def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def finished(path):
    return os.path.exists(path) and any(r["kind"] == "done"
                                        for r in load(path))


def table(recs, size, n_iters):
    """Print the event table, the decision rule's verdict and (``mid``) the
    regime checks → the number of failed regime checks."""
    names = [n for n in TRAINERS if n in recs]
    ev = {n: {r["i"]: r for r in recs[n] if r["kind"] == "event"}
          for n in names}
    events = sorted(set().union(*[set(e) for e in ev.values()]))
    for n in names:
        s = recs[n][0]
        done = [r for r in recs[n] if r["kind"] == "done"]
        print(f"# {n}: start n_live={s['n_live']} capacity={s['capacity']} "
              f"K={s['k']}; " + (f"{done[0]['seconds']:.0f} s"
                                 if done else "did not finish"))
    print("\nevent  trainer            n_live capacity   K  cloned  split "
          "deleted | K guard: n_clipped  n_pairs max_tiles (K before) "
          "| test PSNR")
    for i in events:
        for n in names:
            e = ev[n].get(i)
            if e is None:
                continue
            g = e["guard"]
            print(f"{i:5d}  {n:16s} {e['n_live']:8d} {e['capacity']:8d} "
                  f"{e['k']:3d} {e['n_cloned']:7d} {e['n_split']:6d} "
                  f"{e['n_deleted']:7d} | {g['n_clipped']:17d} "
                  f"{g['n_pairs']:8d} {g['n_max_tiles']:9d} "
                  f"({e['k_before']:2d})     | {e['psnr']:.4f}")
    print("\niter   " + "  ".join(f"{n:>22s}" for n in names)
          + "   (l1, n_pairs; TEST: test PSNR)")
    iters = sorted({r["i"] for n in names for r in recs[n]
                    if r["kind"] == "iter" and (r["i"] % 100 in (0, 99))})
    for i in iters:
        row = {n: next((r for r in recs[n] if r["kind"] == "iter"
                        and r["i"] == i), None) for n in names}
        print(f"{i:5d}  " + "  ".join(
            f"{r['l1']:.6f} {r['n_pairs']:8d}" if r else f"{'':>15s}"
            for n, r in row.items()))
    tests = sorted({r["i"] for n in names for r in recs[n]
                    if r["kind"] == "test"})
    for i in tests:
        print(f"TEST @{i}: " + "  ".join(
            f"{n} {r['psnr']:.4f}" for n in names for r in recs[n]
            if r["kind"] == "test" and r["i"] == i))
    for n in names:
        for r in recs[n]:
            if r["kind"] == "log":
                print(f"[{n}] {r['line']}")
        drops = [r for r in recs[n] if r["kind"] == "drop"]
        if drops:
            print(f"[{n}] pairs dropped to its slot budget in {len(drops)} "
                  f"steps or windows, {drops[0]['i']}-{drops[-1]['i']}, at "
                  f"most {max(r['n_dropped'] for r in drops)}")

    # the decision rule (PERF.md §6), at every event all three reached
    for ref_name, twin in RULES:
        rule = [n for n in (ref_name, twin, "port") if n in names]
        if len(rule) < 3:
            continue
        print(f"\nrule: port vs {ref_name} within max(3%, 2|{twin} - "
              f"{ref_name}|) live, max(0.3 dB, 2 x the same gap) test PSNR")
        print("event   twin dn   port dn   bound  | twin dPSNR port dPSNR "
              " bound | verdict")
        first_part, parts = None, []
        for i in events:
            if not all(i in ev[n] for n in rule):
                continue
            ref, tw, po = (ev[n][i] for n in rule)
            dn_t = abs(tw["n_live"] - ref["n_live"])
            dn_p = abs(po["n_live"] - ref["n_live"])
            bound_n = max(0.03 * ref["n_live"], 2 * dn_t)
            dp_t = abs(tw["psnr"] - ref["psnr"])
            dp_p = abs(po["psnr"] - ref["psnr"])
            bound_p = max(0.3, 2 * dp_t)
            ok = dn_p <= bound_n and dp_p <= bound_p
            if not ok:
                parts.append(i)
                first_part = i if first_part is None else first_part
            print(f"{i:5d} {dn_t:9d} {dn_p:9d} {bound_n:9.1f} | "
                  f"{dp_t:10.4f} {dp_p:10.4f} {bound_p:6.3f} | "
                  f"{'agrees' if ok else 'PARTS'}")
        print(f"verdict: the port agrees with {ref_name} at every event"
              if first_part is None else
              f"verdict: the port parts from {ref_name} at {first_part} "
              f"(events {parts})")

    failed = 0
    if size == "mid":
        ceiling = SCENES[size]["ceiling"]
        checks = []
        for n in names:
            top = max((e["n_live"] for e in ev[n].values()), default=0)
            checks.append((f"{n}: live <= {top} < 0.88 x {ceiling}",
                           top < 0.88 * ceiling))
        if "jax_f32" in names:
            e = ev["jax_f32"]
            after = [i for i in e if i > 1000]
            grows = bool(after) and 1000 in e and \
                e[max(after)]["n_live"] > e[1000]["n_live"]
            checks.append(("jax_f32's live count grows after 1000 ("
                           + (f"{e[1000]['n_live']} -> "
                              f"{e[max(after)]['n_live']}" if grows else
                              "no") + ")", grows))
            kmax = max((r["k"] for r in e.values()), default=0)
            checks.append((f"jax_f32's K reaches 24 (max {kmax})",
                           kmax >= 24))
        print("\nregime checks:")
        for what, ok in checks:
            print(f"  {'ok  ' if ok else 'FAIL'} {what}")
            failed += not ok
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n_iters", type=int, default=1001,
                    help="iterations run (the schedule stays 7001's)")
    ap.add_argument("--drive", choices=("step", "train"), default="step")
    ap.add_argument("--size", choices=sorted(SCENES), default="mid")
    ap.add_argument("--scene", default="", help="scene directory (built "
                    "from --size when it has no sparse/0)")
    ap.add_argument("--out", default="", help="records directory")
    ap.add_argument("--trainers", default=",".join(TRAINERS))
    ap.add_argument("--fresh", default="",
                    help="trainers to run again even if their records ended")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    scene = a.scene or os.path.join(tempfile.mkdtemp(), "scene")
    out = a.out or tempfile.mkdtemp()
    if a.child:
        run_one(a.child, a.drive, a.size, scene, a.n_iters,
                os.path.join(out, f"{a.child}.jsonl"))
        return 0
    if not os.path.exists(os.path.join(scene, "sparse", "0")):
        from gsplat_tpu_torch.scripts import make_synth_scene

        make_synth_scene.main(scene, device="cpu", log=lambda msg: None,
                              **SCENES[a.size]["scene"])
    os.makedirs(out, exist_ok=True)
    names = [n for n in a.trainers.split(",") if n]
    fresh = set(a.fresh.split(","))
    env = dict(os.environ, OMP_NUM_THREADS="1", XLA_FLAGS=(
        "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1"))
    procs = {}
    for n in names:
        path = os.path.join(out, f"{n}.jsonl")
        if n not in fresh and finished(path):
            print(f"# {n}: records kept from {path}")
            continue
        procs[n] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", n,
             "--drive", a.drive, "--size", a.size, "--scene", scene,
             "--out", out, "--n_iters", str(a.n_iters)],
            env=env, stdout=subprocess.DEVNULL,
            stderr=open(os.path.join(out, f"{n}.err"), "w"))
    bad = [n for n, p in procs.items() if p.wait() != 0]
    if bad:
        print(f"# trainers failed: {bad} (see {out}/*.err)")
    recs = {n: load(os.path.join(out, f"{n}.jsonl")) for n in names}
    print(f"# size={a.size} drive={a.drive} n_iters={a.n_iters} "
          f"(schedule {TKW['n_iters']}), metrics_every={METRICS_EVERY}")
    failed = table(recs, a.size, a.n_iters)
    return 1 if failed or bad else 0


if __name__ == "__main__":
    sys.exit(main())
