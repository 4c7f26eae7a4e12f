"""Traffic of kind ``train_episodes``: ``Trainer.train`` in episodes.

Each episode is a new Trainer over a copy of the set-up table and
configuration, trained over iterations [start, end) in windows of at most
``metrics_every`` steps ending at host events (the accumulator clears and
the densify events of that span).  Episodes repeat until the window's
deadline; the window ends at the first window log after it.

Set-up draws the table, renders the ground truth with the reference (its
seconds are the reference's and are left out of ``setup_s``), runs one
whole episode (every kernel and shape the window meets, the densify
event observed for the check), then drives the Trainer that the window
continues through its first ``check_steps`` iterations, one
``Trainer.train`` call each, for the check.  After the window the
reference follows those steps from the same table and cameras, and judges
the densify event on the observed state.
"""

from __future__ import annotations

import re
import time

import numpy as np
import torch

from splatbench import check, port, scene, tracing
from splatbench import reference as ref

_ITER = re.compile(r"iter (\d+):")


class WindowClosed(Exception):
    pass


def train_split(n_cams: int) -> np.ndarray:
    """The Trainer's training cameras: all but every 8th."""
    return np.array([i for i in range(n_cams) if i % 8])


def camera_draws(seed: int, n_cams: int, steps: int) -> list:
    """The cameras of a Trainer's first ``steps`` iterations, as
    ``TrainConfig.seed`` sets them: numpy ``default_rng(seed).choice`` over
    the training cameras, one a step."""
    split = train_split(n_cams)
    rng = np.random.default_rng(seed)
    return [int(rng.choice(split)) for _ in range(steps)]


def trainer_seed(seed: int, n_cams: int, steps: int):
    """The Trainer's seed: the run's seed, or the next one whose first
    ``steps`` camera draws all differ → (seed, draws)."""
    s = seed
    while True:
        draws = camera_draws(s, n_cams, steps)
        if len(set(draws)) == steps:
            return s, draws
        s += 1


def _quiet(_msg):
    pass


class Cell:
    """One run's scene and what set-up learned for the check."""

    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.table = scene.draw_table(config, seed, device)
        self.cams = scene.ring(config)
        tracing.sync(device)
        t0 = time.perf_counter()
        self.gt = scene.ground_truth(self.table, config, seed, self.cams)
        tracing.sync(device)
        self.gt_s = time.perf_counter() - t0
        self.cameras = port.scene_cameras(config, self.cams, self.gt, device)
        self.tseed, self.draws = trainer_seed(seed, config["n_cameras"],
                                              traffic["check_steps"])
        self.grid = scene.grid_of(config)
        self.event = {}

    def episode(self):
        return port.trainer(self.config, self.table, self.cameras,
                            self.tseed)

    def warm_up(self, end=None):
        """One episode, whole or to ``end``; the state before and after the
        densify event at ``check_event`` is kept on the host."""
        tr = self.traffic
        w = self.episode()

        def before(t, args):
            if args[0] == tr["check_event"]:
                self.event["pre"] = {k: v.cpu() for k, v in
                                     port.state_arrays(t).items()}

        def after(t, args, _out):
            tbl = t.splat.table
            self.event.setdefault("n_live", {})[args[0]] = int(tbl.n_live)
            if args[0] == tr["check_event"]:
                self.event["post"] = {k: getattr(tbl, k).cpu()
                                      for k in port.PARAMS + ("live",)}

        port.observe(w, "_densify", before, after)
        w.train(n_iters=end or tr["end"], metrics_every=tr["metrics_every"],
                log=_quiet, start=tr["start"])
        if "pre" not in self.event or "post" not in self.event:
            raise RuntimeError(
                f"splatbench: Trainer._densify was not called at iteration "
                f"{tr['check_event']}; the densify check observes the state "
                "before and after it there (PERF.md, Open questions)")

    def checked_steps(self):
        """The window's Trainer (kept as ``self.first``) through its first
        steps → the program's numbers: losses, the first gradient's and the
        change's norms."""
        tr = self.traffic
        t = self.episode()
        b1 = t.tcfg.adam_b1
        losses, g1 = [], None
        for i in range(tr["check_steps"]):
            it = tr["start"] + i
            t.train(n_iters=it + 1, metrics_every=tr["metrics_every"],
                    log=_quiet, start=it)
            losses.append(port.loss_of_last_step(t))
            if i == 0:
                g1 = check.norms({k: v / (1 - b1) for k, v in
                                  port.first_moment(t).items()})
        p = port.params(t)
        delta = check.norms({k: p[k] - self.table[k] for k in p})
        self.first = t
        return {"losses": losses, "grad": g1, "delta": delta}

    def reference_numbers(self, precision="f32", fault=None):
        """The reference over the same first steps → its numbers."""
        tr, cfg = self.traffic, self.config
        params = {k: self.table[k] for k in port.PARAMS}
        views = [(self.cams[c][0], self.cams[c][1], self.gt[c])
                 for c in self.draws]
        losses, g1, p = ref.follow(params, self.table["live"], views,
                                   tr["start"], self.grid,
                                   scene.scene_consts(cfg), cfg["train"],
                                   precision, fault)
        return {"losses": losses, "grad": check.norms(g1),
                "delta": check.norms({k: p[k] - params[k] for k in p})}

    def densify_values(self) -> dict:
        """The densify event against the reference's rule on the state the
        program had → exact gaps."""
        dev = self.device
        pre = {k: v.to(dev) for k, v in self.event["pre"].items()}
        post = {k: v.to(dev) for k, v in self.event["post"].items()}
        rule = ref.densify_rule(pre, self.config["train"])
        keep, split = rule["keep"], rule["split"]
        wanted = int(keep.sum() + rule["clone"].sum() + split.sum())
        rank = (torch.cumsum(keep, 0) - 1)[keep]
        whole = ~split[keep]
        gap = 0.0
        for k in ("rgb", "opa", "quat"):
            gap = max(gap, float((post[k][rank] - pre[k][keep]).abs().max()))
        scale = torch.where(split[:, None], ref.div_rn(pre["scale"], 1.6),
                            pre["scale"])
        gap = max(gap, float((post["scale"][rank] - scale[keep]).abs().max()))
        gap = max(gap, float((post["pos"][rank][whole]
                              - pre["pos"][keep][whole]).abs().max()))
        n_live = self.event["n_live"][self.traffic["check_event"]]
        return {"densify_live_gap": float(abs(n_live - wanted)),
                "densify_kept_gap": gap}


def left_out(refn: dict) -> list:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's: Adam moves them by round-off alone."""
    med = float(np.median(list(refn["grad"].values())))
    return [k for k, v in refn["grad"].items() if v < 1e-3 * med]


def compare(prog: dict, refn: dict) -> dict:
    """The numbers compared: each step's loss, the first gradient's norm
    and the change's norm after the steps, by the worst leaf."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in
                   zip(prog["losses"], refn["losses"]))
    grad_gap, _ = check.worst_leaf(prog["grad"], refn["grad"])
    delta_gap, _ = check.worst_leaf(prog["delta"], refn["delta"],
                                    left_out(refn))
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": delta_gap}


def _window(cell: Cell, seconds: float):
    """Episodes until the deadline, the first continuing ``cell.first`` →
    (iterations, window seconds, windows [(steps, seconds, ends at an
    event)], iterations of windows whose loss was not finite)."""
    tr = cell.traffic
    logs = []
    deadline = [None]

    def make_log(episode):
        def log(msg):
            now = time.perf_counter()
            logs.append((now, int(_ITER.match(msg).group(1)), episode,
                         "nan" in msg or "inf" in msg))
            if now >= deadline[0]:
                raise WindowClosed
        return log

    calls = []
    t0 = time.perf_counter()
    deadline[0] = t0 + seconds
    trainer_obj, cell.first = cell.first, None
    start, episode = tr["start"] + tr["check_steps"], 0
    try:
        while True:
            calls.append((time.perf_counter(), start - 1, episode))
            trainer_obj.train(n_iters=tr["end"],
                              metrics_every=tr["metrics_every"],
                              log=make_log(episode),
                              start=start)
            del trainer_obj
            episode += 1
            trainer_obj, start = cell.episode(), tr["start"]
    except WindowClosed:
        pass
    seconds_w = logs[-1][0] - t0
    marks = {ep: (t, j) for t, j, ep in calls}
    windows, iters, failed = [], 0, 0
    for t, j, ep, bad in logs:
        t_prev, j_prev = marks[ep]
        windows.append((j - j_prev, t - t_prev, j in tr["events"]))
        iters += j - j_prev
        failed += (j - j_prev) if bad else 0
        marks[ep] = (t, j)
    return iters, seconds_w, windows, failed


def step_inputs(cell: Cell, lo: int, hi: int):
    """What iterations ``lo`` … ``hi`` − 1 of an episode work on, one step
    at a time: the parameters, live mask, tile cap and live count before
    the step, read from a like episode trained one ``Trainer.train`` call an
    iteration, and the step's camera, the Trainer's seeded draws replayed."""
    tr = cell.traffic
    d = cell.episode()
    d.train(n_iters=lo, metrics_every=tr["metrics_every"], log=_quiet,
            start=tr["start"])
    cams = camera_draws(cell.tseed, cell.config["n_cameras"],
                        hi - tr["start"])[lo - tr["start"]:]
    for i, cam in zip(range(lo, hi), cams):
        yield (port.params(d), port.live(d), port.tiles_cap(d),
               port.n_live(d), cam)
        d.train(n_iters=i + 1, metrics_every=tr["metrics_every"],
                log=_quiet, start=i)


def _traced(cell: Cell, device) -> dict:
    """Three like episodes to the traced span's start: one trains the span
    untraced and synchronised, one under the profiler with the device's
    activity alone, one under the profiler with the host's too, which
    names the idle gaps.  A fourth, stepped an iteration a call, gives the
    steps' inputs to the count (:func:`step_inputs`)."""
    tr = cell.traffic
    lo, hi = tr["traced"]
    a, b, c = cell.episode(), cell.episode(), cell.episode()
    for t in (a, b, c):
        t.train(n_iters=lo, metrics_every=tr["metrics_every"], log=_quiet,
                start=tr["start"])
    tracing.sync(device)
    t0 = time.perf_counter()
    a.train(n_iters=hi, metrics_every=tr["metrics_every"], log=_quiet,
            start=lo)
    tracing.sync(device)
    untraced = time.perf_counter() - t0
    del a

    def span(t):
        return lambda: t.train(n_iters=hi, metrics_every=tr["metrics_every"],
                               log=_quiet, start=lo)

    prof = tracing.profile(span(b), span(c), device)
    del b, c
    counted = []
    cfg, grid = cell.config, cell.grid
    colour = 27 if cfg["splat"]["use_sh_coeff"] else 3
    for params, live, k_max, n_live, cam in step_inputs(cell, lo, hi):
        rot, tran = cell.cams[cam]
        n = ref.count_evaluations(params, live, rot, tran, grid,
                                  scene.scene_consts(cfg, k_max))
        counted.append(dict(n, colour=colour, n_live=n_live,
                            pixels=cfg["width"] * cfg["height"],
                            n_pix=grid.padded_w * grid.padded_h,
                            n_tiles=grid.n_tiles))
    return {"kind": "train", "untraced_s": untraced, "steps": counted,
            **prof}


def run(config, traffic, seed, seconds, trace, device, clock0) -> dict:
    """One run of a train cell → the harness's result parts."""
    marks = [time.perf_counter()]
    cell = Cell(config, traffic, seed, device)
    marks.append(time.perf_counter())
    cell.warm_up()
    marks.append(time.perf_counter())
    prog = cell.checked_steps()
    tracing.sync(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - clock0 - cell.gt_s
    tracing.reset_peak(device)
    iters, window_s, windows, failed = _window(cell, seconds)
    peak = tracing.peak_bytes(device)
    ctx = {"windows": windows}
    if trace:
        ctx["trace"] = _traced(cell, device)
    tracing.free(device)
    refn = cell.reference_numbers()
    values = compare(prog, refn)
    values.update(cell.densify_values())
    return {"e2e": {"train_it_per_s": iters / window_s, "setup_s": setup_s},
            "attempted": iters, "failed": failed, "memory_peak_bytes": peak,
            "values": values, "ctx": ctx,
            "notes": {"n_live_after_events": cell.event.get("n_live"),
                      "leaves_left_out": left_out(refn),
                      "setup": {"start_s": marks[0] - clock0,
                                "data_s": marks[1] - marks[0] - cell.gt_s,
                                "gt_s": cell.gt_s,
                                "warm_up_s": marks[2] - marks[1],
                                "build_s": port.build_seconds(),
                                "check_steps_s": marks[3] - marks[2]}}}
