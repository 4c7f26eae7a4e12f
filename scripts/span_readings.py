"""The port's spans (``gsplat_tpu_torch/utils/timer.py``) read on a cell of
the benchmark: what each stage of the host's work costs, and which stage
the card waits on.

    python3 scripts/span_readings.py --workload <cell> --seed <n>
        [--pairs 2] [--device cuda] [--root .] [--out <file>]

Run from the root of a checkout.  The cell is built as
``splatbench/run.py`` builds it (``splatbench.harness.load_cell``; the
table from the seed, the reference's ground truth, the warm-up episode or
requests), then the cell's traced span (train: iterations 681-720 from
like Trainers trained to 681; render: the next 40 poses) runs

- untraced and synchronised, and with the spans on and the profiler off,
  in turns, ``--pairs`` times: the spans-on cost, the second time over the
  first less 1, and the records of the spans-on runs;
- under the profiler with the host's activity, as the benchmark's
  traced run names its idle gaps (``splatbench.tracing.read_events``: the
  innermost host event at each gap's middle, the spans among them), with
  the spans off, on, on and off: each gap named from every host thread's
  events, and as the benchmark names it, from the thread with the most
  events alone.

A render cell first serves requests for ``--window`` seconds, as the
benchmark's traced run follows its window.

Prints one JSON line (and writes it to ``--out``): the readings of each
spans-on run, per step or frame in ms,

- train: ``step_host_ms`` (each ``trainer.step`` less the ``sync.*``
  spans inside it: the host's time to issue a step), ``sync_wait_ms`` and
  ``syncs_per_step`` (every ``sync.*`` span's length and count over the
  steps), ``densify_host_ms`` (the ``trainer.densify`` spans' mean);
- render: ``sync_wait_ms`` (the ``sync.*`` spans per frame) and
  ``to_host_ms`` (``serve.to_host`` per frame);

with each span name's mean and self time (``timer.summary``), and both
profiles' ``idle_gaps``.  ``--device cpu`` with the tiny root of
``splatbench/conftest.make_root`` rehearses it without the profiles; its
times are the CPU's.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NO_OP = "host: no traced operation"


def _enclosing(rec, by_index, name: str):
    """The innermost span named ``name`` around ``rec``, or None."""
    while rec.parent is not None and rec.parent in by_index:
        rec = by_index[rec.parent]
        if rec.name == name:
            return rec
    return None


def readings(records, kind: str) -> dict:
    """The per-step (train) or per-frame (render) readings of one spans-on
    run's records (module docstring)."""
    from gsplat_tpu_torch.utils import timer

    by_index = {r.index: r for r in records}
    syncs = [r for r in records if r.name.startswith("sync.")]
    ms = 1e-6
    if kind == "train":
        steps = [r for r in records if r.name == "trainer.step"]
        n = len(steps)
        inside = {}
        for r in syncs:
            p = _enclosing(r, by_index, "trainer.step")
            if p is not None:
                inside[p.index] = inside.get(p.index, 0) + r.duration_ns
        dens = [r.duration_ns for r in records
                if r.name == "trainer.densify"]
        out = {"steps": n,
               "step_host_ms": sum(s.duration_ns - inside.get(s.index, 0)
                                   for s in steps) / n * ms,
               "sync_wait_ms": sum(r.duration_ns for r in syncs) / n * ms,
               "syncs_per_step": len(syncs) / n,
               "densify_host_ms": (sum(dens) / len(dens) * ms
                                   if dens else None)}
    else:
        frames = [r for r in records if r.name == "serve.request"]
        n = len(frames)
        out = {"frames": n,
               "sync_wait_ms": sum(r.duration_ns for r in syncs
                                   if _enclosing(r, by_index,
                                                 "serve.request")) / n * ms,
               "to_host_ms": sum(r.duration_ns for r in records
                                 if r.name == "serve.to_host") / n * ms}
    out["spans"] = timer.summary(records)
    return out


def no_op_share(idle_gaps) -> float:
    """The share of the listed idle time that no host event covers."""
    total = sum(s for _, s in idle_gaps)
    return sum(s for n, s in idle_gaps if n == NO_OP) / total if total \
        else 0.0


def _timed(fn, device) -> float:
    from splatbench import tracing

    tracing.sync(device)
    t0 = time.perf_counter()
    fn()
    tracing.sync(device)
    return time.perf_counter() - t0


def _spans_on(fn):
    """``fn`` to be run with the spans on."""
    from gsplat_tpu_torch.utils import timer

    def run():
        timer.enable(True)
        try:
            fn()
        finally:
            timer.enable(False)
    return run


def _host_trace(fn, device):
    """``fn()`` under the profiler with the host's and the device's
    activity → (device rows, {thread: host rows}, the window's seconds):
    ``splatbench.tracing``'s rows, every host thread's kept (on the card
    the autograd engine runs the backward in a thread of its own)."""
    from collections import defaultdict

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev, host = [], defaultdict(list)
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            dev.append(row)
        else:
            host[e.thread].append(row)
    return dev, host, window


def measure(runs, device, pairs: int, kind: str) -> dict:
    """``runs()`` → a fresh callable of the traced span each call."""
    from gsplat_tpu_torch.utils import timer
    from splatbench import tracing

    timer.take()
    base, on, reads = [], [], []
    for k in range(pairs):      # in turns: off, on, on, off, ...
        for spans in ((False, True) if k % 2 == 0 else (True, False)):
            if spans:
                on.append(_timed(_spans_on(runs()), device))
                reads.append(readings(timer.take(), kind))
            else:
                base.append(_timed(runs(), device))
    cost = [b / a - 1 for a, b in zip(base, on)]
    profiles = {}       # the profiler's device rows need the card
    order = ((False, "spans_off"), (True, "spans_on"), (True, "spans_on"),
             (False, "spans_off")) if device.type == "cuda" else ()
    for spans, label in order:
        fn = runs()
        dev, host, window = _host_trace(_spans_on(fn) if spans else fn,
                                        device)
        # each span is also a device-side range over the kernels it
        # launched (the profiler's user annotations): not device work
        names = {r.name for r in timer.take()}
        dev = [r for r in dev if r[2] not in names]
        busiest = max(host, key=lambda t: len(host[t]))
        merged = tracing.read_events(dev, [r for rows in host.values()
                                           for r in rows])
        as_bench = tracing.read_events(dev, host[busiest])
        profiles.setdefault(label, []).append({
            "idle_gaps": merged["idle_gaps"],
            "no_op_share": no_op_share(merged["idle_gaps"]),
            "idle_gaps_busiest_thread": as_bench["idle_gaps"],
            "no_op_share_busiest_thread": no_op_share(as_bench["idle_gaps"]),
            "host_events_by_thread": sorted(len(v) for v in host.values()),
            "busy_s": merged["busy_s"], "window_s": window})
    return {"untraced_s": base, "spans_on_s": on, "cost": cost,
            "cost_median": statistics.median(cost), "readings": reads,
            "profiles": profiles}


def train_runs(cell, device):
    """A callable that makes each time a like Trainer trained to the
    traced span's start and returns its run of the span."""
    from splatbench import tracing
    from splatbench.train_cell import _quiet

    tr = cell.traffic
    lo, hi = tr["traced"]

    def runs():
        t = cell.episode()
        t.train(n_iters=lo, metrics_every=tr["metrics_every"], log=_quiet,
                start=tr["start"])
        tracing.sync(device)
        return lambda: t.train(n_iters=hi, metrics_every=tr["metrics_every"],
                               log=_quiet, start=lo)
    return runs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's spans on a cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--window", type=float, default=20.0,
                    help="render cells: seconds of requests before the "
                    "traced poses, as the benchmark's window")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    root = Path(args.root)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(ROOT / ".splatbench_cache" / sub))
    sys.path.insert(0, str(ROOT))
    import torch

    from splatbench import harness, render_cell, train_cell

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("span_readings: no CUDA device", file=sys.stderr)
            return 2
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
        card = harness.power_limit()
    else:
        card = "cpu"
    _, config, traffic = harness.load_cell(harness.load_benchmark(root),
                                           args.workload, root)
    if traffic["kind"] == "train_episodes":
        cell = train_cell.Cell(config, traffic, args.seed, device)
        cell.warm_up()
        out = measure(train_runs(cell, device), device, args.pairs, "train")
    else:
        cell = render_cell.Cell(config, traffic, args.seed, device)
        for _ in range(traffic["warmup_requests"]):
            cell.request(cell.next_pose())
        # the benchmark traces after its window: the host's allocator then
        # serves each frame's copy as it does in the window
        render_cell._window(cell, args.window)
        poses = [cell.next_pose()
                 for _ in range(traffic["traced_requests"])]

        def frames():
            for w2c in poses:
                cell.request(w2c)

        def runs():
            return frames
        out = measure(runs, device, args.pairs, "render")
    line = json.dumps(dict(workload=args.workload, seed=args.seed,
                           device=card, **out))
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
