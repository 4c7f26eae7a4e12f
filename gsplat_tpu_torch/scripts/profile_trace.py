"""Where a render frame or a train step of the port spends its device time.

    python -m gsplat_tpu_torch.scripts.profile_trace [render|train]
        [n_gaussians] [sh|preset] [--device cuda|cpu]

The counterpart of the JAX package's ``scripts/profile_trace.py`` (same
positional arguments): it builds the bench scene (``bench.build_scene``:
the synthetic table in front of 8 cameras at 1297x840, their images
random as in JAX's script), takes a
``torch.profiler`` trace of 3 frames or 3 train steps of view 0 after a
warm-up, and prints the device time by category and the top single ops.

``trace_and_attribute(fn)`` does the attribution for any callable.  It lays
the traced operations on one timeline, from the first one's start to the
last one's end (the window), and gives every instant to the innermost
operation running then: on the card the CUDA kernels, copies and memsets
(one stream: they do not overlap; the CPU activity is not recorded, so the
profiler adds little to the host's gaps), on the CPU the ``aten`` ops of the
calling thread (nested: an op's own time, without its children's).  An
instant that no operation covers is a gap: on the card the host between
two launches.  So the categories and the gaps sum to the window.  Tracing
slows the host (on the card 1.1-1.6x a train step's window against the
same calls untraced), so ``report`` also prints the idle time without it:
the untraced time less the busy time.  The
categories (``category``):

- ``sort/search/scan``: radix sorts, ``searchsorted``, cumulative sums;
- ``gather/scatter/index``: gathers, scatters, index and masked ops;
- ``matmul (SSIM)``: the step's only matrix products, SSIM's band blurs;
- ``elementwise/reduction``: everything else that computes;
- ``kernel <entry point>``: the port's hand kernels
  (``csrc/rasterize_{fwd,bwd}.cu``), by entry point;
- ``copy``: device copies, casts, concatenations, host transfers;
- ``memset``: fills and zeroing.
"""

from __future__ import annotations

import argparse
import re
import time
from collections import defaultdict

REPS = 3
M_CAMS = 8          # the scene's cameras, as in JAX's script
_FWD_MODES = {"kRgb": "rasterize_fwd", "kSh": "rasterize_fwd_sh",
              "kPreset": "rasterize_fwd_preset",
              "kPresetSh": "rasterize_fwd_preset_sh",
              "0": "rasterize_fwd", "1": "rasterize_fwd_sh",
              "2": "rasterize_fwd_preset", "3": "rasterize_fwd_preset_sh"}
_RULES = (   # (category, pattern), first match wins, on the lower-case name
    ("memset", r"^memset|fill|zero_|\bzeros\b|\bones\b"),
    ("copy", r"^memcpy|copy|\bcat\b|catarray|\bstack\b|\bclone\b|"
             r"contiguous|_to_copy|\bto\b|transpose|permute"),
    ("gather/scatter/index", r"index|gather|scatter|\btake|\bput|masked|"
                             r"nonzero|repeat_interleave|embedding|"
                             r"\bselect\b|\bslice\b"),
    ("sort/search/scan", r"sort|search|\bscan|scan_|cumsum|cumprod|"
                         r"\bunique|topk|radix"),
    ("matmul (SSIM)", r"gemm|cublas|cutlass|xmma|nvjet|\bmm\b|\bbmm\b|"
                      r"addmm|matmul|\blinear\b|dot\b"),
)


def category(name: str) -> str:
    """The category of one traced operation, by its name."""
    if "rasterize_fwd_kernel" in name:
        args = name.split("rasterize_fwd_kernel", 1)[1]
        mode = re.search(r"kPresetSh|kPreset|kSh|kRgb|\)\s*(\d)", args)
        key = (mode.group(1) or mode.group(0)) if mode else "kRgb"
        return "kernel " + _FWD_MODES.get(key, "rasterize_fwd")
    if "rasterize_bwd_kernel" in name:
        args = name.split("rasterize_bwd_kernel", 1)[1]
        return "kernel rasterize_bwd" + ("_sh" if "true" in args[:16]
                                         else "")
    low = name.lower()
    for cat, pattern in _RULES:
        if re.search(pattern, low):
            return cat
    return "elementwise/reduction"


def attribute(intervals):
    """[(start, end, name)] in one clock → (categories {name: time},
    ops {name: time}, gaps, window): every instant of the window [first
    start, last end] to the innermost interval covering it (the latest
    start; of two, the earlier end), or to the gaps."""
    ev = sorted((float(s), float(e), n) for s, e, n in intervals if e > s)
    cats, ops = defaultdict(float), defaultdict(float)
    if not ev:
        return {}, {}, 0.0, 0.0
    bounds = sorted({t for s, e, _ in ev for t in (s, e)})
    gaps, active, i = 0.0, [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(ev) and ev[i][0] <= a:
            active.append(ev[i])
            i += 1
        active = [x for x in active if x[1] > a]
        if not active:
            gaps += b - a
            continue
        name = max(active, key=lambda x: (x[0], -x[1]))[2]
        cats[category(name)] += b - a
        ops[name] += b - a
    return dict(cats), dict(ops), gaps, bounds[-1] - bounds[0]


def trace_and_attribute(fn, reps=REPS, warmup=1, device=None):
    """``fn()`` ``warmup`` times, then ``reps`` times under
    ``torch.profiler`` → {"device", "reps", "untraced_ms", "window_ms",
    "gaps_ms", "categories": {category: ms}, "ops": {name: ms}} (totals
    over the reps; categories plus gaps equal the window; ``untraced_ms``
    the same ``reps`` calls timed without the profiler, CUDA events on the
    card).  ``device`` (default: the card
    when there is one) chooses what is read: the CUDA activity, or the
    calling thread's CPU ops."""
    import threading

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    card = torch.cuda.is_available() if device is None \
        else torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    # the same calls untraced, for what the tracing costs
    if card:
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        untraced = e0.elapsed_time(e1)
    else:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        untraced = (time.perf_counter() - t0) * 1e3
    # on the card the CUDA activity alone: recording every CPU op would
    # slow the host between launches, the gaps this reads
    acts = [ProfilerActivity.CUDA] if card else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        if card:
            torch.cuda.synchronize()
    events = prof.events()
    if card:
        rows = [e for e in events if e.device_type == DeviceType.CUDA]
    else:
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        # the calling thread: the one whose ops span the most time
        span = defaultdict(float)
        for e in cpu:
            span[e.thread] += e.time_range.end - e.time_range.start
        main = max(span, key=span.get) if span else threading.get_ident()
        rows = [e for e in cpu if e.thread == main]
    cats, ops, gaps, window = attribute(
        (e.time_range.start, e.time_range.end, e.name) for e in rows)
    ms = 1e-3                                     # the profiler's µs
    return {"device": "cuda" if card else "cpu", "reps": reps,
            "untraced_ms": untraced,
            "window_ms": window * ms, "gaps_ms": gaps * ms,
            "categories": {k: v * ms for k, v in cats.items()},
            "ops": {k: v * ms for k, v in ops.items()}}


def report(res, label, top_cats=25, top_ops=30, log=print):
    """Print an attribution as JAX's ``main`` prints it: ms per repetition
    by category, the gaps, then the top single ops."""
    r = res["reps"]
    busy = res["window_ms"] - res["gaps_ms"]
    idle = max(res["untraced_ms"] - busy, 0.0)
    log(f"== {label}: {res['device']} window {res['window_ms']:.3f} ms over "
        f"{r} reps (~{res['window_ms'] / r:.3f} ms each; gaps "
        f"{res['gaps_ms'] / r:.3f} ms each) ==")
    log(f"   busy {busy / r:.3f} ms each; untraced "
        f"{res['untraced_ms'] / r:.3f} ms each, so idle {idle / r:.3f} ms "
        f"each "
        f"({100 * idle / max(res['untraced_ms'], 1e-12):.1f}%: the gaps "
        f"without the profiler's own cost)")
    for k, v in sorted(res["categories"].items(),
                       key=lambda kv: -kv[1])[:top_cats]:
        log(f"{v / r:9.3f} ms  {k}")
    log(f"{res['gaps_ms'] / r:9.3f} ms  (gaps between operations)")
    log("-- top single ops --")
    for k, v in sorted(res["ops"].items(), key=lambda kv: -kv[1])[:top_ops]:
        log(f"{v / r:9.3f} ms  {k[:90]}")


def view0_fns(table, cams, cfg, tcfg, bspec, rspec, preset=False):
    """→ (a render of view 0, a train step of view 0 from a fresh state),
    each a callable of no arguments (the step's result is dropped, so
    every call starts from the same state)."""
    import torch

    from gsplat_tpu_torch.bench import fresh_state, make_step
    from gsplat_tpu_torch.models.splatter import render_padded

    params, live = table.params(), table.live

    def render():
        with torch.no_grad():
            render_padded(params, live, cams["w2c_rot"][0],
                          cams["w2c_tran"][0], cams["grid"], cfg, bspec,
                          rspec, cams["sh_vecs"][0], preset)

    step = make_step(cams, cfg, tcfg, bspec, rspec)
    st = fresh_state(table)

    def train():
        step(st, 0)

    return render, train


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", nargs="?", default="render",
                    choices=["render", "train"])
    ap.add_argument("n_gaussians", nargs="?", type=int, default=506_627)
    ap.add_argument("variant", nargs="?", default="",
                    choices=["", "sh", "preset"])
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    import torch

    if a.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"--device {a.device}: no CUDA device")
    from gsplat_tpu_torch.bench import CARD, build_scene

    scene = build_scene(a.n_gaussians, CARD["w"], CARD["h"], CARD["focal"],
                        M_CAMS, a.variant == "sh", a.device)
    render, train = view0_fns(*scene, preset=a.variant == "preset")
    fn = render if a.mode == "render" else train
    res = trace_and_attribute(fn, device=a.device)
    report(res, f"{a.mode} {a.n_gaussians} {a.variant or 'rgb'}")
    return res


if __name__ == "__main__":
    main()
