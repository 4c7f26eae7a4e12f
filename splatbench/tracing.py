"""Reading a ``torch.profiler`` trace of the card: busy time, kernel time
by name, the heaviest device operations and the longest idle gaps.

The arithmetic is that of the repository's ``profile_trace`` script: the
device's operations laid on one timeline, busy time the union of their
intervals, idle the time no operation covers.  Each idle gap is named by
the innermost host operation running at its middle, so the breakdown says
what the host was doing while the card waited.
"""

from __future__ import annotations

import time
from collections import defaultdict

TOP = 10


def _union(intervals):
    """Sorted (start, end) → merged intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def read_events(device_rows, host_rows):
    """Device rows [(start µs, end µs, name)] and the host thread's rows →
    {busy_s, kernel_s {name: s}, device_ops [[name, s]], idle_gaps [[name,
    s]]}."""
    rows = [(float(s), float(e), n) for s, e, n in device_rows if e > s]
    merged = _union((s, e) for s, e, _ in rows)
    busy = sum(e - s for s, e in merged)
    by_name = defaultdict(float)
    for s, e, n in rows:
        by_name[n] += e - s
    gaps = [(a[1], b[0]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    host = sorted((float(s), float(e), n) for s, e, n in host_rows if e > s)
    labels = defaultdict(float)
    active, i = [], 0
    for g0, g1 in sorted(gaps):
        mid = 0.5 * (g0 + g1)
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= mid]
        name = max(active, key=lambda h: (h[0], -h[1]))[2] if active \
            else "host: no traced operation"
        labels[name] += g1 - g0
    us = 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(labels.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy * us,
            "kernel_s": {k: v * us for k, v in by_name.items()},
            "device_ops": [[k[:160], v * us] for k, v in top],
            "idle_gaps": [[k[:160], v * us] for k, v in idle]}


def _trace(fn, device, host: bool):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize(device)
    with tprofile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    dev_rows, host_by_thread = [], defaultdict(list)
    for e in prof.events():
        row = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            dev_rows.append(row)
        else:
            host_by_thread[e.thread].append(row)
    main = max(host_by_thread, key=lambda t: len(host_by_thread[t])) \
        if host_by_thread else None
    return dev_rows, host_by_thread.get(main, []), window


def profile(fn, fn_again, device):
    """``fn()`` traced with the device's activity alone (recording the
    host's operations slows the host, and with it the copies it takes part
    in), then ``fn_again()``, the same work, traced with the host's too, to
    name the idle gaps → :func:`read_events` of the first, its idle gaps
    replaced by the second's, and ``window_s``, the host clock's length of
    the first traced call."""
    dev_rows, _, window = _trace(fn, device, host=False)
    out = read_events(dev_rows, [])
    dev2, host2, _ = _trace(fn_again, device, host=True)
    out["idle_gaps"] = read_events(dev2, host2)["idle_gaps"]
    out["window_s"] = window
    return out


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    """The device's peak allocation since the last reset (0 off the
    card)."""
    import torch

    return torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0


def free(device):
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def kernel_seconds(kernel_s: dict, pattern: str) -> float:
    """Device time of the kernels whose name holds ``pattern``."""
    return sum(v for k, v in kernel_s.items() if pattern in k)
