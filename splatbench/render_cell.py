"""Traffic of kind ``render_requests``: viewer clients in a closed loop.

Each client sends a pose drawn from the seed inside the span of the camera
ring (yaw, x and y uniform within the mix's bounds) and waits for the image
on the host, ``viewer.render_offscreen`` at the mix's size (by default the
configuration's), before it sends the next.  A request's latency runs from
the call to the returned image.  The window ends at the first request that
completes after its deadline.

The check: a sample of the window's requests, drawn from the seed
(reservoir sampling over all of them), is rendered again by the reference
after the window, and each returned image is compared pixel by pixel.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from splatbench import port, scene, tracing
from splatbench import reference as ref


def sizes(config, traffic) -> dict:
    """The request's width, height, focal and route."""
    return {k: traffic.get(k, config[k]) for k in ("width", "height",
                                                  "focal")} | {
        "fast": traffic.get("fast", config["splat"]["fast_drawing"])}


class Cell:
    def __init__(self, config, traffic, seed, device):
        self.config, self.traffic, self.device = config, traffic, device
        self.size = sizes(config, traffic)
        self.table = scene.draw_table(config, seed, device)
        self.splat = port.splatter(config, self.table, port.scene_cameras(
            config, scene.ring(config), None, device))
        self.poses = np.random.default_rng(scene.sub_seed(seed, 2))
        self.sampler = np.random.default_rng(scene.sub_seed(seed, 3))
        self.grid = ref.Grid(self.size["width"], self.size["height"],
                             self.size["focal"], self.size["focal"])

    def request(self, w2c, fast=None):
        return port.render(self.splat, w2c, self.size,
                           self.size["fast"] if fast is None else fast)

    def next_pose(self):
        return scene.pose(self.poses, self.traffic)

    def reference_gap(self, kept, precision="f32") -> float:
        """The widest per-pixel gap of the kept images against the
        reference's renders of their poses."""
        params = {k: self.table[k] for k in port.PARAMS}
        consts = scene.scene_consts(self.config)
        gap = 0.0
        for w2c, img in kept:
            r = ref.render(params, self.table["live"], w2c[:3, :3],
                           w2c[:3, 3], self.grid, consts, precision)
            got = torch.as_tensor(img, device=self.device).permute(2, 0, 1)
            gap = max(gap, float((got - r).abs().max()))
        return gap


def _window(cell: Cell, seconds: float):
    k = cell.traffic["check_sample"]
    lat, kept = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while True:
        w2c = cell.next_pose()
        a = time.perf_counter()
        img = cell.request(w2c)
        b = time.perf_counter()
        lat.append(b - a)
        n = len(lat)
        if n <= k:
            kept.append((w2c, img))
        else:
            j = int(cell.sampler.integers(0, n))
            if j < k:
                kept[j] = (w2c, img)
        if b >= deadline:
            return lat, b - t0, kept


def _traced(cell: Cell, device) -> dict:
    """The next ``traced_requests`` poses, untraced and synchronised, then
    twice under the profiler (``tracing.profile``); each frame's work
    counted by the reference."""
    poses = [cell.next_pose() for _ in range(cell.traffic["traced_requests"])]
    tracing.sync(device)
    t0 = time.perf_counter()
    for w2c in poses:
        cell.request(w2c)
    tracing.sync(device)
    untraced = time.perf_counter() - t0
    def frames():
        for w2c in poses:
            cell.request(w2c)

    prof = tracing.profile(frames, frames, device)
    params = {k: cell.table[k] for k in port.PARAMS}
    consts = scene.scene_consts(cell.config)
    colour = 27 if cell.config["splat"]["use_sh_coeff"] else 3
    g = cell.grid
    frames = [dict(ref.count_evaluations(params, cell.table["live"],
                                         w2c[:3, :3], w2c[:3, 3], g, consts),
                   colour=colour, n_live=cell.table["n_live"],
                   n_pix=g.padded_w * g.padded_h, n_tiles=g.n_tiles)
              for w2c in poses]
    return {"kind": "render", "untraced_s": untraced, "frames": frames,
            **prof}


def run(config, traffic, seed, seconds, trace, device, clock0) -> dict:
    if traffic["clients"] != 1:
        raise ValueError("render_requests drives one client")
    marks = [time.perf_counter()]
    cell = Cell(config, traffic, seed, device)
    marks.append(time.perf_counter())
    for _ in range(traffic["warmup_requests"]):
        cell.request(cell.next_pose())
    tracing.sync(device)
    marks.append(time.perf_counter())
    setup_s = marks[-1] - clock0
    tracing.reset_peak(device)
    lat, window_s, kept = _window(cell, seconds)
    peak = tracing.peak_bytes(device)
    ctx = {"latencies": lat}
    if trace:
        ctx["trace"] = _traced(cell, device)
    cell.splat = None
    tracing.free(device)
    failed = sum(1 for _, img in kept if not np.isfinite(img).all())
    lat_ms = np.array(lat) * 1e3
    thirds = np.array_split(lat_ms, 3)
    return {"e2e": {"render_fps": len(lat) / window_s, "setup_s": setup_s},
            "attempted": len(lat), "failed": failed,
            "memory_peak_bytes": peak,
            "values": {"frame_gap": cell.reference_gap(kept)}, "ctx": ctx,
            "notes": {"latency_ms": {q: float(np.percentile(lat_ms, q))
                                     for q in (5, 50, 95, 99)},
                      "mean_ms_by_third": [float(t.mean()) for t in thirds],
                      "setup": {"start_s": marks[0] - clock0,
                                "data_s": marks[1] - marks[0],
                                "warm_up_s": marks[2] - marks[1],
                                "build_s": port.build_seconds()}}}
