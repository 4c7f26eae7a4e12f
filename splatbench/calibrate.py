"""The readings each check limit is set from, at a cell's own size: the
program's sound runs on many seeds, and the controls on a few.

    python3 splatbench/calibrate.py --workload <name> [--workload ...]
        --seeds <n> --seed0 <s> --control-seeds <n>

Not part of a benchmark run.  One process reads every seed, so the
kernels build once.  For each seed it builds the cell's scene as a run
does and prints one JSON line of the numbers the check compares:

- train cells, the program: the Trainer's densify event (an episode to the
  event) and its first steps, against the reference;
- train cells, the controls, the reference put in the program's place: in
  TF32 (SSIM's blurs), in bf16 (the pairs), and with half the image left
  out of the loss (a planted fault);
- render cells, the program: a sample of requests against the reference;
- render cells, the control: with an RGB model the program's own bf16 render
  preset (``fast``), with SH the reference with its pairs in bf16.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_readings(config, traffic, seeds, control_seeds, device, emit):
    from splatbench import tracing, train_cell

    for seed in seeds:
        t0 = time.perf_counter()
        cell = train_cell.Cell(config, traffic, seed, device)
        cell.warm_up(end=traffic["check_event"] + 1)
        prog = cell.checked_steps()
        cell.first = None
        values = train_cell.compare(prog, cell.reference_numbers())
        values.update(cell.densify_values())
        emit(seed, "program", values, time.perf_counter() - t0)
        del cell
        tracing.free(device)
    for seed in control_seeds:
        cell = train_cell.Cell(config, traffic, seed, device)
        base = cell.reference_numbers()
        for mode, precision, fault in (("tf32", "tf32", None),
                                       ("bf16", "bf16", None),
                                       ("half", "f32", "half")):
            t0 = time.perf_counter()
            other = cell.reference_numbers(precision, fault)
            emit(seed, mode, train_cell.compare(other, base),
                 time.perf_counter() - t0)
        del cell
        tracing.free(device)


def render_readings(config, traffic, seeds, control_seeds, device, emit):
    import torch

    from splatbench import port, render_cell, scene, tracing
    from splatbench import reference as ref

    k = traffic["check_sample"]
    for seed in seeds:
        t0 = time.perf_counter()
        cell = render_cell.Cell(config, traffic, seed, device)
        kept = []
        for _ in range(k):
            w2c = cell.next_pose()
            kept.append((w2c, cell.request(w2c)))
        emit(seed, "program", {"frame_gap": cell.reference_gap(kept)},
             time.perf_counter() - t0)
        del cell
        tracing.free(device)
    for seed in control_seeds:
        t0 = time.perf_counter()
        cell = render_cell.Cell(config, traffic, seed, device)
        poses = [cell.next_pose() for _ in range(k)]
        if config["splat"]["use_sh_coeff"]:
            params = {n: cell.table[n] for n in port.PARAMS}
            consts = scene.scene_consts(config)
            kept = [(w2c, ref.render(params, cell.table["live"],
                                     w2c[:3, :3], w2c[:3, 3], cell.grid,
                                     consts, "bf16").permute(1, 2, 0)
                     .cpu().numpy()) for w2c in poses]
            mode = "reference_bf16"
        else:
            kept = [(w2c, cell.request(w2c, fast=True)) for w2c in poses]
            mode = "program_bf16_preset"
        emit(seed, mode, {"frame_gap": cell.reference_gap(kept)},
             time.perf_counter() - t0)
        del cell, kept
        tracing.free(device)
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", action="append", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--seed0", type=int, default=3_000_000_000)
    ap.add_argument("--control-seeds", type=int, default=3)
    a = ap.parse_args(argv)
    import torch

    from splatbench import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(json.dumps({"device": harness.power_limit()}), flush=True)
    bench = harness.load_benchmark(ROOT)
    seeds = [a.seed0 + i for i in range(a.seeds)]
    controls = [a.seed0 + 1000 + i for i in range(a.control_seeds)]
    for workload in a.workload:
        cell, config, traffic = harness.load_cell(bench, workload, ROOT)

        def emit(seed, mode, values, seconds, workload=workload):
            print(json.dumps({"workload": workload, "seed": seed,
                              "mode": mode, "values": values,
                              "seconds": seconds}), flush=True)

        run = {"train_episodes": train_readings,
               "render_requests": render_readings}[traffic["kind"]]
        run(config, traffic, seeds, controls, device, emit)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
