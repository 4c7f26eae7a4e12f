"""The harness: finds a cell's configuration, traffic mix, limits and
per-layer readers by name, runs it, decides ``correct`` and prints the
result line.

    python3 splatbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

Everything of one configuration, one traffic mix or one per-layer metric
is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- the configuration entry's ``file`` (``configs/``): the sizes and
  settings as run;
- ``traffic/<traffic>.json``: a mix's parameters; its ``kind`` names the
  general generator that reads it (``train_episodes``, ``render_requests``);
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric name>.py``: a per-layer metric's reader, ``read(ctx)``
  → a number, or None where the run has nothing for it to read.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "gsplat_tpu"})


def kinds():
    from splatbench import render_cell, train_cell

    return {"train_episodes": train_cell, "render_requests": render_cell}


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"splatbench: no {what} named {name!r} in "
                     "BENCHMARK.json")


def load_cell(bench: dict, workload: str, root: Path):
    """→ (cell, configuration, traffic mix) of ``workload``."""
    cell = find(bench["workloads"], workload, "workload")
    conf = find(bench["configs"], cell["config"], "configuration")
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "splatbench" / "traffic"
                          / f"{cell['traffic']}.json").read_text())
    return cell, config, traffic


def applies(metric: dict, workload: str, e2e_names=()) -> bool:
    """A metric applies to a cell listed under its ``workloads``; without
    that key, an end-to-end metric to every cell and a per-layer one to
    every cell that reports the metric it moves."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def reader(name: str, root: Path):
    """The ``read`` function of ``splatbench/metrics/<name>.py``."""
    path = root / "splatbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "splatbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def parse(argv):
    ap = argparse.ArgumentParser(description="the port's benchmark: one "
                                 "run of one cell, one JSON result line")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(bench, cell, out, trace, device_info, limits, root):
    """The run's result: the metrics of the run's kind, the device, the
    breakdown (traced) and, last, each number compared beside its
    limit."""
    from splatbench import check

    name = cell["name"]
    e2e = [m for m in bench["end_to_end"] if applies(m, name)]
    e2e_names = [m["name"] for m in e2e]
    metrics = {}
    if trace:
        for m in bench["per_layer"]:
            if applies(m, name, e2e_names):
                v = reader(m["name"], root)(out["ctx"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    correct, checks = check.decide(out["values"], limits)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(device_info,
                           memory_peak_bytes=out["memory_peak_bytes"])}
    if trace:
        t = out["ctx"]["trace"]
        line["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    line["notes"] = out["notes"]
    line["checks"] = checks
    return line, checks


def main(argv=None, clock0=None, root: Path | None = None,
         device=None) -> int:
    """One run.  ``device`` given (tests) skips the look for the card."""
    import time

    clock0 = time.perf_counter() if clock0 is None else clock0
    args = parse(argv)
    root = Path(root) if root is not None else HERE.parent
    bench = load_benchmark(root)
    cell, config, traffic = load_cell(bench, args.workload, root)
    from splatbench import check

    limits = check.load_limits(cell["name"], root / "splatbench")
    import torch

    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            print(f"splatbench: {cell['name']} needs {cell['chips']} CUDA "
                  f"device(s); torch.cuda.is_available() is "
                  f"{torch.cuda.is_available()}, device_count "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": cell["chips"]}
        print(f"splatbench: {power_limit()}", file=sys.stderr, flush=True)
    else:
        device = torch.device(device)
        info = {"platform": device.type, "kind": device.type,
                "count": cell["chips"]}
    out = kinds()[traffic["kind"]].run(config, traffic, args.seed,
                                       args.seconds, args.trace, device,
                                       clock0)
    line, checks = result_line(bench, cell, out, args.trace, info, limits,
                               root)
    # after the per-layer readers too: everything this process loaded
    found = forbidden_modules(sys.modules)
    if found:
        print(f"splatbench: JAX or the JAX package was imported: {found}",
              file=sys.stderr)
        return 3
    check.print_checks(checks)
    print(json.dumps(line), flush=True)
    return 0
