"""The comparison that decides ``correct``: each number compared, its limit,
and the verdict.

A cell's limits live in ``limits/<workload>.json``, one number each, set
from the readings that ``PERF.md`` gives (the program's sound runs below,
the control above).  A number that is missing or not finite fails.
"""

from __future__ import annotations

import json
import math
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_limits(workload: str, data: Path = HERE) -> dict:
    return json.loads((data / "limits" / f"{workload}.json").read_text())


def norms(tensors: dict) -> dict:
    """Each leaf's L2 norm, in float64."""
    import torch

    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in tensors.items()}


def worst_leaf(prog: dict, ref: dict, skip=()) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median
    leaf's → (gap, leaf)."""
    med = statistics.median(ref.values())
    worst, name = 0.0, ""
    for k, r in ref.items():
        if k in skip:
            continue
        denom = max(r, med)
        gap = abs(prog[k] - r) / denom if denom > 0 else math.inf
        if not gap <= worst:
            worst, name = gap, k
    return worst, name


def decide(values: dict, limits: dict) -> tuple[bool, dict]:
    """→ (correct, {name: {"value", "limit"}}) over every limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = values.get(name)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks


def print_checks(checks: dict):
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
