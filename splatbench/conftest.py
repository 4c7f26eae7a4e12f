"""Fixtures of the benchmark's CPU tests: a checkout root at a tiny size.

    python -m pytest splatbench -q

The tiny root holds a ``BENCHMARK.json`` whose cells are the real cells'
kinds at a size a CPU holds (a few thousand gaussians, 72x56 pixels, a
20-iteration episode through a densify event), with the real cells' limits
and per-layer readers.  Tests marked ``cuda`` need the card and skip
without it.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "splatbench"

TINY = {"n_gaussians": 1500, "width": 72, "height": 56, "focal": 80.0,
        "n_cameras": 16, "capacity_round": 512}
TRAIN = {"kind": "train_episodes", "start": 691, "end": 711,
         "metrics_every": 5, "check_steps": 3, "check_event": 700,
         "events": [700], "traced": [695, 705]}
RENDER = {"kind": "render_requests", "clients": 1, "yaw": 0.05, "x": 0.10,
          "y": 0.03, "warmup_requests": 2, "check_sample": 3,
          "traced_requests": 4}
# tiny cell → (the real configuration it shrinks, its traffic, the real
# cell whose limits it keeps)
CELLS = {"sh-train": ("garden-fast-506k-sh", "tiny_train",
                      "fast506k-sh-train"),
         "rgb-train": ("garden-quality-2400k-rgb", "tiny_train",
                       "quality2400k-rgb-train"),
         "rgb-render": ("garden-quality-2400k-rgb", "tiny_render",
                        "quality2400k-rgb-render")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test where "
        "torch.cuda.is_available() is False")


def make_root(root: Path) -> Path:
    """A checkout root of tiny cells: BENCHMARK.json and splatbench/'s
    data (configurations, traffic, limits, readers)."""
    data = root / "splatbench"
    shutil.copytree(DATA / "metrics", data / "metrics")
    for d in ("configs", "traffic", "limits"):
        (data / d).mkdir(parents=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    configs = {}
    for name, (conf, _, _) in CELLS.items():
        c = json.loads((DATA / "configs" / f"{conf}.json").read_text())
        c.update(TINY, name=f"tiny-{conf}")
        configs[c["name"]] = c
    for name, c in configs.items():
        (data / "configs" / f"{name}.json").write_text(json.dumps(c))
    (data / "traffic" / "tiny_train.json").write_text(json.dumps(TRAIN))
    (data / "traffic" / "tiny_render.json").write_text(json.dumps(RENDER))
    bench["configs"] = [{"name": n, "source": "tiny", "reduced": [],
                         "file": f"splatbench/configs/{n}.json", "why": "t"}
                        for n in configs]
    bench["workloads"] = []
    for name, (conf, traffic, real) in CELLS.items():
        bench["workloads"].append({"name": name, "config": f"tiny-{conf}",
                                   "traffic": traffic, "chips": 1,
                                   "why": "tiny"})
        shutil.copy(DATA / "limits" / f"{real}.json",
                    data / "limits" / f"{name}.json")
    real_to_tiny = {real: name for name, (_, _, real) in CELLS.items()}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [real_to_tiny[w] for w in m["workloads"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
