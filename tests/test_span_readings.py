"""``scripts/span_readings.py`` on the CPU: its readings of hand-made span
records, a tiny run of each kind of the benchmark's cells, and how the
benchmark's gap attribution (``splatbench.tracing.read_events``) names an
idle gap that falls inside a span."""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from gsplat_tpu_torch.utils import timer
from gsplat_tpu_torch.utils.timer import SpanRecord, span
from splatbench import tracing
from splatbench.conftest import make_root

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "span_readings", REPO / "scripts" / "span_readings.py")
sr = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(sr)


@pytest.fixture(autouse=True)
def spans_off():
    timer.enable(False)
    timer.take()
    yield
    timer.enable(False)
    timer.take()


def _records(rows):
    """(name, parent position or None, start ms, end ms) → records."""
    ms = 1_000_000
    return [SpanRecord(i, name, None, parent, int(a * ms), int(b * ms))
            for i, (name, parent, a, b) in enumerate(rows)]


TRAIN = _records([
    ("trainer.window", None, 0, 30),
    ("trainer.step", 0, 0, 10),
    ("step.pack", 1, 2, 6),
    ("sync.pack", 2, 3, 5),          # 2 ms of the step's 10 are a wait
    ("trainer.step", 0, 10, 18),
    ("step.pack", 4, 11, 14),
    ("sync.pack", 5, 12, 13),
    ("trainer.densify", 0, 18, 25),
    ("sync.log", 0, 25, 29),
])
RENDER = _records([
    ("serve.request", None, 0, 10),
    ("step.pack", 0, 1, 4),
    ("sync.pack", 1, 2, 3),
    ("serve.to_host", 0, 6, 10),
    ("serve.request", None, 10, 16),
    ("step.pack", 4, 11, 13),
    ("sync.pack", 5, 11, 13),
    ("serve.to_host", 4, 14, 16),
])


@pytest.mark.parametrize("kind,records,want", [
    ("train", TRAIN, {"steps": 2, "step_host_ms": (8 + 7) / 2,
                      "sync_wait_ms": (2 + 1 + 4) / 2, "syncs_per_step": 1.5,
                      "densify_host_ms": 7.0}),
    ("train", TRAIN[:7], {"steps": 2, "step_host_ms": 7.5,
                          "sync_wait_ms": 1.5, "syncs_per_step": 1.0,
                          "densify_host_ms": None}),
    ("render", RENDER, {"frames": 2, "sync_wait_ms": 1.5,
                        "to_host_ms": 3.0}),
])
def test_readings_of_hand_made_records(kind, records, want):
    got = sr.readings(records, kind)
    for k, v in want.items():
        assert got[k] == (pytest.approx(v) if v is not None else None), k
    assert got["spans"]["step.pack"]["n"] == 2


@pytest.mark.parametrize("workload,count,syncs", [("sh-train", 10, 1.3),
                                                  ("rgb-render", 4, 1.0)])
def test_tiny_run_reads_the_spans(tmp_path, capsys, workload, count, syncs):
    root = make_root(tmp_path / "root")
    out = tmp_path / "out.json"
    assert sr.main(["--workload", workload, "--seed", "2147483999",
                    "--device", "cpu", "--root", str(root), "--pairs", "1",
                    "--window", "0.2", "--out", str(out)]) == 0
    line = json.loads(out.read_text())
    assert line == json.loads(capsys.readouterr().out.strip())
    assert line["device"] == "cpu" and line["profiles"] == {}
    assert len(line["untraced_s"]) == len(line["spans_on_s"]) == 1
    (r,) = line["readings"]
    if workload == "sh-train":
        # iterations 695-704: windows end at 699, the event at 700, and 704
        assert r["steps"] == count and r["syncs_per_step"] == syncs
        assert r["spans"]["trainer.densify"]["n"] == 1
        assert 0 < r["sync_wait_ms"] < r["step_host_ms"]
    else:
        assert r["frames"] == count
        assert r["spans"]["sync.pack"]["n"] == count * syncs
        assert r["to_host_ms"] > 0 and r["sync_wait_ms"] > 0
    assert span("a") is span("b") and timer.take() == []   # spans off


@pytest.mark.parametrize("on,label", [(True, "step.pack"),
                                      (False, "host: no traced operation")])
def test_a_gap_inside_a_span_is_named_by_it(on, label):
    """The card idle while the host is in the span's own Python, in no
    aten operation: with the spans on the gap takes the span's name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.arange(4096.0)
    timer.enable(on)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("trainer.step", id=0):
            with span("step.pack"):
                x.sum()
                time.sleep(0.005)
                x.sum()
    sums = sorted((e.time_range.start, e.time_range.end) for e in
                  prof.events() if e.name == "aten::sum"
                  and e.device_type == DeviceType.CPU)
    assert len(sums) == 2
    device = [(a, b, f"kernel {i}") for i, (a, b) in enumerate(sums)]
    host = [(e.time_range.start, e.time_range.end, e.name)
            for e in prof.events()]
    gaps = tracing.read_events(device, host)["idle_gaps"]
    assert [g[0] for g in gaps] == [label]
    assert gaps[0][1] >= 0.004
    assert sr.no_op_share(gaps) == (0.0 if on else 1.0)
