"""The harness at a tiny size on the CPU: whole runs, the decision of
``correct`` against planted faults and the controls, discovery of cells,
mixes and metrics by name, the import check and the look for a card."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from splatbench import check, harness, render_cell, train_cell
from splatbench.conftest import REPO

SECONDS = "1.5"


def run(root, workload, capsys, trace=0, device="cpu"):
    rc = harness.main(["--workload", workload, "--seed", "2147483999",
                       "--seconds", SECONDS, "--trace", str(trace)],
                      root=root, device=device)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload", ["sh-train", "rgb-train",
                                      "rgb-render"])
def test_run_is_correct(tiny_root, capsys, workload):
    line, err = run(tiny_root, workload, capsys)
    assert line["correct"] is True
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    e2e = {"train_it_per_s", "setup_s"} if "train" in workload \
        else {"render_fps", "setup_s"}
    assert e2e <= set(line["metrics"])
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name
    # the numbers compared are also the last lines on standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_each_cell_reports_its_end_to_end_metrics(tiny_root, capsys):
    line, _ = run(tiny_root, "rgb-render", capsys)
    assert set(line["metrics"]) == {"render_fps", "setup_s"}
    line, _ = run(tiny_root, "rgb-train", capsys)
    assert set(line["metrics"]) == {"train_it_per_s", "setup_s"}
    # the reference's ground truth is set-up's, but not in setup_s
    st = line["notes"]["setup"]
    assert st["gt_s"] > 0
    assert line["metrics"]["setup_s"]["value"] == pytest.approx(
        st["start_s"] + st["data_s"] + st["warm_up_s"] + st["check_steps_s"])


def _half(fn):
    def half(img, gt, *args, **kwargs):
        rows = img.shape[1] // 2
        return fn(img[:, :rows], gt[:, :rows], *args, **kwargs)
    return half


FAULTS = {
    "state_unchanged": lambda m: m.setattr(
        "gsplat_tpu_torch.train.apply_grads",
        lambda st, grads, visible, lrs, tcfg: st),
    "half_batch": lambda m: (
        m.setattr("gsplat_tpu_torch.train.l1_loss",
                  _half(__import__("gsplat_tpu_torch.train").train.l1_loss)),
        m.setattr("gsplat_tpu_torch.train.ssim",
                  _half(__import__("gsplat_tpu_torch.train").train.ssim))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_train_fault_is_not_correct(tiny_root, capsys, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line, _ = run(tiny_root, "sh-train", capsys)
    assert line["correct"] is False


def test_altered_answer_is_not_correct(tiny_root, capsys, monkeypatch):
    import gsplat_tpu_torch.viewer as viewer

    inner = viewer.render_cropped

    def altered(*args, **kwargs):
        img, aux = inner(*args, **kwargs)
        img = img.clone()
        img[1, 10, 20] += 0.01
        return img, aux

    monkeypatch.setattr(viewer, "render_cropped", altered)
    line, _ = run(tiny_root, "rgb-render", capsys)
    assert line["correct"] is False


def _cell(root, workload):
    bench = harness.load_benchmark(root)
    return harness.load_cell(bench, workload, root)


@pytest.mark.parametrize("precision,fault", [("tf32", None), ("bf16", None),
                                             ("f32", "half")])
def test_train_control_is_not_correct(tiny_root, precision, fault):
    """The reference put in the program's place in the next precision down
    (TF32 in SSIM's blurs; bf16 pairs), or with half the image left out of
    the loss, fails the cell's limits."""
    cell, config, traffic = _cell(tiny_root, "sh-train")
    c = train_cell.Cell(config, traffic, 11, torch.device("cpu"))
    values = train_cell.compare(c.reference_numbers(precision, fault),
                                c.reference_numbers())
    limits = check.load_limits("sh-train", tiny_root / "splatbench")
    ok, _ = check.decide(values, {k: limits[k] for k in values})
    assert not ok


def test_render_control_is_not_correct(tiny_root):
    """The program's own bf16 render preset fails the render cell's
    limit."""
    _, config, traffic = _cell(tiny_root, "rgb-render")
    c = render_cell.Cell(config, traffic, 12, torch.device("cpu"))
    kept = [(p, c.request(p, fast=True))
            for p in (c.next_pose() for _ in range(3))]
    limits = check.load_limits("rgb-render", tiny_root / "splatbench")
    assert c.reference_gap(kept) > limits["frame_gap"]


def test_new_files_are_found_by_name(tiny_root, capsys):
    """A new configuration, traffic mix and per-layer reader are files of
    their own, found by the names BENCHMARK.json gives them; no file that
    was there changes."""
    data = tiny_root / "splatbench"
    before = {p: p.read_bytes() for p in data.rglob("*") if p.is_file()}
    conf = json.loads((data / "configs" / "tiny-garden-quality-2400k-rgb"
                       ".json").read_text())
    conf.update(name="tiny-dense", n_gaussians=2500)
    (data / "configs" / "tiny-dense.json").write_text(json.dumps(conf))
    mix = json.loads((data / "traffic" / "tiny_render.json").read_text())
    mix.update(width=48, height=40, fast=True)
    (data / "traffic" / "tiny_preset.json").write_text(json.dumps(mix))
    (data / "metrics" / "requests.preset.py").write_text(
        "def read(ctx):\n"
        "    lat = ctx.get('latencies')\n"
        "    return float(len(lat)) if lat else None\n")
    shutil.copy(data / "limits" / "rgb-render.json",
                data / "limits" / "dense-preset.json")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-dense", "source": "tiny",
                             "file": "splatbench/configs/tiny-dense.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": "dense-preset", "config": "tiny-dense",
                               "traffic": "tiny_preset", "chips": 1,
                               "why": "t"})
    bench["per_layer"].append({"name": "requests.preset", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "serve", "moves": "render_fps",
                               "workloads": ["dense-preset"]})
    for m in bench["end_to_end"]:
        if m["name"] == "render_fps":
            m["workloads"].append("dense-preset")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    for p, b in before.items():
        assert p.read_bytes() == b
    cell, config, traffic = _cell(tiny_root, "dense-preset")
    assert config["n_gaussians"] == 2500 and traffic["fast"] is True
    assert render_cell.sizes(config, traffic)["width"] == 48
    line, _ = run(tiny_root, "dense-preset", capsys)
    assert "render_fps" in line["metrics"]
    read = harness.reader("requests.preset", tiny_root)
    assert read({"latencies": [0.01, 0.02]}) == 2.0
    assert read({}) is None
    metric = bench["per_layer"][-1]
    assert harness.applies(metric, "dense-preset")
    assert not harness.applies(metric, "rgb-render")


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["gsplat_tpu_torch", "gsplat_tpu_torch.train", "jaxtyping",
             "splatbench.harness", "jax", "jax.numpy", "jaxlib.xla_client",
             "flax.linen", "gsplat_tpu", "gsplat_tpu.ops.rasterize"]
    assert harness.forbidden_modules(names) == sorted(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "gsplat_tpu",
         "gsplat_tpu.ops.rasterize"])


def test_a_run_imports_neither_jax_nor_the_jax_package(tiny_root):
    """A whole run in a fresh interpreter loads no module whose top-level
    name is jax, jaxlib, flax or gsplat_tpu."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        "from splatbench import harness\n"
        f"rc = harness.main(['--workload', 'sh-train', '--seed', '5', "
        f"'--seconds', '1', '--trace', '0'], root={str(tiny_root)!r}, "
        "device='cpu')\n"
        "print('LOADED', sorted({m.split('.')[0] for m in sys.modules}))\n"
        "sys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = proc.stdout.split("LOADED", 1)[1]
    tops = set(eval(loaded))
    assert "gsplat_tpu_torch" in tops
    assert not tops & harness.FORBIDDEN


def test_a_reader_that_imports_the_jax_package_stops_the_result(tiny_root,
                                                                tmp_path):
    """The import check runs after the per-layer readers: a traced run whose
    reader loads a module named ``gsplat_tpu`` prints no result."""
    stubs = tmp_path / "stubs" / "gsplat_tpu"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("")
    (tiny_root / "splatbench" / "metrics" / "stub.render.py").write_text(
        "def read(ctx):\n"
        "    import gsplat_tpu  # noqa: F401\n"
        "    return 1.0\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["per_layer"] = [{"name": "stub.render", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "serve", "moves": "render_fps",
                           "workloads": ["rgb-render"]}]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(stubs.parent)!r}, {str(REPO)!r}]\n"
        "from splatbench import harness, render_cell\n"
        "render_cell._traced = lambda cell, device: {'busy_s': 1.0, "
        "'window_s': 1.0, 'device_ops': [], 'idle_gaps': []}\n"
        "sys.exit(harness.main(['--workload', 'rgb-render', '--seed', '5', "
        f"'--seconds', '1', '--trace', '1'], root={str(tiny_root)!r}, "
        "device='cpu'))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert proc.returncode != 0
    assert "correct" not in proc.stdout
    assert "JAX or the JAX package was imported: ['gsplat_tpu']" \
        in proc.stderr, proc.stderr[-2000:]


def test_step_inputs_are_the_trainers_own(tiny_root):
    """The traced steps' inputs, read through the public Trainer one call an
    iteration with the seeded draws replayed, are those of an episode
    trained in windows."""
    _, config, traffic = _cell(tiny_root, "sh-train")
    c = train_cell.Cell(config, traffic, 13, torch.device("cpu"))
    lo, hi = traffic["traced"]
    seen = []
    b = c.episode()
    b.train(n_iters=lo, metrics_every=traffic["metrics_every"],
            log=lambda _m: None, start=traffic["start"])
    draw = b._draw_camera

    def recorded(group=None):
        g, cam = draw(group)
        seen.append((dict(b.state.params), b.state.live, cam))
        return g, cam

    b._draw_camera = recorded
    b.train(n_iters=hi, metrics_every=traffic["metrics_every"],
            log=lambda _m: None, start=lo)
    got = list(train_cell.step_inputs(c, lo, hi))
    assert len(got) == len(seen) == hi - lo
    assert any(lo <= e < hi for e in traffic["events"])
    for (params, live, k_max, n_live, cam), (p_b, live_b, cam_b) in zip(
            got, seen):
        assert cam == cam_b
        assert torch.equal(live, live_b)
        assert k_max == config["splat"]["max_tiles_per_gaussian"]
        assert n_live <= int(live.sum())
        for k in p_b:
            torch.testing.assert_close(params[k], p_b[k], equal_nan=True)


def test_no_card_exits_without_a_result(tiny_root, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = harness.main(["--workload", "sh-train", "--seed", "1", "--seconds",
                       "1"], root=tiny_root)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["sh-train", "rgb-render"])
def test_traced_run_reports_its_per_layer_metrics(tiny_root, capsys,
                                                  workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the profiler's device trace)")
    line, _ = run(tiny_root, workload, capsys, trace=1, device=None)
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0 and line["device"]["window_s"] > 0
    assert line["metrics"]
    for name, m in line["metrics"].items():
        if m["unit"] == "%" and "idle" not in name:
            assert 0 < m["value"] <= 105, name
