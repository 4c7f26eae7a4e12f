"""The yardstick's arithmetic: evaluations counted against a pair-by-pair
count, the operations and bytes, the per-layer readers and the trace's
reading."""

from __future__ import annotations

import pytest
import torch

from splatbench import counts, harness, scene, tracing
from splatbench import reference as ref
from splatbench.test_splatbench_reference import DEV, tiny


def test_evaluations_match_a_pair_by_pair_count():
    """Each pixel evaluates its tile's pairs in depth order until its
    transmittance falls below 1e-4: multiplied out one pair at a time."""
    config = tiny("garden-quality-2400k-rgb", n=4000)
    table = scene.draw_table(config, 8, DEV)
    grid = scene.grid_of(config)
    consts = scene.scene_consts(config)
    rot, tran = scene.ring(config)[2]
    params = {k: table[k] for k in ("pos", "rgb", "opa", "quat", "scale")}
    got = ref.count_evaluations(params, table["live"], rot, tran, grid,
                                consts)
    r, t, _ = ref.camera_tensors(rot, tran, grid, DEV)
    geom, _, depth, vis = ref.screen(params, table["live"], r, t, grid,
                                     consts["near"], False)
    src, starts, _ = ref.bin_pairs(geom, depth, vis, grid, consts["k_max"])
    tiles = torch.arange(grid.n_tiles)
    pxc, pyc = ref.pixel_centres(grid, tiles)
    trans = torch.ones(grid.n_tiles, grid.px, dtype=torch.float64)
    n = torch.zeros(grid.n_tiles, grid.px, dtype=torch.int64)
    count = starts[1:] - starts[:-1]
    for j in range(int(count.max())):
        has = count > j
        g = geom[src[torch.where(has, starts[:-1] + j, 0)]].double()
        dx = pxc.double() - g[:, 0:1]
        dy = pyc.double() - g[:, 1:2]
        a, b, c, d, o = (g[:, i:i + 1] for i in (2, 3, 4, 5, 6))
        alpha = torch.clamp_max(torch.exp(
            -(d * dx * dx - (b + c) * dx * dy + a * dy * dy)
            / (2 * (a * d - b * c) + 1e-14)) * o, 0.9999)
        live = has[:, None] & (trans >= 1e-4)
        n += live
        trans = torch.where(has[:, None], trans * (1 - alpha), trans)
    assert got["pairs"] == int(src.shape[0])
    assert abs(got["evaluations"] - int(n.sum())) <= 1e-3 * int(n.sum())


def test_operation_and_byte_counts():
    step = {"colour": 3, "evaluations": 1000, "n_live": 10, "pixels": 100}
    assert counts.train_step_flops(step) == (
        1000 * (28 + 90) + 10 * (180 + 360 + 14 * 14)
        + 100 * 3 * counts.LOSS_PER_PIXEL)
    assert counts.frame_flops({"colour": 27, "evaluations": 10,
                               "n_live": 2}) == 10 * 91 + 2 * 180
    assert counts.fwd_bytes(5, 3, 256, 1) == 4 * (5 * 9 + 4 * 256 + 2)
    assert counts.bwd_bytes(5, 27, 256, 1) == 4 * (2 * 5 * 33 + 7 * 256 + 2)
    # bound by operations, then by bytes
    assert counts.least_seconds(67e12, 1, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 1, 3.35e12) == pytest.approx(1.0)


def _reader(name):
    return harness.reader(name, harness.HERE.parent)


def test_readers():
    windows = [(20, 0.40, False), (20, 0.42, False), (20, 0.50, True),
               (17, 0.60, True), (20, 0.41, False)]
    assert _reader("densify_ms.train")({"windows": windows}) == \
        pytest.approx(1e3 * (0.50 - 0.41))
    steps = [{"colour": 3, "evaluations": 10 ** 9, "pairs": 10 ** 6,
              "n_live": 10 ** 6, "pixels": 10 ** 6, "n_pix": 10 ** 6,
              "n_tiles": 4000}]
    t = {"kind": "train", "untraced_s": 0.1, "busy_s": 0.08, "steps": steps,
         "kernel_s": {"rasterize_bwd_kernel<false>": 0.004,
                      "rasterize_fwd_kernel<0>": 0.001}}
    assert _reader("mfu.train")({"trace": t}) == pytest.approx(
        100 * counts.train_step_flops(steps[0]) / 0.1 / 67e12)
    least = max(1e9 * 90 / 67e12, counts.bwd_bytes(10 ** 6, 3, 10 ** 6,
                                                    4000) / 3.35e12)
    assert _reader("composite_bwd_roofline.train")({"trace": t}) == \
        pytest.approx(100 * least / 0.004)
    assert _reader("device_idle_share.train")({"trace": t}) == \
        pytest.approx(20.0)
    # the render's idle share is of the traced window, never below 0
    r = {"kind": "render", "untraced_s": 0.58, "busy_s": 0.66,
         "window_s": 0.92, "frames": []}
    assert _reader("device_idle_share.render")({"trace": r}) == \
        pytest.approx(100 * 0.26 / 0.92)
    lat = [0.001 * (i + 1) for i in range(100)]
    assert _reader("frame_p95_ms.render")({"latencies": lat}) == \
        pytest.approx(95.05)
    # a reader finds nothing to read in another kind of run
    for name in ("mfu.render", "composite_fwd_roofline.render",
                 "device_idle_share.render", "frame_p95_ms.render"):
        assert _reader(name)({"trace": t, "windows": windows}) is None
    # and no kernel of its name: nothing, never 0
    t["kernel_s"] = {}
    assert _reader("composite_bwd_roofline.train")({"trace": t}) is None


def test_trace_reading():
    dev = [(0, 10, "k1"), (5, 12, "k2"), (20, 30, "k1"), (40, 41, "k3")]
    host = [(11, 25, "aten::item"), (13, 14, "inner"), (26, 45, "launch")]
    out = tracing.read_events(dev, host)
    assert out["busy_s"] == pytest.approx(23e-6)
    assert out["kernel_s"]["k1"] == pytest.approx(20e-6)
    assert out["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert dict(out["idle_gaps"]) == {"aten::item": pytest.approx(8e-6),
                                      "launch": pytest.approx(10e-6)}
    assert tracing.kernel_seconds({"rasterize_bwd_kernel<true>": 2.0,
                                   "rasterize_fwd_kernel<1>": 1.0,
                                   "gemm": 5.0}, "rasterize_bwd") == 2.0
