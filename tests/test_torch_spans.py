"""The port's spans (``gsplat_tpu_torch/utils/timer.py``) on the CPU: the
off path, records, nesting and ids, the profiler's host events, and the
spans the Trainer and the viewer open, on the COLMAP fixture scene (100
points, 9 cameras, 64x48 PNGs)."""

import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.config import SplatConfig, TrainConfig
from gsplat_tpu_torch.models.splatter import Splatter
from gsplat_tpu_torch.train import Trainer
from gsplat_tpu_torch.utils import timer
from gsplat_tpu_torch.utils.timer import span
from gsplat_tpu_torch.viewer import render_offscreen

from fixtures import make_scene

torch.set_num_threads(1)
STEP_CHILDREN = ["step.project", "step.pack", "step.composite", "step.loss",
                 "step.backward", "step.adam"]


@pytest.fixture(autouse=True)
def spans_off():
    timer.enable(False)
    timer.take()
    yield
    timer.enable(False)
    timer.take()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_scene(d, n_points=100, n_cameras=9, w=64, h=48)
    return d


def _trainer(scene, **kw):
    splat = Splatter(os.path.join(scene, "sparse", "0"),
                     os.path.join(scene, "images_4"),
                     SplatConfig(capacity_round=128,
                                 max_tiles_per_gaussian=12), device="cpu")
    return Trainer(splat, TrainConfig(
        n_iters_test=0, n_save_train_img=0, n_adaptive_control=5,
        grad_thresh=1e-7, split_thresh=0.225, seed=1, **kw))


def _quiet(_msg):
    pass


def test_off_is_one_shared_object_that_never_reaches_the_profiler(
        monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("torch.profiler reached with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = span("step.pack"), span("serve.request", id=3)
    assert a is b
    with a as inner, span("sync.pack"):
        assert inner is a
    assert timer.take() == []


def test_records_nest_inherit_ids_and_give_self_time():
    timer.enable(True)
    with span("outer", id=7):
        with span("mid"):
            with span("leaf"):
                sum(range(1000))
        with span("mid"):
            pass
    with span("alone"):
        pass
    recs = timer.take()
    assert [r.name for r in recs] == ["outer", "mid", "leaf", "mid", "alone"]
    outer, mid, leaf, mid2, alone = recs
    assert outer.parent is None and alone.parent is None
    assert mid.parent == mid2.parent == outer.index
    assert leaf.parent == mid.index
    assert [r.id for r in recs] == [7, 7, 7, 7, None]
    for child, parent in ((mid, outer), (leaf, mid), (mid2, outer)):
        assert parent.start_ns <= child.start_ns <= child.end_ns \
            <= parent.end_ns
    s = timer.summary(recs)
    assert s["mid"]["n"] == 2 and s["outer"]["n"] == 1
    ms = 1e-6
    assert s["outer"]["self_ms"] == pytest.approx(
        (outer.duration_ns - mid.duration_ns - mid2.duration_ns) * ms)
    assert s["mid"]["mean_ms"] == pytest.approx(
        (mid.duration_ns + mid2.duration_ns) / 2 * ms)
    assert s["mid"]["self_ms"] == pytest.approx(
        (mid.duration_ns - leaf.duration_ns + mid2.duration_ns) / 2 * ms)
    assert s["leaf"]["self_ms"] == s["leaf"]["mean_ms"]
    assert timer.take() == []


def test_take_keeps_open_spans_until_they_close():
    timer.enable(True)
    with span("window", id=1):
        with span("step"):
            pass
        first = timer.take()
        timer.enable(False)         # an open span still closes its record
    second = timer.take()
    assert [r.name for r in first] == ["step"]
    assert [r.name for r in second] == ["window"]
    assert first[0].parent == second[0].index and first[0].id == 1


def test_span_is_a_host_event_of_the_profiler_inside_its_parent():
    from torch.profiler import ProfilerActivity, profile

    timer.enable(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("trainer.step", id=0):
            with span("step.pack"):
                torch.arange(64.0).sum()
    events = {e.name: e for e in prof.events()}
    outer, inner = events["trainer.step"], events["step.pack"]
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    assert any(e.name == "aten::sum" and outer.time_range.start
               <= e.time_range.start <= e.time_range.end
               <= inner.time_range.end for e in prof.events())


def test_train_steps_and_host_events_give_their_spans(scene):
    tr = _trainer(scene, n_opa_reset=603)
    timer.enable(True)
    tr.train(n_iters=607, metrics_every=20, log=_quiet, start=601)
    recs = timer.take()
    by_index = {r.index: r for r in recs}
    steps = [r for r in recs if r.name == "trainer.step"]
    assert [r.id for r in steps] == list(range(601, 607))
    for st in steps:
        kids = [r for r in recs if r.parent == st.index]
        assert [r.name for r in kids] == STEP_CHILDREN
        assert all(r.id == st.id for r in kids)
        pack = kids[1]
        syncs = [r for r in recs if r.parent == pack.index]
        assert [r.name for r in syncs] == ["sync.pack"]
    # windows end at the opacity reset at 603, the densify event at 605
    # and the last iteration
    windows = [r for r in recs if r.name == "trainer.window"]
    assert [w.id for w in windows] == [603, 605, 606]
    for name, at in (("trainer.opacity_reset", 603),
                     ("trainer.densify", 605)):
        (ev,) = [r for r in recs if r.name == name]
        assert ev.id == at and by_index[ev.parent].name == "trainer.window"
    logs = [r for r in recs if r.name == "sync.log"]
    assert [r.id for r in logs] == [603, 605, 606]
    assert all(by_index[r.parent].name == "trainer.window"
               for r in steps + logs)


def test_spans_change_no_number(scene):
    def run(on):
        timer.enable(on)
        tr = _trainer(scene)
        hist = tr.train(n_iters=607, metrics_every=2, log=_quiet, start=601)
        timer.enable(False)
        return hist, {k: v.clone() for k, v in tr.state.params.items()}

    (h_off, p_off), (h_on, p_on) = run(False), run(True)
    assert timer.take() != []
    assert h_off["l1"] == h_on["l1"] and h_off["psnr"] == h_on["psnr"]
    for k in p_off:     # bits: the free slots hold NaN
        assert torch.equal(p_off[k].view(torch.int32),
                           p_on[k].view(torch.int32)), k


def test_debug_prints_the_span_means(scene, capsys):
    tr = _trainer(scene, debug=True)
    tr.train(n_iters=101, metrics_every=20, log=_quiet, start=99)
    out = capsys.readouterr().out
    for name in ["trainer.window", "trainer.step", "sync.pack", "sync.log"]:
        assert f"'{name}'" in out
    assert "self_ms" in out


def test_render_offscreen_gives_request_and_copy_spans(scene):
    splat = _trainer(scene).splat
    cams = splat.cameras
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = cams.w2c_rot[0].numpy()
    w2c[:3, 3] = cams.w2c_tran[0].numpy()
    timer.enable(True)
    for _ in range(2):
        render_offscreen(splat, w2c, 64, 48, cams.grid.focal_x,
                         cams.grid.focal_y)
    render_offscreen(splat, w2c, 64, 48, cams.grid.focal_x,
                     cams.grid.focal_y, device_out=True)
    recs = timer.take()
    reqs = [r for r in recs if r.name == "serve.request"]
    assert len(reqs) == 3 and len({r.id for r in reqs}) == 3
    for req, has_copy in zip(reqs, (True, True, False)):
        kids = [r.name for r in recs if r.parent == req.index]
        assert kids == ["step.project", "step.pack", "step.composite"] \
            + ["serve.to_host"] * has_copy
        assert all(r.id == req.id for r in recs
                   if r.start_ns >= req.start_ns and r.end_ns <= req.end_ns)
