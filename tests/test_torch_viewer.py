"""The viewer server, PyTorch port vs the JAX package, on the CPU.

``run_viewer`` of both packages is driven through the fake viser server of
``tests/torch_helpers.py`` (the one of ``tests/test_viewer.py:97-171``, with
control values set before the first frame).  Pushed frames: the in-memory
synthetic scene of ``tests/test_torch_preset.py`` (2,000 gaussians), JAX on
its column-compacted plane with exact depth ranks (``quant_depth=0``,
``bf16_pack=0``) and its jnp compositor, the port on its plain versions;
f32 within atol 1e-4, Fast Mode (the bf16 preset) within 1e-5.  Live
training: the COLMAP fixture scene of ``tests/test_torch_trainer.py`` with
JAX's dense plane, 2 loop iterations at the default period of 10 from
iteration 0 on both Trainers; l1 rtol 1e-4 and params relative L2 1e-4 (the
Trainer parity's bounds).
"""

import os
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import numpy as np
import pytest
import torch

from gsplat_tpu import synthetic as jsyn
from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.train import Trainer as JTrainer
from gsplat_tpu.viewer import render_offscreen as j_offscreen
from gsplat_tpu.viewer import run_viewer as j_run_viewer
from gsplat_tpu.viewer import snap_resolution as j_snap

from gsplat_tpu_torch import synthetic as tsyn
from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.config import TrainConfig as TTCfg
from gsplat_tpu_torch.models.splatter import SceneCameras as TCams
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.train import GROUP_ORDER, Trainer
from gsplat_tpu_torch.viewer import (RES_LADDER, camera_to_w2c,
                                     render_offscreen, run_viewer,
                                     snap_resolution)

from fixtures import make_scene
from torch_helpers import FakeServer, c2w_pose

torch.set_num_threads(1)
N, SCENE_FOCAL = 2000, 80.0
RES = 256           # the Resolution slider: 256 x 176 at aspect 1.5
CONTROLS = ("Reset View", "Train Viewer Update Period", "Pause Training",
            "SH Order", "Resolution", "Near", "Far", "Show Train Camera",
            "Fast Mode (bf16)", "FPS")


def _splatters(use_sh=False):
    """The same synthetic table in both packages (bit-identical draws)."""
    kw = dict(capacity_round=256, focal=SCENE_FOCAL, scale_px=3.0,
              frustum=(0.85, 0.55), use_sh=use_sh,
              sh_ampl=0.35 if use_sh else 0.0)
    jcfg = JCfg(plane_mode="colcap", quant_depth=0, bf16_pack=0,
                use_pallas=False, capacity_round=256, use_sh_coeff=use_sh)
    js = JSplatter.__new__(JSplatter)     # an in-memory scene, no COLMAP
    js.cfg, js.table, js._specs_cache = jcfg, jsyn.synthetic_table(N, **kw), {}
    tc = tsyn.synthetic_cameras(1, 96, 64, SCENE_FOCAL, device="cpu")
    ts = TSplatter.from_scene(
        TCfg(capacity_round=256, use_sh_coeff=use_sh),
        tsyn.synthetic_table(N, device="cpu", **kw),
        [TCams(w2c_rot=tc["w2c_rot"], w2c_tran=tc["w2c_tran"],
               sh_vecs=tc["sh_vecs"], images=tc["images"], grid=tc["grid"],
               names=["c0"])])
    return js, ts


def _frame(run, splat, **kw):
    """One loop iteration of ``run`` (a package's run_viewer) → (server,
    the one frame it pushed)."""
    srv = FakeServer(**kw)
    run(splat, server=srv, max_iters=1)
    assert len(srv.client.images) == 1
    return srv, srv.client.images[0]


@pytest.mark.parametrize("width,aspect,fov", [
    (1024, 1.5, 1.0), (700, 4 / 3, np.deg2rad(75)), (300, 0.75, 0.4),
    (5000, 1.0, 1.2), (2049, 16 / 9, 0.61)])
def test_snap_resolution_matches_jax(width, aspect, fov):
    assert snap_resolution(width, aspect, fov) == j_snap(width, aspect, fov)
    w, h, _ = snap_resolution(width, aspect, fov)
    assert w in RES_LADDER and h % 16 == 0


@pytest.mark.parametrize("fast", [False, True])
def test_pushed_frame_matches_jax(fast):
    js, ts = _splatters()
    values = {"Resolution": RES, "Fast Mode (bf16)": fast}
    srv, ti = _frame(run_viewer, ts, values=values)
    _, ji = _frame(j_run_viewer, js, values=values)
    w, h, _ = snap_resolution(RES, 1.5, 1.0)
    assert ti.shape == ji.shape == (h, w, 3) and ti.dtype == np.float32
    assert ti.max() > 0.1
    # f32: the render parity bound; Fast Mode: the preset's (measured 3e-7
    # at the preset test's size)
    np.testing.assert_allclose(ti, ji, atol=1e-5 if fast else 1e-4)
    assert set(CONTROLS) <= set(srv.controls)
    assert float(srv.controls["FPS"].value) > 0
    # the pushed frame is render_offscreen's of the same camera
    fov = snap_resolution(RES, 1.5, 1.0)[2]
    f = (w / 2 / np.tan(fov / 2), h / 2 / np.tan(fov / 2))
    ref = render_offscreen(ts, camera_to_w2c(srv.client.camera.wxyz,
                                             srv.client.camera.position),
                           w, h, *f, near=0.3, far=1000.0, sh_order=3,
                           fast=fast)
    np.testing.assert_array_equal(ti, ref)


def test_render_offscreen_near_far_and_device_out():
    # tests/test_viewer.py:42-64, on both packages
    js, ts = _splatters()
    g = ts.cameras.grid
    w2c = np.eye(4, dtype=np.float32)
    args = (w2c, g.width, g.height, g.focal_x, g.focal_y)
    base = render_offscreen(ts, *args, fast=False)
    np.testing.assert_allclose(base, j_offscreen(js, *args, fast=False),
                               atol=1e-4)
    assert base.shape == (g.height, g.width, 3) and base.sum() > 0
    for kw in ({"far": 1e-3}, {"near": 1e6}):
        np.testing.assert_array_equal(render_offscreen(ts, *args, **kw), 0.0)
        np.testing.assert_array_equal(j_offscreen(js, *args, **kw), 0.0)
    same = render_offscreen(ts, *args, near=ts.cfg.near, far=1e9, fast=False)
    np.testing.assert_allclose(same, base, atol=1e-6)
    dev = render_offscreen(ts, *args, fast=False, device_out=True)
    assert isinstance(dev, torch.Tensor) and dev.shape == (3, g.height,
                                                           g.width)
    np.testing.assert_array_equal(dev.permute(1, 2, 0).numpy(), base)


@pytest.mark.parametrize("values", [{"Far": 1e-3}, {"Near": 1e6}])
def test_near_far_sliders_cull_the_frame(values):
    js, ts = _splatters()
    values = dict(values, Resolution=RES)
    for run, splat in ((run_viewer, ts), (j_run_viewer, js)):
        _, img = _frame(run, splat, values=values)
        np.testing.assert_array_equal(img, 0.0)


def test_sh_order_slider_matches_jax():
    # tests/test_viewer.py:67-90 through the slider: order 1 keeps the DC
    # band, order 3 (the default) all nine
    js, ts = _splatters(use_sh=True)
    frames = {}
    for order in (1, 3):
        values = {"Resolution": RES, "SH Order": order}
        _, frames[order] = _frame(run_viewer, ts, values=values)
        _, ji = _frame(j_run_viewer, js, values=values)
        np.testing.assert_allclose(frames[order], ji, atol=1e-4,
                                   err_msg=str(order))
    assert np.abs(frames[3] - frames[1]).max() > 1e-3


def test_frames_follow_the_camera_in_order():
    # a client dragging through 3 poses: 3 frames, the i-th pushed is the
    # i-th pose's (the double buffer pushes each frame after the next one's
    # render is queued, and the last when the loop ends)
    _, ts = _splatters()
    rng = np.random.default_rng(0)
    poses = []
    for _ in range(3):
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, 3] = rng.normal(0, 0.2, 3)
        poses.append(c2w_pose(w2c))
    srv = FakeServer(values={"Resolution": RES}, poses=poses)
    run_viewer(ts, server=srv, max_iters=3)
    assert len(srv.client.images) == 3
    w, h, fov = snap_resolution(RES, 1.5, 1.0)
    f = (w / 2 / np.tan(fov / 2), h / 2 / np.tan(fov / 2))
    refs = [render_offscreen(ts, camera_to_w2c(*p), w, h, *f, near=0.3,
                             far=1000.0, sh_order=3) for p in poses]
    for img, ref in zip(srv.client.images, refs):
        np.testing.assert_array_equal(img, ref)
    assert np.abs(refs[0] - refs[1]).max() > 0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_scene(d, n_points=100, n_cameras=9, w=64, h=48)
    return d


def _paths(scene):
    return os.path.join(scene, "sparse", "0"), os.path.join(scene,
                                                            "images_4")


def _trainers(scene):
    kw = dict(n_iters_test=0, n_save_train_img=0, seed=1)
    jt = JTrainer(JSplatter(*_paths(scene), JCfg(
        plane_mode="dense", use_pallas=False, capacity_round=128,
        max_tiles_per_gaussian=12)), JTCfg(**kw))
    tt = Trainer(TSplatter(*_paths(scene), TCfg(
        capacity_round=128, max_tiles_per_gaussian=12), device="cpu"),
        TTCfg(**kw))
    return jt, tt


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_live_training_matches_jax(scene):
    jt, tt = _trainers(scene)
    values = {"Resolution": RES}
    j_run_viewer(jt.splat, server=FakeServer(values=values), trainer=jt,
                 max_iters=2)
    srv = FakeServer(values=values)
    run_viewer(tt.splat, server=srv, trainer=tt, max_iters=2)
    period = int(srv.controls["Train Viewer Update Period"].value)
    assert period == 10 and tt._gui_iter == jt._gui_iter == 2 * period
    # one frame a loop iteration, after that iteration's training
    assert len(srv.client.images) == 2
    # the last step's l1 (JAX's window reports its last step's losses)
    np.testing.assert_allclose(float(tt._last_metrics["l1"]),
                               float(jt._last_metrics["l1"]), rtol=1e-4)
    for k in GROUP_ORDER:
        assert _rel_l2(tt.state.params[k], jt.state.params[k]) < 1e-4, k
        # the table the viewer renders is the trained one
        assert torch.equal(getattr(tt.splat.table, k), tt.state.params[k])


class _PausingServer(FakeServer):
    """Clicks Pause Training the first time the viewer asks for clients,
    after the first iteration's training."""

    def get_clients(self):
        if not getattr(self, "_clicked", False):
            self._clicked = True
            self.controls["Pause Training"].fire()
        return super().get_clients()


def test_pause_and_reset_view(scene):
    # tests/test_viewer.py:197-240: Reset View sets the up direction from
    # the camera's orientation; Pause toggles its label and the period
    # slider, and gates the training loop
    _, tt = _trainers(scene)
    srv = _PausingServer(values={"Resolution": RES})
    run_viewer(tt.splat, server=srv, trainer=tt, max_iters=3)
    assert tt._gui_iter == 10                  # trained once, then paused
    assert srv.controls["Pause Training"].name == "Resume Training"
    assert srv.controls["Train Viewer Update Period"].disabled is False
    srv.controls["Pause Training"].fire()
    assert srv.controls["Pause Training"].name == "Pause Training"
    assert srv.controls["Train Viewer Update Period"].disabled is True
    srv.controls["Reset View"].fire()
    np.testing.assert_allclose(srv.client.camera.up_direction,
                               [0.0, -1.0, 0.0], atol=1e-6)
    srv2 = FakeServer()
    run_viewer(tt.splat, server=srv2, trainer=tt, max_iters=0)
    assert not srv2.client.images and tt._gui_iter == 10


def test_without_viser_exits_naming_it(monkeypatch):
    _, ts = _splatters()
    monkeypatch.setitem(sys.modules, "viser", None)
    with pytest.raises(SystemExit, match="viser"):
        run_viewer(ts, max_iters=1)
