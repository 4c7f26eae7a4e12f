"""Real-capture ingestion in the port against the JAX package
(``tests/test_real_capture.py``): the JPG scene of
``fixtures.make_real_capture_scene`` (a SIMPLE_RADIAL and a PINHOLE camera,
lossy JPEGs at quality 92) loaded by JAX through cv2 and by the port with
``cv2`` made unimportable.  Camera groups, focals and every image must match
bit for bit; a short train must match within the Trainer parity tolerances
of PERF.md §2.
"""

import sys
from unittest import mock

import numpy as np
import pytest
import torch

from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.train import Trainer as JTrainer

from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.config import TrainConfig as TTCfg
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.train import GROUP_ORDER, Trainer

from fixtures import make_real_capture_scene

TKW = dict(ssim_weight=0.1, n_iters_warmup=3, n_iters_test=0,
           n_save_train_img=0, seed=1)
N_STEPS = 12


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("capture")
    make_real_capture_scene(str(root))
    paths = (str(root / "sparse" / "0"), str(root / "images_1"))
    jsplat = JSplatter(*paths, JCfg(plane_mode="dense", use_pallas=False,
                                    capacity_round=256,
                                    render_downsample=1))
    with mock.patch.dict(sys.modules, {"cv2": None}):
        tsplat = TSplatter(*paths, TCfg(capacity_round=256,
                                        render_downsample=1), device="cpu")
    return jsplat, tsplat, root


def _same_groups(jgroups, tgroups):
    assert len(tgroups) == len(jgroups)
    for jg, tg in zip(jgroups, tgroups):
        assert (tg.grid.width, tg.grid.height, tg.n_cameras) == \
            (jg.grid.width, jg.grid.height, jg.n_cameras)
        assert (tg.grid.focal_x, tg.grid.focal_y) == \
            (jg.grid.focal_x, jg.grid.focal_y)
        assert tg.names == list(jg.names)
        np.testing.assert_array_equal(tg.images.numpy(),
                                      np.asarray(jg.images))


def test_jpg_scene_loads_as_jax_loads_it(capture):
    jsplat, tsplat, _ = capture
    assert len(tsplat.camera_groups) == 2
    _same_groups(jsplat.camera_groups, tsplat.camera_groups)
    for jg, tg in zip(jsplat.camera_groups, tsplat.camera_groups):
        np.testing.assert_array_equal(tg.w2c_rot.numpy(),
                                      np.asarray(jg.w2c_rot))
    big = next(g for g in tsplat.camera_groups if g.grid.width == 96)
    assert big.grid.focal_x == big.grid.focal_y == pytest.approx(70.0)
    assert (big.grid.width, big.grid.height, big.n_cameras) == (96, 64, 4)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_jpg_scene_short_train_matches_jax(capture):
    jsplat, tsplat, _ = capture
    jt, tt = JTrainer(jsplat, JTCfg(**TKW)), Trainer(tsplat, TTCfg(**TKW))
    l1 = np.array([(float(jt.train_step(i)["l1"]),
                    float(tt.train_step(i)["l1"])) for i in range(N_STEPS)])
    # PERF.md §2's Trainer parity: l1 rtol 1e-4, params rel L2 1e-4
    np.testing.assert_allclose(l1[:, 1], l1[:, 0], rtol=1e-4)
    assert l1[-1, 1] < l1[0, 1]
    for k in GROUP_ORDER:
        assert _rel_l2(tt.state.params[k], jt.state.params[k]) < 1e-4, k
    jev, tev = jt.evaluate(), tt.evaluate()
    assert np.isfinite(tev["psnr"]) and tev["psnr"] > 10
    assert tev["psnr"] == pytest.approx(float(jev["psnr"]), abs=1e-3)


def test_jpg_pyramid_switch_and_cli(capture, tmp_path, capsys):
    # the port's downsample writes images_2 and images_4 as JPEGs; the
    # pyramid switch reads images_2 as JAX reads it, and the CLI trains
    # from images_4, all without cv2
    from gsplat_tpu_torch.downsample import main as downsample
    from gsplat_tpu_torch.train import main as train_main

    _, _, root = capture
    paths = (str(root / "sparse" / "0"), str(root / "images_1"))
    with mock.patch.dict(sys.modules, {"cv2": None}):
        for f in (2, 4):
            downsample(["--src", paths[1], "--dst", str(root / f"images_{f}"),
                        "--factor", str(f)])
        tsplat = TSplatter(*paths, TCfg(capacity_round=256,
                                        render_downsample=1), device="cpu")
        tsplat.switch_resolution(2)
    jsplat = JSplatter(*paths, JCfg(plane_mode="dense", use_pallas=False,
                                    capacity_round=256, render_downsample=1))
    jsplat.switch_resolution(2)
    _same_groups(jsplat.camera_groups, tsplat.camera_groups)
    assert sorted((g.grid.width, g.grid.height)
                  for g in tsplat.camera_groups) == [(32, 24), (48, 32)]
    capsys.readouterr()
    with mock.patch.dict(sys.modules, {"cv2": None}):
        train_main(["--data", str(root), "--n_iters", "6",
                    "--n_iters_warmup", "3", "--n_iters_test", "5",
                    "--exp", str(tmp_path / "exp"), "--metrics_every", "5",
                    "--capacity_round", "256", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "TEST @5:" in out, out
    assert (tmp_path / "exp" / "ckpt.npz").exists()
