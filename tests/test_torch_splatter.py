"""The slice's entry points, PyTorch port vs the JAX package, on a COLMAP
scene: ``Splatter.render`` from a checkpoint JAX wrote, the evaluation step
(image, PSNR, SSIM) and ``render_offscreen`` with near/far culling.  JAX
renders through its jnp compositor on the dense plane; images agree within
atol 1e-4.
"""

import os

import numpy as np
import pytest
import torch

from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.train import make_eval_step as j_eval_step
from gsplat_tpu.utils.checkpoint import save_checkpoint as j_save
from gsplat_tpu.viewer import camera_to_w2c as j_cam_to_w2c
from gsplat_tpu.viewer import render_offscreen as j_offscreen

from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.models.splatter import render_cropped as t_render_cropped
from gsplat_tpu_torch.train import make_eval_step as t_eval_step
from gsplat_tpu_torch.viewer import camera_to_w2c as t_cam_to_w2c
from gsplat_tpu_torch.viewer import render_offscreen as t_offscreen

from fixtures import make_scene

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def splats(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scene"))
    make_scene(root, n_points=150, n_cameras=3, w=64, h=48)
    colmap, images = os.path.join(root, "sparse", "0"), \
        os.path.join(root, "images_4")
    jcfg = JCfg(plane_mode="dense", use_pallas=False, capacity_round=256,
                opa_init_value=0.6, scale_init_value=0.5)
    # a trained-looking table: perturb the init, then let JAX checkpoint it
    init = JSplatter(colmap, images, jcfg)
    rng = np.random.default_rng(0)
    tbl = init.table
    tbl = tbl._replace(
        opa=tbl.opa + rng.normal(0, 0.5, tbl.opa.shape).astype(np.float32),
        rgb=tbl.rgb + rng.normal(0, 0.3, tbl.rgb.shape).astype(np.float32),
        quat=tbl.quat + rng.normal(0, 0.3, tbl.quat.shape).astype(np.float32))
    ckpt = os.path.join(root, "ckpt.npz")
    j_save(tbl, ckpt)
    js = JSplatter(colmap, images, jcfg, load_ckpt=ckpt)
    ts = TSplatter(colmap, images, TCfg(capacity_round=256), load_ckpt=ckpt)
    return js, ts


def test_splatter_render_matches_jax(splats):
    js, ts = splats
    assert ts.table.n_live == int(js.table.n_live)
    for cam in range(js.cameras.n_cameras):
        ji = np.asarray(js.render(cam, interpret=False))
        ti = ts.render(cam)
        assert ti.shape == (3, 48, 64)
        np.testing.assert_allclose(ti.numpy(), ji, atol=1e-4)
        assert ti.min() >= 0 and ti.max() <= 1
    np.testing.assert_array_equal(ts.ground_truth(1).numpy(),
                                  np.asarray(js.ground_truth(1)))


def test_eval_step_matches_jax(splats):
    js, ts = splats
    jstep, tstep = j_eval_step(js), t_eval_step(ts)
    for cam in range(js.cameras.n_cameras):
        ji, jp, jss = jstep(js.table.params(), js.table.live, cam)
        ti, tp, tss = tstep(ts.table.params(), ts.table.live, cam)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
        np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
        np.testing.assert_allclose(float(tss), float(jss), rtol=1e-5)


def test_render_offscreen_matches_jax(splats):
    js, ts = splats
    w2c = t_cam_to_w2c(np.array([0.99, 0.05, -0.08, 0.02]),
                       np.array([0.1, -0.05, -0.2]))
    np.testing.assert_array_equal(
        w2c, j_cam_to_w2c(np.array([0.99, 0.05, -0.08, 0.02]),
                          np.array([0.1, -0.05, -0.2])))
    for (w, h, f), clip in [((80, 56, 70.0), {}),
                            ((48, 40, 45.0), {"near": 2.9}),
                            ((64, 48, 60.0), {"far": 3.2})]:
        ji = j_offscreen(js, w2c, w, h, f, f, fast=False, **clip)
        ti = t_offscreen(ts, w2c, w, h, f, f, fast=False, **clip)
        assert ti.shape == (h, w, 3)
        np.testing.assert_allclose(ti, ji, atol=1e-4)
    full = t_offscreen(ts, w2c, 64, 48, 60.0, 60.0, fast=False)
    culled = t_offscreen(ts, w2c, 64, 48, 60.0, 60.0, fast=False, far=3.2)
    assert np.abs(full - culled).max() > 0.05   # far really culls


def test_render_offscreen_preset_raises(splats):
    # fast=True and the default (cfg.fast_drawing) render the bf16 preset,
    # close to the f32 route; training through the preset raises
    _, ts = splats
    w2c = t_cam_to_w2c(np.array([0.99, 0.05, -0.08, 0.02]),
                       np.array([0.1, -0.05, -0.2]))
    f32 = t_offscreen(ts, w2c, 64, 48, 60.0, 60.0, fast=False)
    for fast in (True, None):   # None resolves to cfg.fast_drawing (True)
        img = t_offscreen(ts, w2c, 64, 48, 60.0, 60.0, fast=fast)
        assert img.shape == (48, 64, 3) and np.abs(img - f32).max() > 0
        mse = float(((img - f32) ** 2).mean())
        assert 10 * np.log10(1.0 / mse) > 40     # test_fused_pack.py:290
    grid = ts.cameras.grid
    bspec, rspec = ts.specs(grid)
    params = {k: v.clone().requires_grad_() for k, v in
              ts.table.params().items()}
    img, _ = t_render_cropped(params, ts.table.live, ts.cameras.w2c_rot[0],
                              ts.cameras.w2c_tran[0], grid, ts.cfg, bspec,
                              rspec, preset=True)
    with pytest.raises(NotImplementedError, match="render-only"):
        img.sum().backward()
