"""PyTorch port vs the JAX package: config, camera geometry, rotations,
COLMAP readers, table init and checkpoints; and the port's import hygiene."""

import dataclasses
import os
import subprocess
import sys

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import config as jcfg
from gsplat_tpu.models import camera as jcam
from gsplat_tpu.models.gaussians import init_from_points as j_init
from gsplat_tpu.utils import checkpoint as jckpt
from gsplat_tpu.utils import colmap as jcolmap
from gsplat_tpu.utils.so3 import quat_to_rotmat as j_q2r
from gsplat_tpu.utils.so3 import quat_to_rotmat_np as j_q2r_np

from gsplat_tpu_torch import config as tcfg
from gsplat_tpu_torch.models import camera as tcam
from gsplat_tpu_torch.models.gaussians import init_from_points as t_init
from gsplat_tpu_torch.utils import checkpoint as tckpt
from gsplat_tpu_torch.utils import colmap as tcolmap
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat as t_q2r
from gsplat_tpu_torch.utils.so3 import quat_to_rotmat_np as t_q2r_np

from fixtures import write_cameras_bin, write_images_bin, write_points3d_bin

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLE_KEYS = ("pos", "rgb", "opa", "quat", "scale", "live")


@pytest.mark.parametrize("cls", ["SplatConfig", "TrainConfig"])
def test_config_fields_subset_with_equal_defaults(cls):
    tf = {f.name: f for f in dataclasses.fields(getattr(tcfg, cls))}
    jf = {f.name: f for f in dataclasses.fields(getattr(jcfg, cls))}
    assert set(tf) <= set(jf), set(tf) - set(jf)
    if cls == "SplatConfig":    # the densification and K-growth bounds
        assert {"max_capacity", "max_tiles_cap", "max_plane_rows"} <= set(tf)
    tdef, jdef = getattr(tcfg, cls)(), getattr(jcfg, cls)()
    for name in tf:
        assert getattr(tdef, name) == getattr(jdef, name), name


def test_train_config_schedule_matches():
    for decay in ("none", "official", "exp"):
        t = tcfg.TrainConfig(n_iters=5000, lr_decay=decay)
        j = jcfg.TrainConfig(n_iters=5000, lr_decay=decay)
        assert t.group_lrs() == j.group_lrs()
        for group in ("opa", "rgb", "pos", "scale", "quat"):
            for it in (0, 150, 300, 301, 2500, 4999):
                assert t.lr_lambda(group, it) == j.lr_lambda(group, it)


@pytest.mark.parametrize("w,h,fx,fy,th,tw", [
    (1297, 840, 1000.0, 1000.0, 16, 16),
    (1024, 656, 789.5, 789.5, 16, 16),
    (97, 61, 80.0, 75.5, 16, 8),
])
def test_tile_grid_and_ray_info_match(w, h, fx, fy, th, tw):
    tg = tcam.TileGrid(w, h, fx, fy, th, tw)
    jg = jcam.TileGrid(w, h, fx, fy, th, tw)
    for prop in ("padded_width", "padded_height", "n_tile_x", "n_tile_y",
                 "n_tiles", "tile_geo_length_x", "tile_geo_length_y",
                 "leftmost", "topmost", "crop_top", "crop_left"):
        assert getattr(tg, prop) == getattr(jg, prop), prop
    img = np.random.default_rng(0).uniform(size=(h, w, 3)).astype(np.float32)
    np.testing.assert_array_equal(tg.crop(tg.pad_gt(img)), img)
    np.testing.assert_array_equal(tg.pad_gt(img), jg.pad_gt(img))
    rng = np.random.default_rng(1)
    rot = j_q2r_np(rng.normal(size=4))
    tran = rng.normal(size=3)
    a = tcam.ray_info(rot, tran, tg.padded_height, tg.padded_width, fx, fy)
    b = jcam.ray_info(rot, tran, jg.padded_height, jg.padded_width, fx, fy)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_quat_to_rotmat_matches():
    q = np.random.default_rng(2).normal(size=(64, 4)).astype(np.float32)
    np.testing.assert_allclose(t_q2r(torch.from_numpy(q)).numpy(),
                               np.asarray(j_q2r(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-6)
    for row in q[:4]:
        np.testing.assert_array_equal(t_q2r_np(row), j_q2r_np(row))


def _write_sparse(tmp_path, n=50):
    rng = np.random.default_rng(3)
    xyz = rng.uniform(-1, 1, (n, 3)) + [0, 0, 3]
    rgb = rng.integers(0, 255, (n, 3)).astype(np.uint8)
    write_cameras_bin(str(tmp_path / "cameras.bin"), 1, 64, 48, 60.0, 61.0)
    poses = [(np.array([1.0, 0, 0, 0]), np.array([0.1 * i, 0, 0]),
              f"im{i}.png") for i in range(3)]
    write_images_bin(str(tmp_path / "images.bin"), poses, 1)
    write_points3d_bin(str(tmp_path / "points3D.bin"), xyz, rgb)
    return xyz, rgb


def test_colmap_readers_match(tmp_path):
    xyz, rgb = _write_sparse(tmp_path)
    cams_t = tcolmap.read_cameras_binary(tmp_path / "cameras.bin")
    cams_j = jcolmap.read_cameras_binary(tmp_path / "cameras.bin")
    assert cams_t.keys() == cams_j.keys()
    for k in cams_t:
        np.testing.assert_array_equal(cams_t[k].params, cams_j[k].params)
        assert tcolmap.camera_focals(cams_t[k]) == \
            jcolmap.camera_focals(cams_j[k])
    ims_t = tcolmap.read_images_binary(tmp_path / "images.bin")
    ims_j = jcolmap.read_images_binary(tmp_path / "images.bin")
    assert [i.name for i in ims_t.values()] == \
        [i.name for i in ims_j.values()]
    pos_t, rgb_t = tcolmap.read_points3d_arrays(tmp_path / "points3D.bin")
    pos_j, rgb_j = jcolmap.read_points3d_arrays(tmp_path / "points3D.bin")
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(rgb_t, rgb)
    pts = tcolmap.read_points3d_binary(tmp_path / "points3D.bin")
    np.testing.assert_allclose(np.stack([p.xyz for p in pts.values()]), xyz)


@pytest.mark.parametrize("act", ["abs", "exp"])
def test_init_from_points_matches(act):
    rng = np.random.default_rng(4)
    pts = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (300, 3)).astype(np.uint8)
    kw = dict(opa_init_value=0.4, scale_init_value=0.7,
              scale_activation=act, capacity_round=128)
    t = t_init(pts, rgb, device="cpu", **kw)
    j = j_init(pts, rgb, **kw)
    assert t.n_live == int(j.n_live) and t.capacity == j.capacity
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    # SH: the color logits become the DC terms of 27 coefficients
    t = t_init(pts, rgb, use_sh_coeff=True, device="cpu", **kw)
    j = j_init(pts, rgb, use_sh_coeff=True, **kw)
    assert t.rgb.shape == (t.capacity, 27)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)


@pytest.mark.parametrize("ext", [".npz", ".pth"])
def test_checkpoints_cross_load(tmp_path, ext):
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1, 1, (200, 3)).astype(np.float32)
    rgb = rng.integers(0, 255, (200, 3)).astype(np.uint8)
    jt = j_init(pts, rgb, capacity_round=128)
    jt = jt._replace(opa=jt.opa + jnp.asarray(rng.normal(size=jt.opa.shape),
                                              jnp.float32))
    # JAX writes, the port reads
    jpath = str(tmp_path / f"j{ext}")
    jckpt.save_checkpoint(jt, jpath)
    t = tckpt.load_checkpoint(jpath, capacity_round=128, device="cpu")
    ref = jckpt.load_checkpoint(jpath, capacity_round=128)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    # the port writes, JAX reads
    tpath = str(tmp_path / f"t{ext}")
    tckpt.save_checkpoint(t, tpath)
    back = jckpt.load_checkpoint(tpath, capacity_round=128)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    # and JAX's in-memory table carries across unchanged
    t2 = tckpt.table_from_jax_arrays(
        {k: np.asarray(getattr(jt, k)) for k in TABLE_KEYS + ("n_live",)},
        device="cpu")
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t2, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)
    assert t2.n_live == int(jt.n_live)


def test_import_leaves_jax_unloaded():
    code = (
        "import sys, pkgutil, importlib, gsplat_tpu_torch\n"
        "for m in pkgutil.walk_packages(gsplat_tpu_torch.__path__,"
        " 'gsplat_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or"
        " m.startswith('jax.') or m == 'gsplat_tpu' or"
        " m.startswith('gsplat_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
