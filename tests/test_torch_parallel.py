"""Data-parallel training and band rendering, PyTorch port vs the JAX
package, on the CPU.

The port's ranks are processes with gloo (``tests/torch_dp_workers.py``,
spawned, meeting at a file store under ``tmp_path``); JAX's are 2 of the 8
virtual CPU devices the conftest makes.  The COLMAP fixture scene of
``tests/test_torch_trainer.py`` (100 points, 9 cameras, 64x48), JAX on its
dense plane (``use_pallas=False``):

- one data-parallel step on cameras 1 and 2 against JAX's
  ``make_dp_train_step`` on a 2-device mesh: params relative L2 1e-4, loss
  rtol 1e-5, for both accumulation methods;
- both ranks on camera 0: the one-device step, bit for bit (the mean of two
  equal gradients is exact);
- the Trainer with ``dp=2`` over iterations 601-620 with a densify event
  every 5 (capacity growth included): both ranks' states bit-identical;
- on ``tests/test_parallel.py``'s 64x64 scene (4 tile rows) at its
  settings (``:72-90``), 4 bands of camera 0 against JAX's
  ``make_tile_sharded_render`` and against the one-image render, atol 2e-4,
  RGB and SH; 2 bands gathered over the gloo group.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.models.splatter import render_padded as j_render_padded
from gsplat_tpu.parallel.data_parallel import (DPCameras, make_dp_train_step,
                                               replicate_state, shard_cameras)
from gsplat_tpu.parallel.mesh import make_mesh
from gsplat_tpu.parallel.tile_parallel import \
    make_tile_sharded_render as j_bands
from gsplat_tpu.train import TrainState, init_adam

from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.models.camera import TileGrid
from gsplat_tpu_torch.models.splatter import render_padded
from gsplat_tpu_torch.parallel.tile_parallel import (band_heights,
                                                     make_tile_sharded_render)
from gsplat_tpu_torch.train import GROUP_ORDER

from fixtures import make_scene
from torch_dp_workers import dp_session, load_splat, run_ranks

torch.set_num_threads(1)
CAMS, LR = (1, 2), 0.01
STEPS = range(601, 621)
TRAINER_KW = dict(n_iters_test=0, n_save_train_img=0, n_adaptive_control=5,
                  grad_thresh=1e-7, split_thresh=0.225, use_clone=True,
                  use_split=True, seed=1)
# tiny culling threshold: the band edges' bbox rounding then has no visible
# effect, so bands == one image to float tolerance
BAND_KW = dict(tile_culling_prob_thresh=1e-6, max_tiles_per_gaussian=64)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene"))
    make_scene(d, n_points=100, n_cameras=9, w=64, h=48)
    return d


@pytest.fixture(scope="module")
def scene8(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scene8"))
    make_scene(d, n_points=80, n_cameras=8, w=64, h=64)
    return d


@pytest.fixture(scope="module")
def ranks(scene, scene8, tmp_path_factory):
    return run_ranks(dp_session, 2, str(tmp_path_factory.mktemp("store")),
                     scene, CAMS, LR, TRAINER_KW, STEPS, scene8, BAND_KW)


def _j_splat(scene, **kw):
    kw = dict(dict(plane_mode="dense", use_pallas=False, capacity_round=128,
                   max_tiles_per_gaussian=12), **kw)
    return JSplatter(os.path.join(scene, "sparse", "0"),
                     os.path.join(scene, "images_4"), JCfg(**kw))


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _same_bits(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("method", ["max", "mean"])
def test_dp_step_matches_jax(ranks, scene, method):
    sp = _j_splat(scene)
    tcfg = JTCfg(grad_accum_method=method)
    mesh = make_mesh({"data": 2})
    bspec, rspec = sp.specs()
    step = make_dp_train_step(sp.cameras.grid, sp.cfg, tcfg, bspec, rspec,
                              mesh)
    idx = np.asarray(CAMS)
    c = sp.cameras
    cams = shard_cameras(DPCameras(
        w2c_rot=c.w2c_rot[idx], w2c_tran=c.w2c_tran[idx],
        sh_vecs=c.sh_vecs[idx], images=c.images[idx]), mesh)
    params = jax.tree.map(jnp.copy, sp.table.params())
    state = replicate_state(TrainState(
        params=params, live=jnp.copy(sp.table.live), opt=init_adam(params),
        accum_grad=jnp.zeros_like(params["pos"]),
        grad_counter=jnp.zeros(sp.table.capacity, jnp.float32)), mesh)
    cam_local = jax.device_put(
        jnp.zeros((2,), jnp.int32),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data")))
    js, jm = step(state, cams, cam_local, jnp.full((5,), LR, jnp.float32))
    r0, r1 = (r[method] for r in ranks)
    _same_bits(r0["state"], r1["state"])       # replicas stay equal
    assert r0["loss"] == r1["loss"] and r0["counters"] == r1["counters"]
    np.testing.assert_allclose(r0["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(r0["l1"], float(jm["l1"]), rtol=1e-5)
    for k in GROUP_ORDER:
        # the train step's parity bound (tests/test_torch_train.py)
        assert _rel_l2(r0["state"][f"params.{k}"], js.params[k]) < 1e-4, k
    assert _rel_l2(r0["state"]["accum_grad"], js.accum_grad) < 1e-4
    # "mean" adds the ranks' mean visibility count, "max" sets ones
    np.testing.assert_array_equal(r0["state"]["grad_counter"],
                                  np.asarray(js.grad_counter))


def test_dp_step_counters_are_the_worst_ranks(ranks, scene):
    # the binning counters are the max over the ranks, the one-device
    # step's counters of the heavier camera
    from gsplat_tpu_torch.config import TrainConfig
    from gsplat_tpu_torch.train import init_train_state, make_train_step

    sp = load_splat(scene)
    st0 = init_train_state(sp.table.params(), sp.table.live)
    step = make_train_step(sp, TrainConfig())
    one = [step(st0, c, torch.full((5,), LR))[1] for c in CAMS]
    for k, v in ranks[0]["max"]["counters"].items():
        assert v == max(int(m[k]) for m in one), k
    assert ranks[0]["max"]["counters"]["n_pairs"] > 0


def test_dp_same_camera_is_the_one_device_step(ranks):
    _same_bits(ranks[0]["same_camera"], ranks[0]["one_device"])
    _same_bits(ranks[1]["same_camera"], ranks[0]["one_device"])


def test_dp_trainer_densifies_with_equal_replicas(ranks):
    r0, r1 = (r["trainer"] for r in ranks)
    assert r0["replicas_equal"] and r1["replicas_equal"]
    _same_bits(r0["state"], r1["state"])
    # 100 -> 200 overflows the 128 slots at 605: grown, run again
    assert r0["n_live"] == r1["n_live"] != r0["n_live0"]
    assert r0["capacity"] == r1["capacity"] > 128


@pytest.mark.parametrize("sh", [False, True])
def test_bands_match_jax_and_the_one_image(scene8, sh):
    kw = dict(BAND_KW, use_sh_coeff=sh)
    jsp, tsp = _j_splat(scene8, **kw), load_splat(scene8, **kw)
    if sh:   # real energy in the higher bands, both packages
        rng = np.random.default_rng(0)
        rgb = np.asarray(jsp.table.rgb) + rng.normal(
            0, 0.5, jsp.table.rgb.shape).astype(np.float32)
        jsp.table = jsp.table._replace(rgb=jnp.asarray(rgb))
        tsp.table.rgb = torch.from_numpy(rgb)
    grid = tsp.cameras.grid
    c, jc = tsp.cameras, jsp.cameras
    view = (c.w2c_rot[0], c.w2c_tran[0], c.sh_vecs[0])
    bands = make_tile_sharded_render(grid, tsp.cfg, 4)(
        tsp.table.params(), tsp.table.live, *view)
    mesh = make_mesh({"sp": 4})          # 64 px: 4 tile rows, 4 bands
    jimg = j_bands(jsp.cameras.grid, jsp.cfg, jsp.table.capacity, mesh)(
        jsp.table.params(), jsp.table.live, jc.w2c_rot[0], jc.w2c_tran[0],
        jc.sh_vecs[0])
    assert bands.shape == (3, grid.padded_height, grid.padded_width)
    np.testing.assert_allclose(bands.numpy(), np.asarray(jimg), atol=2e-4)
    bspec, rspec = tsp.specs(grid)
    full, _ = render_padded(tsp.table.params(), tsp.table.live, *view[:2],
                            grid, tsp.cfg, bspec, rspec, view[2])
    np.testing.assert_allclose(bands.numpy(), full.numpy(), atol=2e-4)
    jb, jr = jsp.specs()
    jfull, _ = j_render_padded(jsp.table.params(), jsp.table.live,
                               jc.w2c_rot[0], jc.w2c_tran[0], jc.sh_vecs[0],
                               jsp.cameras.grid, jsp.cfg, jb, jr)
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull), atol=1e-4)
    assert float(full.max()) > 0.1


def test_bands_gathered_over_the_group(ranks, scene8):
    sp = load_splat(scene8, **BAND_KW)
    c = sp.cameras
    args = (sp.table.params(), sp.table.live, c.w2c_rot[0], c.w2c_tran[0])
    seq = make_tile_sharded_render(c.grid, sp.cfg, 2)(*args)
    bspec, rspec = sp.specs(c.grid)
    full, _ = render_padded(*args, c.grid, sp.cfg, bspec, rspec)
    for r in ranks:     # each rank's band, gathered on every rank
        np.testing.assert_array_equal(r["bands"], seq.numpy())
    np.testing.assert_allclose(seq.numpy(), full.numpy(), atol=2e-4)


@pytest.mark.parametrize("height,n_bands,names", [
    (48, 2, ("32", "64")), (840, 4, ("832", "896")), (20, 4, ("64",))])
def test_bands_that_do_not_divide_raise(height, n_bands, names):
    grid = TileGrid(width=64, height=height, focal_x=60.0, focal_y=60.0)
    with pytest.raises(ValueError, match=f"{n_bands} bands") as e:
        make_tile_sharded_render(grid, TCfg(), n_bands)
    for h in names:
        assert f"height {h}" in str(e.value) or f" or {h}" in str(e.value)
    lo, hi = band_heights(grid, n_bands)
    for h in (lo, hi):
        if h:
            ok = TileGrid(width=64, height=h, focal_x=60.0, focal_y=60.0)
            make_tile_sharded_render(ok, TCfg(), n_bands)
