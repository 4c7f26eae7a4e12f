"""SH color (27 coefficients), PyTorch port vs the JAX package, on the CPU.

The basis and the DC-only init first; then the SH compositor: the port's
plain forward (``composite_tiles_torch``) against JAX's
``composite_chunks_jnp`` and ``composite_chunks_pallas`` (interpret mode) on
the same gaussians, with a tile of more than 256 pairs, an empty tile and a
near-opaque case; the plain backward against autograd and against
``jax.grad`` through JAX's jnp compositor (JAX's own Pallas-interpret SH
backward test is marked slow, ``tests/test_rasterize.py:113-141``); then the
slice: ``render_cropped`` on a synthetic SH table (JAX on its dense f32
route), and 1 and 3 ``make_train_step`` steps against JAX's jnp route, with
the tolerances of ``test_torch_train.py``; and checkpoints with a 27-wide
``rgb``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import synthetic as jsyn
from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.config import TrainConfig as JTCfg
from gsplat_tpu.models.splatter import SceneCameras as JCams
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.models.splatter import make_specs as j_specs
from gsplat_tpu.models.splatter import render_cropped as j_render
from gsplat_tpu.ops import sh as jsh
from gsplat_tpu.ops.binning import BinningSpec as JSpec
from gsplat_tpu.ops.binning import pack_sorted as j_pack
from gsplat_tpu.ops.rasterize import RasterSpec as JRSpec
from gsplat_tpu.ops.rasterize import (composite_chunks_jnp,
                                      composite_chunks_pallas)
from gsplat_tpu.ops.rasterize import rasterize as j_rasterize
from gsplat_tpu.ops.rasterize_ref import rasterize_oracle as j_oracle
from gsplat_tpu.train import TrainState as JState
from gsplat_tpu.train import init_adam as j_init_adam
from gsplat_tpu.train import make_eval_step as j_eval_step
from gsplat_tpu.train import make_train_step as j_train_step
from gsplat_tpu.utils import checkpoint as jckpt

from gsplat_tpu_torch import synthetic as tsyn
from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.config import TrainConfig as TTCfg
from gsplat_tpu_torch.models.splatter import SceneCameras as TCams
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.models.splatter import make_specs as t_specs
from gsplat_tpu_torch.models.splatter import render_cropped as t_render
from gsplat_tpu_torch.ops import sh as tsh
from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
from gsplat_tpu_torch.ops.binning import pack_sorted as t_pack
from gsplat_tpu_torch.ops.rasterize import RasterSpec as TRSpec
from gsplat_tpu_torch.ops.rasterize import (LAUNCHES, composite_tiles,
                                            composite_tiles_bwd_torch,
                                            composite_tiles_torch, rasterize)
from gsplat_tpu_torch.ops.rasterize_ref import rasterize_oracle as t_oracle
from gsplat_tpu_torch.synthetic import image_space_sh
from gsplat_tpu_torch.train import GROUP_ORDER, make_eval_step, \
    make_train_step
from gsplat_tpu_torch.utils import checkpoint as tckpt

from torch_helpers import (BIG_CROWD, TILE, assert_close_cols,
                           image_space_pairs)

torch.set_num_threads(1)
FOCAL = 40.0
K = 6
N, W, H, SCENE_FOCAL = 2000, 96, 64, 80.0   # the scene of test_torch_train
SH_AMPL = 0.35                    # scripts/make_synth_scene.py:52
TABLE_KEYS = ("pos", "rgb", "opa", "quat", "scale", "live")
LR = 1e-3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _rel_l2(a, b):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


# ---- the basis and the init -------------------------------------------------

def test_sh_basis_and_init_match_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(500, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = tsh.sh_basis(torch.from_numpy(d)).numpy()
    j = np.asarray(jsh.sh_basis(jnp.asarray(d)))
    assert t.shape == (500, 9)
    # the same f32 expressions: equal to a float ulp
    np.testing.assert_allclose(t, j, rtol=2e-7, atol=1e-7)
    logits = rng.normal(0, 2, (300, 3)).astype(np.float32)
    ti = tsh.initialize_sh(torch.from_numpy(logits)).numpy()
    ji = np.asarray(jsh.initialize_sh(jnp.asarray(logits)))
    assert ti.shape == (300, 27)
    np.testing.assert_allclose(ti, ji, rtol=2e-7, atol=0)
    assert (ti.reshape(300, 3, 9)[:, :, 1:] == 0).all()
    assert (tsh.SH_DIM, tsh.C0, tsh.C1, tsh.C2) == (jsh.SH_DIM, jsh.C0,
                                                     jsh.C1, jsh.C2)


# ---- the compositor ---------------------------------------------------------

def _scene(seed, opaque, **kw):
    geom, color, depth, visible, geo = image_space_pairs(seed, focal=FOCAL,
                                                         **kw)
    if opaque:
        # near-opaque: transmittance falls below 1e-4 within a few layers
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    coef, shv = image_space_sh(seed, color, geo, FOCAL)
    return geom, coef, depth, visible, geo, shv


def _specs(geo, wn=False):
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 weight_normalize=wn, color_dim=27)
    jrs = JRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 128, 27, weight_normalize=wn, channel_major=True)
    return n_tiles, trs, jrs


def _jspec(geo, n):
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    return JSpec(**geo, max_tiles_per_gaussian=K,
                 slot_capacity=(n * K // 128 + n_tiles + 1) * 128,
                 chunk_size=128)


@pytest.mark.parametrize("opaque", [False, True])
def test_sh_forward_matches_jax(opaque):
    geom, coef, depth, visible, geo, shv = _scene(0, opaque, **BIG_CROWD)
    n_tiles, trs, jrs = _specs(geo)
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K),
                    *map(torch.from_numpy, (geom, coef, depth, visible)))
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 256 and (counts == 0).any()
    tshv = torch.from_numpy(shv)
    out = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                trs, tshv).numpy()

    jpk, meta = j_pack(_jspec(geo, geom.shape[0]),
                       *map(jnp.asarray, (geom, coef, depth, visible)))
    ok = np.asarray(meta.tile_ok)[:n_tiles]
    col_j, w_j = composite_chunks_jnp(jpk, meta.chunk_tile, meta.chunk_first,
                                      meta.chunk_len, jrs,
                                      sh_vecs=jnp.asarray(shv))
    col_p, w_p = composite_chunks_pallas(
        jpk, meta.chunk_tile, meta.chunk_first, meta.chunk_last,
        meta.chunk_len, jrs, sh_vecs=jnp.asarray(shv), interpret=True,
        tile_ok=meta.tile_ok)
    for col, w in ((col_j, w_j), (col_p, w_p)):
        col = np.where(ok[:, None, None], np.asarray(col)[:n_tiles, :3], 0.0)
        w = np.where(ok[:, None], np.asarray(w)[:n_tiles], 0.0)
        # only the summation order differs (measured <= 5e-7)
        np.testing.assert_allclose(out[:, :3], col, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out[:, 3], w, atol=1e-5, rtol=1e-5)
    img_t = rasterize(packed, trs, tshv).numpy()
    img_j = np.asarray(j_rasterize(jpk, meta, jrs, sh_vecs=jnp.asarray(shv),
                                   use_pallas=False))
    np.testing.assert_allclose(img_t, img_j, atol=1e-4)
    assert (out[counts == 0] == 0).all()
    if opaque:
        assert (out[:, 3] > 0.999).any(), "needs saturated pixels"


def test_sh_image_matches_oracles():
    # no wide splats and K = 15: nothing is clipped, so the tiled image is
    # the naive oracle's (test_torch_rasterize.py's bound, atol 2e-4)
    geom, coef, depth, visible, geo, shv = _scene(1, False, n_tile_x=5,
                                                  n=300, wide=False)
    visible[9] = False                    # the oracle has no det <= 0 guard
    _, trs, _ = _specs(geo)
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=15, thresh=1e-6),
                    *map(torch.from_numpy, (geom, coef, depth, visible)))
    assert int(packed.n_clipped) == 0
    img = rasterize(packed, trs, torch.from_numpy(shv)).numpy()
    idx = np.argsort(np.where(visible, depth, np.inf), kind="stable")
    idx = idx[visible[idx]]
    args = (geom[idx, :2], geom[idx, 2:6], geom[idx, 6], coef[idx])
    vecs = dict(zip(("rays_o", "lefttop", "dx", "dy"), shv))
    ref_t = t_oracle(*map(torch.from_numpy, args), trs.padded_h,
                     trs.padded_w, FOCAL, FOCAL,
                     sh_vecs={k: torch.from_numpy(v) for k, v in vecs.items()})
    ref_j = j_oracle(*map(jnp.asarray, args), trs.padded_h, trs.padded_w,
                     FOCAL, FOCAL,
                     sh_vecs={k: jnp.asarray(v) for k, v in vecs.items()})
    np.testing.assert_allclose(img, ref_t.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_sh_bwd_plain_matches_autograd(opaque, wn):
    geom, coef, depth, visible, geo, shv = _scene(0, opaque, **BIG_CROWD)
    _, trs, _ = _specs(geo)
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K),
                    *map(torch.from_numpy, (geom, coef, depth, visible)))
    tshv = torch.from_numpy(shv)
    g = packed.geom.clone().requires_grad_()
    c = packed.color.clone().requires_grad_()
    out = composite_tiles_torch(g, c, packed.tile_start, trs, tshv)
    go = np.random.default_rng(1).normal(size=tuple(out.shape)).astype(
        np.float32)
    if not wn:
        go[:, 3] = 0.0
    go = torch.from_numpy(go)
    ga, gca = torch.autograd.grad((out * go).sum(), [g, c])
    gb, gcb = composite_tiles_bwd_torch(packed.geom, packed.color,
                                        packed.tile_start, out.detach(), go,
                                        trs, tshv)
    assert gcb.shape == (packed.geom.shape[0], 27) and (gb[:, 7] == 0).all()
    # the bound of test_torch_rasterize_bwd.py's RGB case: the suffix
    # identity amplifies f32 rounding near alpha = 0.9999
    assert_close_cols(gb.numpy(), ga.numpy(), 1e-4, 1e-4, "grad_geom")
    assert_close_cols(gcb.numpy(), gca.numpy(), 1e-4, 1e-4, "grad_color")


@pytest.mark.parametrize("opaque,wn", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_sh_grads_match_jax(opaque, wn):
    geom, coef, depth, visible, geo, shv = _scene(3, opaque)
    _, trs, jrs = _specs(geo, wn)
    gkey = np.random.default_rng(2).normal(
        size=(3, trs.padded_h, trs.padded_w)).astype(np.float32)
    tg = torch.from_numpy(geom).requires_grad_()
    tc = torch.from_numpy(coef).requires_grad_()
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K), tg, tc,
                    torch.from_numpy(depth), torch.from_numpy(visible))
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 128 and (counts == 0).any()
    before = dict(LAUNCHES)
    (rasterize(packed, trs, torch.from_numpy(shv))
     * torch.from_numpy(gkey)).sum().backward()
    assert LAUNCHES == before                 # the plain route on the CPU
    jspec = _jspec(geo, geom.shape[0])

    def j_loss(g, c):
        jpk, meta = j_pack(jspec, g, c, jnp.asarray(depth),
                           jnp.asarray(visible))
        img = j_rasterize(jpk, meta, jrs, sh_vecs=jnp.asarray(shv),
                          use_pallas=False)
        return jnp.sum(img * gkey)

    jg, jc = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(geom),
                                                       jnp.asarray(coef))
    # per gaussian, the bound of tests/test_rasterize.py:96, its atol taken
    # relative to each column's largest gradient
    assert_close_cols(tg.grad.numpy(), jg, 3e-4, 2e-3, "geom")
    assert_close_cols(tc.grad.numpy(), jc, 3e-4, 2e-3, "sh coefficients")


def test_sh_wrapper_checks():
    spec = TRSpec(2, 1, TILE, TILE, FOCAL, FOCAL, color_dim=27)
    start = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="sh_vecs"):
        composite_tiles(torch.zeros(0, 8), torch.zeros(0, 27), start, spec)
    with pytest.raises(ValueError, match="sh_vecs"):
        composite_tiles(torch.zeros(0, 8), torch.zeros(0, 27), start, spec,
                        torch.zeros(3, 4))
    with pytest.raises(ValueError, match="color"):
        composite_tiles(torch.zeros(0, 8), torch.zeros(0, 3), start, spec,
                        torch.zeros(4, 3))
    with pytest.raises(ValueError, match="CPU tensors"):
        composite_tiles(torch.zeros(0, 8), torch.zeros(0, 27), start, spec,
                        torch.zeros(4, 3, device="meta"))
    out = composite_tiles(torch.zeros(0, 8), torch.zeros(0, 27), start, spec,
                          torch.zeros(4, 3))
    assert out.shape == (2, 4, 256) and (out == 0).all()


# ---- the slice ------------------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """One SH table and three cameras in both packages (bit-identical)."""
    jt = jsyn.synthetic_table(N, capacity_round=256, focal=SCENE_FOCAL,
                              scale_px=3.0, frustum=(0.85, 0.55),
                              use_sh=True, sh_ampl=SH_AMPL)
    jc = jsyn.synthetic_cameras(3, W, H, SCENE_FOCAL)
    tt = tsyn.synthetic_table(N, capacity_round=256, focal=SCENE_FOCAL,
                              scale_px=3.0, frustum=(0.85, 0.55),
                              use_sh=True, sh_ampl=SH_AMPL)
    tc = tsyn.synthetic_cameras(3, W, H, SCENE_FOCAL)
    return jt, jc, tt, tc


def test_sh_synthetic_table_bit_identical(scenes):
    jt, _, tt, _ = scenes
    assert tt.rgb.shape == (tt.capacity, 27)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(tt, k).numpy(),
                                      np.asarray(getattr(jt, k)), err_msg=k)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sh_render_cropped_matches_jax(scenes, use_pallas):
    jt, jc, tt, _ = scenes
    grid = jc["grid"]
    jcfg = JCfg(plane_mode="dense", use_pallas=use_pallas,
                capacity_round=256, use_sh_coeff=True)
    tcfg = TCfg(capacity_round=256, use_sh_coeff=True)
    bs, rs = j_specs(grid, jt.capacity, jcfg, 27)
    tbs, trs = t_specs(grid, tcfg)
    assert trs.color_dim == 27 and not rs.sh_fast_matmul
    for cam in (0, 2):
        ji, jaux = j_render(jt.params(), jt.live, jc["w2c_rot"][cam],
                            jc["w2c_tran"][cam], jc["sh_vecs"][cam], grid,
                            jcfg, bs, rs, interpret=use_pallas)
        ti, taux = t_render(tt.params(), tt.live,
                            torch.from_numpy(np.array(jc["w2c_rot"][cam])),
                            torch.from_numpy(np.array(jc["w2c_tran"][cam])),
                            grid, tcfg, tbs, trs,
                            torch.from_numpy(np.array(jc["sh_vecs"][cam])))
        assert ti.shape == (3, H, W)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
        for k in ("n_pairs", "n_clipped", "n_visible", "n_max_tiles"):
            assert int(taux[k]) == int(jaux[k]), k


def _splatters(scenes):
    jt, jc, tt, tc = scenes
    jcfg = JCfg(plane_mode="dense", use_pallas=False, capacity_round=256,
                use_sh_coeff=True)
    js = JSplatter.__new__(JSplatter)     # an in-memory scene, no COLMAP
    js.cfg, js.table, js._specs_cache = jcfg, jt, {}
    js.camera_groups = [JCams(w2c_rot=jc["w2c_rot"], w2c_tran=jc["w2c_tran"],
                              sh_vecs=jc["sh_vecs"], images=jc["images"],
                              grid=jc["grid"], names=["c0", "c1", "c2"])]
    js.cameras = js.camera_groups[0]
    ts = TSplatter.from_scene(
        TCfg(capacity_round=256, use_sh_coeff=True), tt,
        [TCams(w2c_rot=tc["w2c_rot"], w2c_tran=tc["w2c_tran"],
               sh_vecs=tc["sh_vecs"], images=tc["images"], grid=tc["grid"],
               names=["c0", "c1", "c2"])])
    return js, ts


def test_sh_eval_step_matches_jax(scenes):
    js, ts = _splatters(scenes)
    jstep, tstep = j_eval_step(js), make_eval_step(ts)
    for cam in range(3):
        ji, jp, jss = jstep(js.table.params(), js.table.live, cam)
        ti, tp, tss = tstep(ts.table.params(), ts.table.live, cam)
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-4)
        np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
        np.testing.assert_allclose(float(tss), float(jss), rtol=1e-5)
    np.testing.assert_allclose(ts.render(1).numpy(),
                               np.asarray(jstep(js.table.params(),
                                                js.table.live, 1)[0]),
                               atol=1e-4)


def _start_state(jt, seed):
    """A mid-training JAX state: perturbed params, nonzero moments, t = 4."""
    rng = np.random.default_rng(seed)
    p = {k: v + jnp.asarray(rng.normal(0, 0.02, v.shape), jnp.float32)
         for k, v in jt.params().items()}
    opt = j_init_adam(p)
    opt = opt._replace(
        mu={k: v + jnp.asarray(rng.normal(0, 1e-5, v.shape), jnp.float32)
            for k, v in opt.mu.items()},
        nu={k: v + jnp.asarray(np.abs(rng.normal(0, 1e-9, v.shape)),
                               jnp.float32) for k, v in opt.nu.items()},
        t=jnp.asarray(4, jnp.int32))
    # fresh buffers throughout: JAX's step donates its input state
    return JState(p, jnp.array(jt.live), opt,
                  jnp.asarray(np.abs(rng.normal(0, 1e-6, p["pos"].shape)),
                              jnp.float32),
                  jnp.zeros(jt.capacity, jnp.float32))


@pytest.mark.parametrize("n_steps", [1, 3])
def test_sh_train_step_matches_jax(scenes, n_steps):
    js, ts = _splatters(scenes)
    kw = dict(ssim_weight=0.1)
    jst = _start_state(js.table, 2)
    st = tckpt.train_state_from_jax_arrays(jax.tree.map(np.asarray, jst),
                                           "cpu")
    assert st.params["rgb"].shape == (js.table.capacity, 27)
    jstep = j_train_step(js, JTCfg(**kw))
    tstep = make_train_step(ts, TTCfg(**kw))
    jms, tms = [], []
    for i in range(n_steps):
        jst, jm = jstep(jst, i % 3, jnp.full((5,), LR, jnp.float32))
        st, tm = tstep(st, i % 3, torch.full((5,), LR))
        jms.append(jm)
        tms.append(tm)
    for jm, tm in zip(jms, tms):
        # test_torch_train.py's bounds: the same render within 1e-4, the
        # same L1/SSIM arithmetic, two f32 backward routes
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        for k in ("n_pairs", "n_clipped", "n_visible", "n_max_tiles"):
            assert int(tm[k]) == int(jm[k]), k
        for k in GROUP_ORDER:
            np.testing.assert_allclose(float(tm["grad_mean"][k]),
                                       float(jm["grad_mean"][k]),
                                       rtol=1e-5, err_msg=k)
    assert int(st.opt.t) == int(jst.opt.t) == 4 + n_steps
    for k in GROUP_ORDER:
        assert _rel_l2(st.opt.mu[k], jst.opt.mu[k]) < 1e-5, k
        assert _rel_l2(st.opt.nu[k], jst.opt.nu[k]) < 1e-5, k
        np.testing.assert_allclose(st.params[k].numpy(),
                                   np.asarray(jst.params[k]),
                                   atol=0.01 * LR, rtol=0, err_msg=k)
    assert _rel_l2(st.accum_grad, jst.accum_grad) < 1e-5


@pytest.mark.parametrize("ext", [".npz", ".pth"])
def test_checkpoints_carry_sh(scenes, tmp_path, ext):
    jt, _, tt, _ = scenes
    # JAX writes, the port reads; the port writes, JAX reads
    jpath, tpath = str(tmp_path / f"j{ext}"), str(tmp_path / f"t{ext}")
    jckpt.save_checkpoint(jt, jpath)
    t = tckpt.load_checkpoint(jpath, capacity_round=256)
    tckpt.save_checkpoint(tt, tpath)
    j = jckpt.load_checkpoint(tpath, capacity_round=256)
    assert t.rgb.shape == (t.capacity, 27)
    for k in TABLE_KEYS:
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    back = tckpt.table_from_jax_arrays(
        {k: np.asarray(getattr(jt, k)) for k in TABLE_KEYS}, "cpu")
    np.testing.assert_array_equal(back.rgb.numpy(), np.asarray(jt.rgb))
