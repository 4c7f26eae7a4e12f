"""The render preset (JAX's ``packed_bf16``, the viewer's Fast Mode) and the
viewer's defaults, PyTorch port vs the JAX package, on the CPU.

On the same image-space gaussians the port's preset pairs
(``ops/binning.pack_preset``) must equal, bit for bit, the values JAX packs
into its ``packed_bf16`` buffers (``plane_mode="colcap"``, exact depth ranks:
``quant_depth`` off), and the port's plain preset compositor must match
JAX's preset image within atol 1e-5 (the bound of
``tests/test_fused_pack.py:293``), through JAX's jnp compositor and its
Pallas kernel in interpret mode.  Then: preset vs f32 PSNR above 40 dB
(``test_fused_pack.py:290``), backward through the preset raises, and
``render_offscreen`` with the default config renders the preset for RGB and
the f32 SH route for SH, where ``sh_order`` masks the bands.  The same for
the SH preset (27 coefficients, padded to 32): pair values bit for bit,
images within 1e-5 of JAX's jnp and Pallas-interpret routes, above 38 dB
from the f32 SH image (``test_fused_pack.py:326``), backward raises, and
``make_eval_step(preset=True)`` against JAX's ``packed_bf16`` eval step.
"""

import jax  # noqa: F401  (conftest pins JAX to the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu import synthetic as jsyn
from gsplat_tpu.config import SplatConfig as JCfg
from gsplat_tpu.models.splatter import SceneCameras as JCams
from gsplat_tpu.models.splatter import Splatter as JSplatter
from gsplat_tpu.ops.binning import BinningSpec as JSpec
from gsplat_tpu.ops.binning import pack_sorted as j_pack
from gsplat_tpu.ops.binning import unpack2_bf16
from gsplat_tpu.ops.rasterize import RasterSpec as JRSpec
from gsplat_tpu.ops.rasterize import (composite_chunks_jnp,
                                      composite_chunks_pallas)
from gsplat_tpu.train import make_eval_step as j_eval_step
from gsplat_tpu.viewer import render_offscreen as j_offscreen

from gsplat_tpu_torch import synthetic as tsyn
from gsplat_tpu_torch.config import SplatConfig as TCfg
from gsplat_tpu_torch.models.splatter import SceneCameras as TCams
from gsplat_tpu_torch.models.splatter import Splatter as TSplatter
from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
from gsplat_tpu_torch.ops.binning import pack_preset
from gsplat_tpu_torch.ops.binning import pack_sorted as t_pack
from gsplat_tpu_torch.ops.rasterize import RasterSpec as TRSpec
from gsplat_tpu_torch.ops.rasterize import (LAUNCHES, composite_tiles_preset,
                                            composite_tiles_preset_torch,
                                            composite_tiles_torch, rasterize,
                                            rasterize_preset)
from gsplat_tpu_torch.train import make_eval_step as t_eval_step
from gsplat_tpu_torch.viewer import render_offscreen as t_offscreen

from torch_helpers import BIG_CROWD, TILE, image_space_pairs

torch.set_num_threads(1)
FOCAL = 40.0
K = 6
N, W, H, SCENE_FOCAL = 2000, 96, 64, 80.0


def _scene(seed, opaque=False, **kw):
    geom, color, depth, visible, geo = image_space_pairs(seed, focal=FOCAL,
                                                         **kw)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    return geom, color, depth, visible, geo


def _jax_preset(geom, color, depth, visible, geo):
    """JAX's colcap packed_bf16 pack (exact ranks, padded sort)."""
    n, n_tiles = geom.shape[0], geo["n_tile_x"] * geo["n_tile_y"]
    spec = JSpec(**geo, max_tiles_per_gaussian=K,
                 slot_capacity=(n * K // 128 + n_tiles + 1) * 128,
                 chunk_size=128, plane_mode="colcap", packed_bf16=True,
                 quant_depth=False, post_align=False)
    return j_pack(spec, *map(jnp.asarray, (geom, color, depth, visible)))


def _t_preset(geom, color, depth, visible, geo):
    spec = TSpec(**geo, max_tiles_per_gaussian=K)
    packed = t_pack(spec, *map(torch.from_numpy,
                               (geom, color, depth, visible)))
    return packed, pack_preset(spec, packed)


@pytest.mark.parametrize("seed", [0, 1])
def test_preset_pairs_match_jax_bitwise(seed):
    geom, color, depth, visible, geo = _scene(seed, **BIG_CROWD)
    (gb, cb), meta = _jax_preset(geom, color, depth, visible, geo)
    # JAX rows: (x|c, y|d, a|opa, b|blue) and (r|g), two bf16 to an i32
    jg = np.asarray(unpack2_bf16(gb)).T        # x y a b c d opa blue
    jc = np.asarray(unpack2_bf16(cb)).T        # r g
    packed, pp = _t_preset(geom, color, depth, visible, geo)
    assert pp.geom.dtype == pp.color.dtype == torch.bfloat16
    assert pp.geom.shape == (packed.geom.shape[0], 8)
    assert pp.color.shape == (packed.geom.shape[0], 4)
    ts = packed.tile_start.numpy()
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    rows = {t: [] for t in range(n_tiles)}
    for c, (t, ln) in enumerate(zip(np.asarray(meta.chunk_tile),
                                    np.asarray(meta.chunk_len))):
        if t < n_tiles:
            rows[t].append(np.concatenate(
                [jg[c * 128:c * 128 + ln], jc[c * 128:c * 128 + ln]], 1))
    assert int(meta.n_pairs) == int(packed.n_pairs)
    for t in range(n_tiles):
        j = np.concatenate(rows[t]) if rows[t] \
            else np.zeros((0, 10), np.float32)
        g = pp.geom[ts[t]:ts[t + 1]].float().numpy()
        c = pp.color[ts[t]:ts[t + 1]].float().numpy()
        mine = np.concatenate([g[:, :7], c[:, 2:3], c[:, :2]], 1)
        np.testing.assert_array_equal(mine.view(np.int32), j.view(np.int32),
                                      err_msg=f"tile {t}")
        assert (g[:, 7] == 0).all() and (c[:, 3] == 0).all()


@pytest.mark.parametrize("opaque", [False, True])
def test_preset_matches_jax(opaque):
    geom, color, depth, visible, geo = _scene(0, opaque, **BIG_CROWD)
    (gb, cb), meta = _jax_preset(geom, color, depth, visible, geo)
    packed, pp = _t_preset(geom, color, depth, visible, geo)
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL)
    jrs = JRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 128, 3, channel_major=True, packed_bf16=True)
    before = dict(LAUNCHES)
    out = composite_tiles_preset(pp.geom, pp.color, pp.tile_start, trs)
    assert LAUNCHES == before                 # the plain route on the CPU
    torch.testing.assert_close(out, composite_tiles_preset_torch(
        pp.geom, pp.color, pp.tile_start, trs), atol=0, rtol=0)
    out = out.numpy()
    ok = np.asarray(meta.tile_ok)[:n_tiles]
    col_j, w_j = composite_chunks_jnp((gb, cb), meta.chunk_tile,
                                      meta.chunk_first, meta.chunk_len, jrs)
    col_p, w_p = composite_chunks_pallas(
        (gb, cb), meta.chunk_tile, meta.chunk_first, meta.chunk_last,
        meta.chunk_len, jrs, interpret=True, tile_ok=meta.tile_ok)
    for col, w in ((col_j, w_j), (col_p, w_p)):
        col = np.where(ok[:, None, None], np.asarray(col)[:n_tiles, :3], 0.0)
        w = np.where(ok[:, None], np.asarray(w)[:n_tiles], 0.0)
        # the same pairs and pixel centres; only the summation order differs
        np.testing.assert_allclose(out[:, :3], col, atol=1e-5)
        np.testing.assert_allclose(out[:, 3], w, atol=1e-5)
    # against the f32 route on the same pairs: visually indistinguishable
    f32 = rasterize(packed, trs).numpy()
    img = rasterize_preset(pp, trs).numpy()
    mse = float(((img - f32) ** 2).mean())
    assert 10 * np.log10(1.0 / mse) > 40      # test_fused_pack.py:290
    assert np.abs(img - f32).max() > 0        # it is not the f32 route


def _sh_scene(seed, opaque=False):
    geom, color, depth, visible, geo = _scene(seed, opaque, **BIG_CROWD)
    coef, shv = tsyn.image_space_sh(seed, color, geo, FOCAL)
    return geom, coef, depth, visible, geo, shv


@pytest.mark.parametrize("seed", [0, 1])
def test_preset_sh_pairs_match_jax_bitwise(seed):
    geom, coef, depth, visible, geo, _ = _sh_scene(seed)
    (gb, cb), meta = _jax_preset(geom, coef, depth, visible, geo)
    assert cb.shape[0] == 16               # 27 → 32 coefficients, paired
    jg = np.asarray(unpack2_bf16(gb)).T    # x y a b c d opa 0
    jc = np.asarray(unpack2_bf16(cb)).T    # the 32 coefficients in order
    packed, pp = _t_preset(geom, coef, depth, visible, geo)
    assert pp.geom.dtype == pp.color.dtype == torch.bfloat16
    assert pp.color.shape == (packed.geom.shape[0], 32)
    assert (pp.color[:, 27:] == 0).all() and (pp.geom[:, 7] == 0).all()
    ts = packed.tile_start.numpy()
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    rows = {t: [] for t in range(n_tiles)}
    for c, (t, ln) in enumerate(zip(np.asarray(meta.chunk_tile),
                                    np.asarray(meta.chunk_len))):
        if t < n_tiles:
            rows[t].append(np.concatenate(
                [jg[c * 128:c * 128 + ln], jc[c * 128:c * 128 + ln]], 1))
    assert int(meta.n_pairs) == int(packed.n_pairs)
    for t in range(n_tiles):
        j = np.concatenate(rows[t]) if rows[t] \
            else np.zeros((0, 40), np.float32)
        mine = np.concatenate(
            [pp.geom[ts[t]:ts[t + 1]].float().numpy(),
             pp.color[ts[t]:ts[t + 1]].float().numpy()], 1)
        # the values, not JAX's i32 pairing of them
        np.testing.assert_array_equal(mine.view(np.int32), j.view(np.int32),
                                      err_msg=f"tile {t}")


@pytest.mark.parametrize("opaque", [False, True])
def test_preset_sh_matches_jax(opaque):
    geom, coef, depth, visible, geo, shv = _sh_scene(0, opaque)
    (gb, cb), meta = _jax_preset(geom, coef, depth, visible, geo)
    packed, pp = _t_preset(geom, coef, depth, visible, geo)
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 color_dim=27)
    jrs = JRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 128, 27, channel_major=True, packed_bf16=True)
    tshv = torch.from_numpy(shv)
    before = dict(LAUNCHES)
    out = composite_tiles_preset(pp.geom, pp.color, pp.tile_start, trs, tshv)
    assert LAUNCHES == before                 # the plain route on the CPU
    out = out.numpy()
    ok = np.asarray(meta.tile_ok)[:n_tiles]
    col_j, w_j = composite_chunks_jnp((gb, cb), meta.chunk_tile,
                                      meta.chunk_first, meta.chunk_len, jrs,
                                      sh_vecs=jnp.asarray(shv))
    col_p, w_p = composite_chunks_pallas(
        (gb, cb), meta.chunk_tile, meta.chunk_first, meta.chunk_last,
        meta.chunk_len, jrs, sh_vecs=jnp.asarray(shv), interpret=True,
        tile_ok=meta.tile_ok)
    for col, w in ((col_j, w_j), (col_p, w_p)):
        col = np.where(ok[:, None, None], np.asarray(col)[:n_tiles, :3], 0.0)
        w = np.where(ok[:, None], np.asarray(w)[:n_tiles], 0.0)
        # the same pairs, pixel centres and basis: the RGB preset's bound
        np.testing.assert_allclose(out[:, :3], col, atol=1e-5)
        np.testing.assert_allclose(out[:, 3], w, atol=1e-5)
    # against the f32 SH route on the same pairs: JAX's bound,
    # tests/test_fused_pack.py:326
    f32 = rasterize(packed, trs, tshv).numpy()
    img = rasterize_preset(pp, trs, tshv).numpy()
    mse = float(((img - f32) ** 2).mean())
    assert 10 * np.log10(1.0 / mse) > 38
    assert np.abs(img - f32).max() > 0


def test_preset_sh_backward_raises():
    geom, coef, depth, visible, geo, shv = _sh_scene(2)
    spec = TSpec(**geo, max_tiles_per_gaussian=K)
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 color_dim=27)
    c = torch.from_numpy(coef).requires_grad_()
    pp = pack_preset(spec, t_pack(spec, torch.from_numpy(geom), c,
                                  torch.from_numpy(depth),
                                  torch.from_numpy(visible)))
    img = rasterize_preset(pp, trs, torch.from_numpy(shv))
    assert img.grad_fn is not None
    with pytest.raises(NotImplementedError, match="render-only"):
        img.sum().backward()
    assert c.grad is None


def test_preset_backward_raises():
    geom, color, depth, visible, geo = _scene(2)
    spec = TSpec(**geo, max_tiles_per_gaussian=K)
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL)
    g = torch.from_numpy(geom).requires_grad_()
    c = torch.from_numpy(color).requires_grad_()
    pp = pack_preset(spec, t_pack(spec, g, c, torch.from_numpy(depth),
                                  torch.from_numpy(visible)))
    img = rasterize_preset(pp, trs)
    assert img.grad_fn is not None
    with pytest.raises(NotImplementedError, match="render-only"):
        img.sum().backward()
    assert g.grad is None and c.grad is None


def test_preset_wrapper_checks():
    trs = TRSpec(2, 1, TILE, TILE, FOCAL, FOCAL)
    start = torch.zeros(3, dtype=torch.int32)
    bf = dict(dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        composite_tiles_preset(torch.zeros(0, 8), torch.zeros(0, 4, **bf),
                               start, trs)
    # SH takes (P, 32) colors and the camera's sh_vecs
    sh = trs._replace(color_dim=27)
    with pytest.raises(ValueError, match=r"color \(P, 32\)"):
        composite_tiles_preset(torch.zeros(0, 8, **bf),
                               torch.zeros(0, 4, **bf), start, sh,
                               torch.zeros(4, 3))
    with pytest.raises(ValueError, match="sh_vecs"):
        composite_tiles_preset(torch.zeros(0, 8, **bf),
                               torch.zeros(0, 32, **bf), start, sh)
    with pytest.raises(ValueError, match="CPU tensors"):
        composite_tiles_preset(torch.zeros(0, 8, **bf),
                               torch.zeros(0, 4, device="meta", **bf),
                               start, trs)
    geom, color, depth, visible, geo = _scene(0)
    spec = TSpec(**geo, max_tiles_per_gaussian=K)
    packed = t_pack(spec, *map(torch.from_numpy, (
        geom, np.zeros((geom.shape[0], 5), np.float32), depth, visible)))
    with pytest.raises(ValueError, match="RGB .3. or SH .27."):
        pack_preset(spec, packed)
    out = composite_tiles_preset(torch.zeros(0, 8, **bf),
                                 torch.zeros(0, 4, **bf), start, trs)
    assert out.shape == (2, 4, 256) and (out == 0).all()
    # the f32 route is unchanged by the preset's existence
    ref = composite_tiles_torch(torch.zeros(0, 8), torch.zeros(0, 3), start,
                                trs)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


# ---- render_offscreen with the default config ------------------------------

def _splatters(use_sh):
    jt = jsyn.synthetic_table(N, capacity_round=256, focal=SCENE_FOCAL,
                              scale_px=3.0, frustum=(0.85, 0.55),
                              use_sh=use_sh, sh_ampl=0.35 if use_sh else 0.0)
    tt = tsyn.synthetic_table(N, capacity_round=256, focal=SCENE_FOCAL,
                              scale_px=3.0, frustum=(0.85, 0.55),
                              use_sh=use_sh, sh_ampl=0.35 if use_sh else 0.0,
                              device="cpu")
    tc = tsyn.synthetic_cameras(1, W, H, SCENE_FOCAL, device="cpu")
    # JAX's Fast Mode needs the column-compacted plane (viewer.py:95); its
    # depth quantisation stays off, as the port keeps exact depth order, and
    # so does its bf16 SH payload (bf16_pack, which also contracts the SH
    # colors in one bf16 pass): the port's SH route is f32
    jcfg = JCfg(plane_mode="colcap", quant_depth=0, bf16_pack=0,
                use_pallas=False, capacity_round=256, use_sh_coeff=use_sh)
    js = JSplatter.__new__(JSplatter)     # an in-memory scene, no COLMAP
    js.cfg, js.table, js._specs_cache = jcfg, jt, {}
    ts = TSplatter.from_scene(
        TCfg(capacity_round=256, use_sh_coeff=use_sh), tt,
        [TCams(w2c_rot=tc["w2c_rot"], w2c_tran=tc["w2c_tran"],
               sh_vecs=tc["sh_vecs"], images=tc["images"], grid=tc["grid"],
               names=["c0"])])
    assert ts.cfg.fast_drawing and jcfg.fast_drawing
    return js, ts


W2C = np.array([[0.999, -0.02, 0.04, 0.05], [0.021, 0.999, -0.01, -0.03],
                [-0.04, 0.011, 0.999, 0.1], [0, 0, 0, 1]], np.float32)


def test_render_offscreen_default_rgb_is_the_preset():
    js, ts = _splatters(False)
    ji = j_offscreen(js, W2C, 80, 56, 70.0, 70.0)          # packed_bf16
    ti = t_offscreen(ts, W2C, 80, 56, 70.0, 70.0)
    assert ti.shape == (56, 80, 3)
    f32 = t_offscreen(ts, W2C, 80, 56, 70.0, 70.0, fast=False)
    # the preset's bound (test_fused_pack.py:293; measured 3e-7)
    np.testing.assert_allclose(ti, ji, atol=1e-5)
    assert np.abs(ti - f32).max() > 0
    mse = float(((ti - f32) ** 2).mean())
    assert 10 * np.log10(1.0 / mse) > 40


def test_render_offscreen_default_sh_and_sh_order():
    js, ts = _splatters(True)
    imgs = {}
    for order in (None, 1, 2, 3):
        ji = j_offscreen(js, W2C, 80, 56, 70.0, 70.0, sh_order=order)
        ti = t_offscreen(ts, W2C, 80, 56, 70.0, 70.0, sh_order=order)
        # SH keeps the f32 route in Fast Mode: the f32 bound
        np.testing.assert_allclose(ti, ji, atol=1e-4, err_msg=str(order))
        imgs[order] = ti
    # fast is moot for SH: the default and fast=False are the same render
    np.testing.assert_array_equal(
        imgs[None], t_offscreen(ts, W2C, 80, 56, 70.0, 70.0, fast=False))
    # order 3 keeps all 9 bands; orders 1 and 2 drop some
    np.testing.assert_array_equal(imgs[3], imgs[None])
    assert np.abs(imgs[1] - imgs[None]).max() > 0.01
    assert np.abs(imgs[2] - imgs[1]).max() > 0.01


def test_eval_step_preset_sh_matches_jax():
    # make_eval_step(preset=True) on an SH Splatter against JAX's
    # make_eval_step with cfg.packed_bf16 (jnp route, exact depth ranks)
    js, ts = _splatters(True)
    jc = jsyn.synthetic_cameras(1, W, H, SCENE_FOCAL)
    js.cfg = JCfg(plane_mode="colcap", quant_depth=0, packed_bf16=True,
                  use_pallas=False, capacity_round=256, use_sh_coeff=True)
    js.camera_groups = [JCams(w2c_rot=jc["w2c_rot"], w2c_tran=jc["w2c_tran"],
                              sh_vecs=jc["sh_vecs"], images=jc["images"],
                              grid=jc["grid"], names=["c0"])]
    ji, jp, jss = j_eval_step(js)(js.table.params(), js.table.live, 0)
    before = dict(LAUNCHES)
    ti, tp, tss = t_eval_step(ts, preset=True)(ts.table.params(),
                                               ts.table.live, 0)
    assert LAUNCHES == before
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-5)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    np.testing.assert_allclose(float(tss), float(jss), rtol=1e-5)
    torch.testing.assert_close(ts.render(0, preset=True), ti, atol=0, rtol=0)
    f32, _, _ = t_eval_step(ts)(ts.table.params(), ts.table.live, 0)
    mse = float(((ti - f32) ** 2).mean())
    assert 38 < 10 * np.log10(1.0 / mse) < 200     # close, not the f32 image
