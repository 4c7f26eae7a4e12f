"""The CUDA kernels of gsplat_tpu_torch against their plain PyTorch versions,
and the train step on the card against the CPU.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the conftest imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import synthetic
from gsplat_tpu_torch.config import SplatConfig, TrainConfig
from gsplat_tpu_torch.models.splatter import (SceneCameras, Splatter,
                                              make_specs, render_cropped)
from gsplat_tpu_torch.ops.binning import BinningSpec, pack_preset, \
    pack_sorted
from gsplat_tpu_torch.ops.rasterize import (LAUNCHES, RasterSpec,
                                            composite_tiles,
                                            composite_tiles_bwd,
                                            composite_tiles_bwd_torch,
                                            composite_tiles_preset,
                                            composite_tiles_preset_torch,
                                            composite_tiles_torch)
from gsplat_tpu_torch.train import (GROUP_ORDER, init_train_state,
                                    make_train_step)
from gsplat_tpu_torch.viewer import render_offscreen

from torch_helpers import (BIG_CROWD, TILE, assert_close_cols,
                           image_space_pairs)

TOL = 2e-4   # max abs: summation order, and pairs either side of T = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _packed(device, seed=0, opaque=False, focal=40.0, sh=False, **kw):
    """The small scene packed on ``device``; with ``sh``, SH color
    (``synthetic.image_space_sh``) and also its sh_vecs."""
    geom, color, depth, visible, geo = image_space_pairs(seed, focal=focal,
                                                         **kw)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    spec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, focal,
                       focal, color_dim=27 if sh else 3)
    if sh:
        color, shv = synthetic.image_space_sh(seed, color, geo, focal)
    args = [torch.from_numpy(a).to(device)
            for a in (geom, color, depth, visible)]
    if sh:
        return pack_sorted(spec, *args), rspec, torch.from_numpy(shv).to(
            device)
    return pack_sorted(spec, *args), rspec


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
def test_kernel_matches_plain_version(cuda, opaque):
    packed, rspec = _packed(cuda, opaque=opaque)
    counts = torch.diff(packed.tile_start)
    assert int(counts.max()) > 128 and int((counts == 0).sum()) > 0
    before = LAUNCHES["rasterize_fwd"]
    out = composite_tiles(packed.geom, packed.color, packed.tile_start, rspec)
    torch.cuda.synchronize()
    assert LAUNCHES["rasterize_fwd"] == before + 1
    ref = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                rspec)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)
    assert (out[(counts == 0)] == 0).all()       # empty tiles write zeros


@pytest.mark.cuda
def test_kernel_rejects_bad_inputs(cuda):
    packed, rspec = _packed(cuda)
    with pytest.raises(ValueError, match="contiguous"):
        composite_tiles(packed.geom.t().contiguous().t(), packed.color,
                        packed.tile_start, rspec)
    with pytest.raises(ValueError, match="1024"):
        composite_tiles(packed.geom, packed.color, packed.tile_start,
                        rspec._replace(tile_h=64, tile_w=32))
    with pytest.raises(ValueError, match="CPU tensors"):
        composite_tiles(packed.geom, packed.color.cpu(), packed.tile_start,
                        rspec)


@pytest.mark.cuda
def test_render_on_cuda_matches_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55))
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0)
    cfg = SplatConfig()
    bspec, rspec = make_specs(cams["grid"], cfg)
    imgs = []
    for dev in ("cpu", cuda):
        t = table.to(dev)
        img, aux = render_cropped(t.params(), t.live,
                                  cams["w2c_rot"][1].to(dev),
                                  cams["w2c_tran"][1].to(dev), cams["grid"],
                                  cfg, bspec, rspec)
        imgs.append(img.cpu())
    torch.testing.assert_close(imgs[1], imgs[0], atol=TOL, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_bwd_kernel_matches_plain_version(cuda, opaque, wn):
    packed, rspec = _packed(cuda, opaque=opaque, **BIG_CROWD)
    counts = torch.diff(packed.tile_start)
    assert int(counts.max()) > 256 and int((counts == 0).sum()) > 0
    out = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                rspec)
    rng = np.random.default_rng(7)
    go = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32)).to(cuda)
    if not wn:
        go[:, 3] = 0.0
    before = LAUNCHES["rasterize_bwd"]
    gg, gc = composite_tiles_bwd(packed.geom, packed.color, packed.tile_start,
                                 out, go, rspec)
    torch.cuda.synchronize()
    assert LAUNCHES["rasterize_bwd"] == before + 1
    rg, rc = composite_tiles_bwd_torch(packed.geom, packed.color,
                                       packed.tile_start, out, go, rspec)
    # per pair, the bound of tests/test_rasterize.py:96 with its atol taken
    # relative to each column's largest gradient
    assert_close_cols(gg.cpu(), rg.cpu(), 3e-4, 2e-3, "grad_geom")
    assert_close_cols(gc.cpu(), rc.cpu(), 3e-4, 2e-3, "grad_color")
    assert (gg[:, 7] == 0).all()
    # empty tiles own no rows: NaN in their out / grad_out rows (the TPU's
    # unwritten-rows fault) must reach no pair
    empty = counts == 0
    out[empty] = float("nan")
    go[empty] = float("nan")
    gg2, gc2 = composite_tiles_bwd(packed.geom, packed.color,
                                   packed.tile_start, out, go, rspec)
    assert torch.equal(gg2, gg) and torch.equal(gc2, gc)


@pytest.mark.cuda
def test_composite_tiles_keeps_the_graph_on_cuda(cuda):
    # the repair: the CUDA route used to return an output with no grad_fn
    packed, rspec = _packed(cuda)
    g = packed.geom.clone().requires_grad_()
    c = packed.color.clone().requires_grad_()
    before = (LAUNCHES["rasterize_fwd"], LAUNCHES["rasterize_bwd"])
    out = composite_tiles(g, c, packed.tile_start, rspec)
    assert out.grad_fn is not None
    out[:, :3].sum().backward()
    torch.cuda.synchronize()
    assert (LAUNCHES["rasterize_fwd"], LAUNCHES["rasterize_bwd"]) == (
        before[0] + 1, before[1] + 1)
    assert g.grad is not None and c.grad is not None
    assert float(g.grad.abs().sum()) > 0 and float(c.grad.abs().sum()) > 0


@pytest.mark.cuda
def test_train_step_on_cuda_matches_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55))
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0)
    results = []
    for dev in ("cpu", cuda):
        t = table.to(dev)
        splat = Splatter.from_scene(SplatConfig(), t, [SceneCameras(
            w2c_rot=cams["w2c_rot"].to(dev), w2c_tran=cams["w2c_tran"].to(dev),
            sh_vecs=cams["sh_vecs"].to(dev), images=cams["images"].to(dev),
            grid=cams["grid"], names=["a", "b"])])
        step = make_train_step(splat, TrainConfig())
        st, m = step(init_train_state(t.params(), t.live), 1,
                     torch.full((5,), 1e-3, device=dev))
        results.append((st, m))
    (sc, mc), (sg, mg) = results
    # the kernels against the plain versions through the whole step
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               rtol=1e-5)
    for k in GROUP_ORDER:
        a, b = sg.opt.mu[k].cpu(), sc.opt.mu[k]
        assert float((a - b).norm() / b.norm()) < 1e-3, k


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
def test_sh_kernel_matches_plain_version(cuda, opaque):
    packed, rspec, shv = _packed(cuda, opaque=opaque, sh=True, **BIG_CROWD)
    counts = torch.diff(packed.tile_start)
    assert int(counts.max()) > 256 and int((counts == 0).sum()) > 0
    before = LAUNCHES["rasterize_fwd_sh"]
    out = composite_tiles(packed.geom, packed.color, packed.tile_start, rspec,
                          shv)
    torch.cuda.synchronize()
    assert LAUNCHES["rasterize_fwd_sh"] == before + 1
    ref = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                rspec, shv)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)
    assert (out[(counts == 0)] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_sh_bwd_kernel_matches_plain_version(cuda, opaque, wn):
    packed, rspec, shv = _packed(cuda, opaque=opaque, sh=True, **BIG_CROWD)
    counts = torch.diff(packed.tile_start)
    out = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                rspec, shv)
    rng = np.random.default_rng(7)
    go = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32)).to(cuda)
    if not wn:
        go[:, 3] = 0.0
    before = LAUNCHES["rasterize_bwd_sh"]
    gg, gc = composite_tiles_bwd(packed.geom, packed.color, packed.tile_start,
                                 out, go, rspec, shv)
    torch.cuda.synchronize()
    assert LAUNCHES["rasterize_bwd_sh"] == before + 1
    rg, rc = composite_tiles_bwd_torch(packed.geom, packed.color,
                                       packed.tile_start, out, go, rspec, shv)
    assert gc.shape == (packed.geom.shape[0], 27)
    # the RGB backward's per-pair bound (test_bwd_kernel_matches_plain_version)
    assert_close_cols(gg.cpu(), rg.cpu(), 3e-4, 2e-3, "grad_geom")
    assert_close_cols(gc.cpu(), rc.cpu(), 3e-4, 2e-3, "grad_sh")
    assert (gg[:, 7] == 0).all()
    # NaN in the empty tiles' out / grad_out rows must reach no pair
    empty = counts == 0
    out[empty] = float("nan")
    go[empty] = float("nan")
    gg2, gc2 = composite_tiles_bwd(packed.geom, packed.color,
                                   packed.tile_start, out, go, rspec, shv)
    assert torch.equal(gg2, gg) and torch.equal(gc2, gc)


@pytest.mark.cuda
@pytest.mark.parametrize("opaque", [False, True])
def test_preset_kernel_matches_plain_version(cuda, opaque):
    geom, color, depth, visible, geo = image_space_pairs(0, focal=40.0,
                                                         **BIG_CROWD)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    spec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, 40.0,
                       40.0)
    packed = pack_sorted(spec, *[torch.from_numpy(a).to(cuda)
                                 for a in (geom, color, depth, visible)])
    pp = pack_preset(spec, packed)
    before = LAUNCHES["rasterize_fwd_preset"]
    out = composite_tiles_preset(pp.geom, pp.color, pp.tile_start, rspec)
    torch.cuda.synchronize()
    assert LAUNCHES["rasterize_fwd_preset"] == before + 1
    ref = composite_tiles_preset_torch(pp.geom, pp.color, pp.tile_start,
                                       rspec)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)
    counts = torch.diff(packed.tile_start)
    assert (out[(counts == 0)] == 0).all()
    # the pack ran on the card: the same pairs as on the CPU
    cpu = pack_preset(spec, pack_sorted(spec, *map(torch.from_numpy, (
        geom, color, depth, visible))))
    assert torch.equal(pp.geom.cpu(), cpu.geom)
    assert torch.equal(pp.color.cpu(), cpu.color)


@pytest.mark.cuda
def test_sh_train_step_and_offscreen_on_cuda_match_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      use_sh=True, sh_ampl=0.35)
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0)
    w2c = np.eye(4, dtype=np.float32)
    results = []
    for dev in ("cpu", cuda):
        t = table.to(dev)
        splat = Splatter.from_scene(SplatConfig(use_sh_coeff=True), t, [
            SceneCameras(w2c_rot=cams["w2c_rot"].to(dev),
                         w2c_tran=cams["w2c_tran"].to(dev),
                         sh_vecs=cams["sh_vecs"].to(dev),
                         images=cams["images"].to(dev), grid=cams["grid"],
                         names=["a", "b"])])
        step = make_train_step(splat, TrainConfig())
        st, m = step(init_train_state(t.params(), t.live), 1,
                     torch.full((5,), 1e-3, device=dev))
        frame = render_offscreen(splat, w2c, 96, 64, 60.0, 60.0, sh_order=2)
        results.append((st, m, frame))
    (sc, mc, fc), (sg, mg, fg) = results
    np.testing.assert_allclose(float(mg["loss"]), float(mc["loss"]),
                               rtol=1e-5)
    for k in GROUP_ORDER:
        a, b = sg.opt.mu[k].cpu(), sc.opt.mu[k]
        assert float((a - b).norm() / b.norm()) < 1e-3, k
    np.testing.assert_allclose(fg, fc, atol=TOL)


@pytest.mark.cuda
def test_offscreen_preset_on_cuda_matches_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55))
    cams = synthetic.synthetic_cameras(1, 160, 112, 100.0)
    w2c = np.eye(4, dtype=np.float32)
    frames = []
    for dev in ("cpu", cuda):
        splat = Splatter.from_scene(SplatConfig(), table.to(dev), [
            SceneCameras(w2c_rot=cams["w2c_rot"].to(dev),
                         w2c_tran=cams["w2c_tran"].to(dev),
                         sh_vecs=cams["sh_vecs"].to(dev), images=None,
                         grid=cams["grid"], names=["a"])])
        before = LAUNCHES["rasterize_fwd_preset"]
        frames.append(render_offscreen(splat, w2c, 96, 64, 60.0, 60.0))
        launched = LAUNCHES["rasterize_fwd_preset"] - before
        assert launched == (0 if dev == "cpu" else 1)
    np.testing.assert_allclose(frames[1], frames[0], atol=TOL)
