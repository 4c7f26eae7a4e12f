"""The CUDA kernels of gsplat_tpu_torch against their plain PyTorch versions,
and the train step on the card against the CPU.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  The file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed (the conftest imports JAX, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import types

import numpy as np
import pytest
import torch

from gsplat_tpu_torch import synthetic
from gsplat_tpu_torch.config import SplatConfig, TrainConfig
import dataclasses

from gsplat_tpu_torch.models.gaussians import adaptive_control
from gsplat_tpu_torch.models.splatter import (SceneCameras, Splatter,
                                              gt_to_float, make_specs,
                                              render_cropped)
from gsplat_tpu_torch.ops.binning import (BinningSpec, _tile_bbox_rows,
                                          pack_preset, pack_sorted)
from gsplat_tpu_torch.ops.rasterize import (LAUNCHES, RasterSpec,
                                            _tile_pixel_coords,
                                            composite_tiles,
                                            composite_tiles_bwd,
                                            composite_tiles_bwd_torch,
                                            composite_tiles_preset,
                                            composite_tiles_preset_torch,
                                            composite_tiles_torch,
                                            fast_division_check)
from gsplat_tpu_torch.ops.sh import initialize_sh
from gsplat_tpu_torch.train import (GROUP_ORDER, AdamState, adam_update,
                                    bias_correction, init_train_state, lrs_at,
                                    make_eval_step, make_train_step)
from gsplat_tpu_torch.viewer import render_offscreen

from torch_helpers import (BIG_CROWD, DIVISION_SITES, FWD_BATCH,
                           RAGGED_COUNTS, TILE, FakeServer, division_rows,
                           assert_close_cols, bbox_boundary_rows,
                           image_space_pairs, ragged_pairs)

TOL = 2e-4   # max abs: summation order, and pairs either side of T = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _packed(device, seed=0, opaque=False, focal=40.0, sh=False, tile=TILE,
            **kw):
    """The small scene on ``tile``-px tiles packed on ``device``; with
    ``sh``, SH color (``synthetic.image_space_sh``) and also its sh_vecs."""
    geom, color, depth, visible, geo = image_space_pairs(seed, focal=focal,
                                                         tile=tile, **kw)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    spec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, focal,
                       focal, color_dim=27 if sh else 3)
    if sh:
        color, shv = synthetic.image_space_sh(seed, color, geo, focal,
                                              tile=tile)
    args = [torch.from_numpy(a).to(device)
            for a in (geom, color, depth, visible)]
    if sh:
        return pack_sorted(spec, *args), rspec, torch.from_numpy(shv).to(
            device)
    return pack_sorted(spec, *args), rspec


@pytest.mark.cuda
def test_tile_boxes_on_cuda_match_cpu(cuda):
    # box edges a few ulps either side of a tile boundary: the card must
    # floor the same quotients as the CPU (and JAX), so it must divide, not
    # multiply by the reciprocal as a CUDA tensor / Python number does
    geo, *rows = bbox_boundary_rows(0)
    spec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    cpu = _tile_bbox_rows(spec, *map(torch.from_numpy, rows))
    card = _tile_bbox_rows(spec, *(torch.from_numpy(r).to(cuda)
                                   for r in rows))
    for name, c, k in zip(("x0", "y0", "rw", "rh"), cpu, card):
        assert torch.equal(k.cpu(), c), \
            f"{name}: {int((k.cpu() != c).sum())} boxes differ"


@pytest.mark.cuda
@pytest.mark.parametrize("relative", [False, True])
def test_pixel_centres_on_cuda_match_cpu(cuda, relative):
    # the plain twin's pixel centres on the bench grid: divided on the card
    # as on the CPU and in the kernels, where a reciprocal multiply moves
    # more than half of them by an ulp
    spec = RasterSpec(82, 53, 16, 16, 1000.0, 1000.0)
    tiles = torch.arange(spec.n_tiles)
    cpu = _tile_pixel_coords(spec, tiles, relative)
    card = _tile_pixel_coords(spec, tiles.to(cuda), relative)
    for c, k in zip(cpu, card):
        assert torch.equal(k.cpu(), c), \
            f"{int((k.cpu() != c).sum())} pixel centres differ"


def _division_site(site, device):
    """The port's own code at one division site, on ``device``, fed the
    rows of ``torch_helpers.division_rows`` → the tensors it computes."""
    x, y = division_rows(site)
    if site == "ground_truth":
        img = torch.from_numpy(x.astype(np.uint8)).reshape(1, 16, 16)
        return [gt_to_float(img.expand(3, 16, 16).contiguous().to(device))]
    if site == "adam":
        rows = torch.from_numpy(x.reshape(-1, 4)).to(device)
        params = {k: rows + i for i, k in enumerate(GROUP_ORDER)}
        grads = {k: rows * (i + 1) for i, k in enumerate(GROUP_ORDER)}
        state = AdamState(mu={k: rows for k in GROUP_ORDER},
                          nu={k: rows * rows for k in GROUP_ORDER},
                          t=torch.tensor(2, dtype=torch.int32, device=device))
        p, st = adam_update(params, grads, state,
                            torch.full((5,), 1e-3, device=device), 0.9,
                            0.999, 1e-15)
        # and the bias corrections themselves, where CUDA's powf differs
        steps = torch.arange(20001, dtype=torch.int32, device=device)
        return [p[k] for k in GROUP_ORDER] + [
            st.mu[k] for k in GROUP_ORDER] + [
            bias_correction(b, steps) for b in (0.9, 0.99, 0.999)]
    if site == "split_scale":
        table = synthetic.synthetic_table(3000, capacity_round=1024,
                                          focal=100.0, scale_px=3.0,
                                          frustum=(0.85, 0.55), device="cpu")
        table = dataclasses.replace(table, scale=torch.from_numpy(
            x.reshape(-1, 3)[:table.capacity]).clone())
        rng = np.random.default_rng(3)
        grad = torch.from_numpy(np.abs(rng.normal(
            0, 3e-4, (table.capacity, 3))).astype(np.float32))
        eps = torch.from_numpy(rng.normal(size=(table.capacity, 2, 3))
                               .astype(np.float32))
        out, stats = adaptive_control(
            table.to(device), grad.to(device), eps.to(device), taus=0.2,
            delete_thresh=0.5, grad_thresh=2e-4, clone_dt=0.01,
            use_clone=True, use_split=True)
        assert stats.n_split > 0
        return [out.scale, out.live]
    return [initialize_sh(torch.from_numpy(x.reshape(-1, 3)).to(device))]


@pytest.mark.cuda
@pytest.mark.parametrize("site", DIVISION_SITES)
def test_divisions_on_cuda_match_cpu(cuda, site):
    # each division by a Python number on the image and training path goes
    # through binning.div_rn: bit for bit the CPU's quotient (and JAX's),
    # on rows where a reciprocal multiply moves some by an ulp
    # (test_torch_binning.py::test_divisions_differ_under_a_reciprocal)
    for i, (c, k) in enumerate(zip(_division_site(site, "cpu"),
                                   _division_site(site, cuda))):
        assert torch.equal(k.cpu(), c), \
            f"{site}[{i}]: {int((k.cpu() != c).sum())} values differ"


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
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      device="cpu")
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0, device="cpu")
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


def _check_bwd(cuda, geom, color, tile_start, rspec, shv, wn):
    """The backward kernel against its plain version on ``cuda`` tensors,
    launched twice; then NaN in the empty tiles' rows."""
    sh = shv is not None
    counts = torch.diff(tile_start)
    out = composite_tiles_torch(geom, color, tile_start, rspec, shv)
    rng = np.random.default_rng(7)
    go = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(
        np.float32)).to(cuda)
    if not wn:
        go[:, 3] = 0.0
    name = "rasterize_bwd_sh" if sh else "rasterize_bwd"
    before = LAUNCHES[name]
    gg, gc = composite_tiles_bwd(geom, color, tile_start, out, go, rspec, shv)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    rg, rc = composite_tiles_bwd_torch(geom, color, tile_start, out, go,
                                       rspec, shv)
    assert gc.shape == color.shape
    # per pair, the bound of tests/test_rasterize.py:96 with its atol taken
    # relative to each column's largest gradient
    assert_close_cols(gg.cpu(), rg.cpu(), 3e-4, 2e-3, "grad_geom")
    assert_close_cols(gc.cpu(), rc.cpu(), 3e-4, 2e-3,
                      "grad_sh" if sh else "grad_color")
    assert (gg[:, 7] == 0).all()
    # one writer per row and a fixed summation order: the same bits again
    again = composite_tiles_bwd(geom, color, tile_start, out, go, rspec, shv)
    assert torch.equal(again[0], gg) and torch.equal(again[1], gc)
    # empty tiles own no rows: NaN in their out / grad_out rows (the TPU's
    # unwritten-rows fault) must reach no pair
    empty = counts == 0
    assert bool(empty.any())
    out[empty] = float("nan")
    go[empty] = float("nan")
    gg2, gc2 = composite_tiles_bwd(geom, color, tile_start, out, go, rspec,
                                   shv)
    assert torch.equal(gg2, gg) and torch.equal(gc2, gc)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 8])
@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_bwd_kernel_matches_plain_version(cuda, opaque, wn, tile):
    # 16x16 tiles: 4 pixels a thread, two warps; 8x8: one warp, whose
    # threads' last two pixel slots lie past the tile
    packed, rspec = _packed(cuda, opaque=opaque, tile=tile, **BIG_CROWD)
    counts = torch.diff(packed.tile_start)
    assert int(counts.max()) > 256 and int((counts == 0).sum()) > 0
    _check_bwd(cuda, packed.geom, packed.color, packed.tile_start, rspec,
               None, wn)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 8])
@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_sh_bwd_kernel_matches_plain_version(cuda, opaque, wn, tile):
    packed, rspec, shv = _packed(cuda, opaque=opaque, sh=True, tile=tile,
                                 **BIG_CROWD)
    counts = torch.diff(packed.tile_start)
    assert int(counts.max()) > 256 and int((counts == 0).sum()) > 0
    _check_bwd(cuda, packed.geom, packed.color, packed.tile_start, rspec,
               shv, wn)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 12])
@pytest.mark.parametrize("sh", [False, True])
def test_bwd_kernel_ragged_tiles(cuda, sh, tile):
    # tiles of one pair, of one more than a staged batch and of one more
    # than a reduction round, and an empty one; 12x12 tiles (144 pixels)
    # leave pixel slots past the tile in both warps
    geom, color, start, geo, shv = ragged_pairs(0, tile, sh=sh)
    assert list(np.diff(start)) == list(RAGGED_COUNTS)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, 40.0,
                       40.0, color_dim=color.shape[1])
    _check_bwd(cuda, *(torch.from_numpy(a).to(cuda)
                       for a in (geom, color, start)), rspec,
               None if shv is None else torch.from_numpy(shv).to(cuda), True)


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
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      device="cpu")
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0, device="cpu")
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
@pytest.mark.parametrize("opaque", [False, True])
def test_preset_sh_kernel_matches_plain_version(cuda, opaque):
    packed, rspec, shv = _packed(cuda, opaque=opaque, sh=True, **BIG_CROWD)
    counts = torch.diff(packed.tile_start)
    assert int(counts.max()) > 256 and int((counts == 0).sum()) > 0
    spec = BinningSpec(**image_space_pairs(0, focal=40.0, **BIG_CROWD)[4],
                       max_tiles_per_gaussian=6)
    pp = pack_preset(spec, packed)
    assert pp.color.shape == (packed.geom.shape[0], 32)
    before = LAUNCHES["rasterize_fwd_preset_sh"]
    out = composite_tiles_preset(pp.geom, pp.color, pp.tile_start, rspec, shv)
    torch.cuda.synchronize()
    assert LAUNCHES["rasterize_fwd_preset_sh"] == before + 1
    ref = composite_tiles_preset_torch(pp.geom, pp.color, pp.tile_start,
                                       rspec, shv)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)
    assert (out[(counts == 0)] == 0).all()
    # it is not the f32 SH route, but close to it
    f32 = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                rspec, shv)
    assert 0 < float((out - f32).abs().max()) < 0.05


@pytest.mark.cuda
def test_fast_division_matches_ieee(cuda):
    # the forward kernels' split pm / pn (csrc/fast_div.cuh) against the
    # compiler's x / y, bit for bit, on operands either side of its range
    taken, differ, left = fast_division_check(1 << 28, 7, cuda)
    assert differ == 0
    assert taken > (1 << 26) and left > (1 << 24)
    assert taken + left == 1 << 28


FWD_ENTRY_POINTS = ("rasterize_fwd", "rasterize_fwd_sh",
                    "rasterize_fwd_preset", "rasterize_fwd_preset_sh")


def _fwd_pairs(cuda, name, opaque, tile, ragged):
    """The pairs of forward entry point ``name`` on ``cuda``: the big-crowd
    scene packed on ``tile``-px tiles, or the ragged scene; bf16 for the
    presets.  → (geom, color, tile_start, rspec, sh_vecs or None)."""
    sh = name.endswith("_sh")
    if ragged:
        geom, color, start, geo, shv = ragged_pairs(0, tile, sh=sh)
    else:
        geom, color, depth, visible, geo = image_space_pairs(
            0, focal=40.0, tile=tile, **BIG_CROWD)
        shv = None
        if sh:
            color, shv = synthetic.image_space_sh(0, color, geo, 40.0,
                                                  tile=tile)
    if opaque:
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    spec = BinningSpec(**geo, max_tiles_per_gaussian=6)
    if ragged:
        pairs = types.SimpleNamespace(
            **{k: torch.from_numpy(a).to(cuda) for k, a in (
                ("geom", geom), ("color", color), ("tile_start", start))})
    else:
        pairs = pack_sorted(spec, *[torch.from_numpy(a).to(cuda)
                                    for a in (geom, color, depth, visible)])
    if "preset" in name:
        pairs = pack_preset(spec, pairs)
    rspec = RasterSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, 40.0,
                       40.0, color_dim=27 if sh else 3)
    return (pairs.geom, pairs.color, pairs.tile_start, rspec,
            None if shv is None else torch.from_numpy(shv).to(cuda))


def _check_fwd(name, geom, color, tile_start, rspec, shv):
    """A forward kernel against its plain version: within TOL, empty tiles
    exactly zero, and a second launch on the same inputs gives the same
    bits."""
    preset = "preset" in name
    kernel = composite_tiles_preset if preset else composite_tiles
    plain = composite_tiles_preset_torch if preset else composite_tiles_torch
    before = LAUNCHES[name]
    out = kernel(geom, color, tile_start, rspec, shv)
    torch.cuda.synchronize()
    assert LAUNCHES[name] == before + 1
    ref = plain(geom, color, tile_start, rspec, shv)
    torch.testing.assert_close(out, ref, atol=TOL, rtol=0)
    counts = torch.diff(tile_start)
    assert bool((counts == 0).any()) and bool((out[counts == 0] == 0).all())
    assert float(out[:, 3].max()) > 0
    again = kernel(geom, color, tile_start, rspec, shv)
    assert torch.equal(again, out)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 8, 12])
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("name", FWD_ENTRY_POINTS)
def test_fwd_kernels_on_tile_shapes(cuda, name, opaque, tile):
    # 16x16 tiles: two warps (RGB, 4 pixels a thread) or four (SH, 2); 8x8:
    # one warp whose threads' last pixel slots lie past the tile; 12x12
    # (144 pixels): slots past the tile in the last warp; > 256 pairs in
    # tile (0, 0), several staged batches
    geom, color, start, rspec, shv = _fwd_pairs(cuda, name, opaque, tile,
                                                False)
    assert int(torch.diff(start).max()) > 256
    _check_fwd(name, geom, color, start, rspec, shv)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 12])
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("name", FWD_ENTRY_POINTS)
def test_fwd_kernels_ragged_tiles(cuda, name, opaque, tile):
    # tiles of one pair, of one more than a staged batch, none, and 33
    geom, color, start, rspec, shv = _fwd_pairs(cuda, name, opaque, tile,
                                                True)
    assert torch.diff(start).tolist() == list(RAGGED_COUNTS)
    assert FWD_BATCH + 1 in RAGGED_COUNTS
    _check_fwd(name, geom, color, start, rspec, shv)


@pytest.mark.cuda
def test_defaults_put_the_port_on_the_card(cuda):
    table = synthetic.synthetic_table(300, capacity_round=128)
    cams = synthetic.synthetic_cameras(1, 48, 32, 40.0)
    assert table.device.type == "cuda" and cams["images"].is_cuda
    assert lrs_at(TrainConfig(), 500).is_cuda


@pytest.mark.cuda
def test_eval_step_preset_sh_on_cuda_matches_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      use_sh=True, sh_ampl=0.35,
                                      device="cpu")
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0, device="cpu")
    imgs = []
    for dev in ("cpu", cuda):
        t = table.to(dev)
        splat = Splatter.from_scene(SplatConfig(use_sh_coeff=True), t, [
            SceneCameras(w2c_rot=cams["w2c_rot"].to(dev),
                         w2c_tran=cams["w2c_tran"].to(dev),
                         sh_vecs=cams["sh_vecs"].to(dev),
                         images=cams["images"].to(dev), grid=cams["grid"],
                         names=["a", "b"])])
        before = LAUNCHES["rasterize_fwd_preset_sh"]
        img, p, s = make_eval_step(splat, preset=True)(t.params(), t.live, 1)
        assert LAUNCHES["rasterize_fwd_preset_sh"] - before == (
            0 if dev == "cpu" else 1)
        imgs.append(img.cpu())
    torch.testing.assert_close(imgs[1], imgs[0], atol=TOL, rtol=0)


@pytest.mark.cuda
def test_adaptive_control_on_cuda_matches_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=1024, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      device="cpu")
    rng = np.random.default_rng(3)
    grad = torch.from_numpy(np.abs(rng.normal(0, 3e-4, (table.capacity, 3)))
                            .astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(table.capacity, 2, 3))
                           .astype(np.float32))
    kw = dict(taus=0.2, delete_thresh=0.5, grad_thresh=2e-4, clone_dt=0.01,
              use_clone=True, use_split=True)
    (tc, sc), (tg, sg) = (adaptive_control(table.to(d), grad.to(d),
                                           eps.to(d), **kw)
                          for d in ("cpu", cuda))
    assert sc == sg and sc.n_split > 0 and sc.n_cloned > 0
    assert sc.n_deleted > 0 and sc.overflowed
    assert torch.equal(tg.live.cpu(), tc.live) and tg.n_live == tc.n_live
    for k in ("pos", "rgb", "opa", "quat", "scale"):
        a, b = getattr(tg, k).cpu(), getattr(tc, k)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 *
                                   float(b.abs().max()), msg=k)


@pytest.mark.cuda
def test_sh_train_step_and_offscreen_on_cuda_match_cpu(cuda):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      use_sh=True, sh_ampl=0.35,
                                      device="cpu")
    cams = synthetic.synthetic_cameras(2, 160, 112, 100.0, device="cpu")
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
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      device="cpu")
    cams = synthetic.synthetic_cameras(1, 160, 112, 100.0, device="cpu")
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


@pytest.mark.cuda
def test_scene_generator_on_cuda_matches_cpu(cuda, tmp_path):
    # the garden_hard kind of scene at a small size: orbit cameras, SH
    # ground truth with view-dependent bands, sensor noise
    from gsplat_tpu_torch.scripts import make_synth_scene
    from gsplat_tpu_torch.utils.image_io import read_png

    kw = dict(n_gt=20_000, n_points=2_000, n_cams=4, w=160, h=120,
              focal=150.0, capacity_round=4096, scale_px=1.6, opa=0.6,
              orbit=True, use_sh=True, sh_ampl=0.35, noise_std=2.0)
    dirs = {d: str(tmp_path / str(d)) for d in ("cpu", "cuda")}
    before = LAUNCHES["rasterize_fwd_sh"]
    built = {d: make_synth_scene.main(p, device=d, log=lambda msg: None,
                                      **kw) for d, p in dirs.items()}
    assert LAUNCHES["rasterize_fwd_sh"] - before == kw["n_cams"]
    assert [v["n_pairs"] for v in built["cuda"]["views"]] == \
        [v["n_pairs"] for v in built["cpu"]["views"]]
    differ = 0
    for i in range(kw["n_cams"]):
        a, b = (read_png(f"{dirs[d]}/images_4/img_{i:03d}.png").astype(int)
                for d in ("cpu", "cuda"))
        # the kernel and the plain forward differ by at most TOL: a value
        # next to a rounding boundary lands 1 LSB apart
        assert np.abs(a - b).max() <= 1
        differ += int((a != b).sum())
    assert differ <= 1e-3 * kw["n_cams"] * kw["w"] * kw["h"] * 3
    assert abs(built["cuda"]["oracle_ceiling_psnr"]
               - built["cpu"]["oracle_ceiling_psnr"]) <= 0.01
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        with open(f"{dirs['cpu']}/sparse/0/{name}", "rb") as f, \
                open(f"{dirs['cuda']}/sparse/0/{name}", "rb") as g:
            assert f.read() == g.read(), name


def _card_splat(cuda, **cfg_kw):
    table = synthetic.synthetic_table(3000, capacity_round=4096, focal=100.0,
                                      scale_px=3.0, frustum=(0.85, 0.55),
                                      device=cuda)
    cams = synthetic.synthetic_cameras(1, 160, 128, 100.0, device=cuda)
    return Splatter.from_scene(SplatConfig(**cfg_kw), table, [SceneCameras(
        w2c_rot=cams["w2c_rot"], w2c_tran=cams["w2c_tran"],
        sh_vecs=cams["sh_vecs"], images=None, grid=cams["grid"],
        names=["a"])])


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
def test_viewer_frame_is_render_offscreens(cuda, fast):
    # the pushed frame (pinned copy, event, double buffer) is the render of
    # its camera bit for bit
    from gsplat_tpu_torch.viewer import (camera_to_w2c, run_viewer,
                                         snap_resolution)

    splat = _card_splat(cuda)
    name = "rasterize_fwd_preset" if fast else "rasterize_fwd"
    srv = FakeServer(values={"Resolution": 256, "Fast Mode (bf16)": fast})
    before = LAUNCHES[name]
    run_viewer(splat, server=srv, max_iters=1)
    assert LAUNCHES[name] - before == 1 and len(srv.client.images) == 1
    w, h, fov = snap_resolution(256, 1.5, 1.0)
    cam = srv.client.camera
    ref = render_offscreen(splat, camera_to_w2c(cam.wxyz, cam.position), w,
                           h, w / 2 / np.tan(fov / 2), h / 2 / np.tan(fov / 2),
                           near=0.3, far=1000.0, sh_order=3, fast=fast)
    img = srv.client.images[0]
    assert img.shape == (h, w, 3) and img.max() > 0.1
    np.testing.assert_array_equal(img, ref)


@pytest.mark.cuda
def test_bands_on_cuda_match_the_full_render(cuda):
    from gsplat_tpu_torch.models.splatter import render_padded
    from gsplat_tpu_torch.parallel.tile_parallel import \
        make_tile_sharded_render

    splat = _card_splat(cuda, tile_culling_prob_thresh=1e-6,
                        max_tiles_per_gaussian=64)
    c = splat.cameras
    args = (splat.table.params(), splat.table.live, c.w2c_rot[0],
            c.w2c_tran[0])
    before = LAUNCHES["rasterize_fwd"]
    bands = make_tile_sharded_render(c.grid, splat.cfg, 2)(*args)
    assert LAUNCHES["rasterize_fwd"] - before == 2
    bspec, rspec = splat.specs(c.grid)
    full, _ = render_padded(*args, c.grid, splat.cfg, bspec, rspec)
    assert bands.shape == full.shape == (3, 128, 160)
    torch.testing.assert_close(bands, full, atol=TOL, rtol=0)


@pytest.mark.cuda
def test_bench_runs_on_the_card(cuda, capsys, monkeypatch):
    # python -m gsplat_tpu_torch.bench at a small size: one JSON line, no
    # error, every phase, the kernels of its path launched
    import json

    from gsplat_tpu_torch import bench

    monkeypatch.setattr(bench, "CARD", dict(
        n_gauss=20_000, w=320, h=240, focal=260.0, m_cams=4, k_small=2,
        k_big=4))
    monkeypatch.setattr(bench, "MAX_REPS_CARD", 3)
    assert bench.main(["--device", "cuda"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert "error" not in out and out["phase_done"] == "psnr_burst"
    assert out["backend"] == "cuda" and out["value"] > 0
    assert out["preset_vs_f32_psnr"] > 40
    assert out["psnr_after_burst"] > out["psnr_before_burst"]
    for name in ("rasterize_fwd", "rasterize_fwd_preset", "rasterize_bwd"):
        assert out["launches"].get(name, 0) > 0, name
