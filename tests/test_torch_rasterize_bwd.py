"""The compositor's backward, PyTorch port vs autograd and vs the JAX package.

``composite_tiles_bwd_torch`` computes JAX's backward formulas (the
suffix-color identity), so it is held against autograd through the plain
forward ``composite_tiles_torch``; then the per-gaussian gradients of the
port's pack + composite (``CompositeTiles`` on the CPU) are held against
``jax.grad`` through JAX's ``pack_sorted`` + ``composite_chunks_jnp`` and +
``composite_chunks_pallas`` in interpret mode.  Cases from the reference's
fault history: a tile of more than one kernel batch (> 256 pairs) or chunk
(> 128), an empty tile, near-opaque early stop and weight normalisation
(a nonzero Σw cotangent).

Absolute tolerances are a fraction of each gradient column's largest
magnitude (``torch_helpers.assert_close_cols``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.binning import BinningSpec as JSpec
from gsplat_tpu.ops.binning import pack_sorted as j_pack
from gsplat_tpu.ops.rasterize import RasterSpec as JRSpec
from gsplat_tpu.ops.rasterize import rasterize as j_rasterize

from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
from gsplat_tpu_torch.ops.binning import pack_sorted as t_pack
from gsplat_tpu_torch.ops.rasterize import RasterSpec as TRSpec
from gsplat_tpu_torch.ops.rasterize import (LAUNCHES, composite_tiles,
                                            composite_tiles_bwd,
                                            composite_tiles_bwd_torch,
                                            composite_tiles_torch, rasterize)

from torch_helpers import (BIG_CROWD, TILE, assert_close_cols,
                           image_space_pairs)

torch.set_num_threads(1)
FOCAL = 40.0
K = 6


def _scene(seed, opaque, **kw):
    geom, color, depth, visible, geo = image_space_pairs(seed, focal=FOCAL,
                                                         **kw)
    if opaque:
        # near-opaque: transmittance falls below 1e-4 within a few layers
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    return geom, color, depth, visible, geo


def _cotangent(seed, spec, wn):
    rng = np.random.default_rng(seed)
    go = rng.normal(size=(spec.n_tiles, 4, spec.px)).astype(np.float32)
    if not wn:
        go[:, 3] = 0.0
    return torch.from_numpy(go)


@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_bwd_plain_matches_autograd(opaque, wn):
    geom, color, depth, visible, geo = _scene(0, opaque, **BIG_CROWD)
    spec = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL)
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K),
                    *map(torch.from_numpy, (geom, color, depth, visible)))
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 256 and (counts == 0).any()
    g = packed.geom.clone().requires_grad_()
    c = packed.color.clone().requires_grad_()
    out = composite_tiles_torch(g, c, packed.tile_start, spec)
    go = _cotangent(1, spec, wn)
    ga, gc = torch.autograd.grad((out * go).sum(), [g, c])
    gb, gcb = composite_tiles_bwd_torch(packed.geom, packed.color,
                                        packed.tile_start, out.detach(), go,
                                        spec)
    assert (gb[:, 7] == 0).all()
    # Not the same arithmetic: autograd runs the cumprod's backward, the
    # plain backward JAX's suffix identity, which divides g·(out − C_incl)
    # by 1 − α + 1e-7 and so amplifies its f32 rounding up to 1e4x where
    # α → 0.9999.  Against a float64 autograd it is off by up to
    # 3.4e-5·colmax; against this f32 autograd up to 7.2e-5·colmax
    # (near-opaque with weight normalisation).
    assert_close_cols(gb.numpy(), ga.numpy(), 1e-4, 1e-4, "grad_geom")
    assert_close_cols(gcb.numpy(), gc.numpy(), 1e-4, 1e-4, "grad_color")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("opaque,wn", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_grads_match_jax(opaque, wn, use_pallas):
    geom, color, depth, visible, geo = _scene(3, opaque)
    n, n_tiles = geom.shape[0], geo["n_tile_x"] * geo["n_tile_y"]
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 weight_normalize=wn)
    jrs = JRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 128, 3, weight_normalize=wn, channel_major=True)
    jspec = JSpec(**geo, max_tiles_per_gaussian=K,
                  slot_capacity=(n * K // 128 + n_tiles + 1) * 128,
                  chunk_size=128)
    gkey = np.random.default_rng(2).normal(
        size=(3, trs.padded_h, trs.padded_w)).astype(np.float32)

    tg = torch.from_numpy(geom).requires_grad_()
    tc = torch.from_numpy(color).requires_grad_()
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K), tg, tc,
                    torch.from_numpy(depth), torch.from_numpy(visible))
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 128 and (counts == 0).any()
    (rasterize(packed, trs) * torch.from_numpy(gkey)).sum().backward()

    def j_loss(g, c):
        jpk, meta = j_pack(jspec, g, c, jnp.asarray(depth),
                           jnp.asarray(visible))
        img = j_rasterize(jpk, meta, jrs, use_pallas=use_pallas,
                          interpret=use_pallas)
        return jnp.sum(img * gkey)

    jg, jc = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(geom),
                                                       jnp.asarray(color))
    assert (tg.grad[:, 7] == 0).all() and (np.asarray(jg)[:, 7] == 0).all()
    # per gaussian, the bound of tests/test_rasterize.py:96 (Pallas vs
    # autodiff), its atol taken relative to each column's largest gradient
    assert_close_cols(tg.grad.numpy(), jg, 3e-4, 2e-3, "geom")
    assert_close_cols(tc.grad.numpy(), jc, 3e-4, 2e-3, "color")


def test_composite_tiles_is_differentiable_on_cpu():
    # the autograd boundary: composite_tiles → CompositeTiles, whose CPU
    # backward is the plain version and launches no kernel
    geom, color, depth, visible, geo = _scene(4, False)
    spec = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL)
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K),
                    *map(torch.from_numpy, (geom, color, depth, visible)))
    g = packed.geom.clone().requires_grad_()
    c = packed.color.clone().requires_grad_()
    before = dict(LAUNCHES)
    out = composite_tiles(g, c, packed.tile_start, spec)
    assert out.grad_fn is not None
    go = _cotangent(5, spec, True)
    (out * go).sum().backward()
    ref = composite_tiles_bwd_torch(packed.geom, packed.color,
                                    packed.tile_start, out.detach(), go, spec)
    torch.testing.assert_close(g.grad, ref[0], atol=0, rtol=0)
    torch.testing.assert_close(c.grad, ref[1], atol=0, rtol=0)
    assert LAUNCHES == before


def test_bwd_wrapper_checks():
    spec = TRSpec(2, 1, TILE, TILE, FOCAL, FOCAL)
    start = torch.zeros(3, dtype=torch.int32)
    rows = torch.zeros(2, 4, 256)
    with pytest.raises(ValueError, match="CPU tensors"):
        composite_tiles_bwd(torch.zeros(0, 8), torch.zeros(0, 3), start,
                            rows, rows.to("meta"), spec)
    with pytest.raises(ValueError, match="grad_out"):
        composite_tiles_bwd(torch.zeros(0, 8), torch.zeros(0, 3), start,
                            rows, rows[:1], spec)
    with pytest.raises(TypeError, match="out"):
        composite_tiles_bwd(torch.zeros(0, 8), torch.zeros(0, 3), start,
                            rows.double(), rows, spec)
    gg, gc = composite_tiles_bwd(torch.zeros(0, 8), torch.zeros(0, 3), start,
                                 rows, rows, spec)
    assert gg.shape == (0, 8) and gc.shape == (0, 3)
