"""The compositor's forward on the CPU, at the tile shapes of the forward
kernels' card tests (``tests/test_torch_cuda.py``): the plain twins that
those tests hold the kernels against, checked here against references.

- ``composite_tiles_torch`` against JAX's ``composite_chunks_jnp`` on 8x8
  tiles (a 64-pixel tile, one warp of the kernel whose threads' last pixel
  slots lie past the tile), RGB and SH, atol/rtol 1e-5 (the bound of
  ``tests/test_torch_rasterize.py``: only the summation order differs);
- ``composite_tiles_torch`` and the preset's ``composite_tiles_preset_torch``
  on the ragged scene (tiles of 1, 65, 0 and 33 pairs: one more than a
  staged batch of either kernel) at 16x16 and 12x12 tiles (144 pixels, not a
  whole number of the kernel's warps), against a float64 numpy loop over
  each tile's pairs written below, atol 1e-5.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.binning import BinningSpec as JSpec
from gsplat_tpu.ops.binning import pack_sorted as j_pack
from gsplat_tpu.ops.rasterize import RasterSpec as JRSpec
from gsplat_tpu.ops.rasterize import composite_chunks_jnp

from gsplat_tpu_torch.ops import sh as tsh
from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
from gsplat_tpu_torch.ops.binning import pack_preset, pack_sorted as t_pack
from gsplat_tpu_torch.ops.rasterize import RasterSpec as TRSpec
from gsplat_tpu_torch.ops.rasterize import (composite_tiles_preset_torch,
                                            composite_tiles_torch)
from gsplat_tpu_torch.synthetic import image_space_sh

from torch_helpers import (FWD_BATCH, RAGGED_COUNTS, image_space_pairs,
                           ragged_pairs)

torch.set_num_threads(1)
FOCAL = 40.0
K = 6


def _opaque(geom):
    # near-opaque: transmittance falls below 1e-4 within a few layers
    geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("sh", [False, True])
def test_plain_fwd_matches_jax_on_8px_tiles(sh, opaque):
    tile = 8
    geom, color, depth, visible, geo = image_space_pairs(3, focal=FOCAL,
                                                         tile=tile)
    if opaque:
        _opaque(geom)
    shv = None
    if sh:
        color, shv = image_space_sh(3, color, geo, FOCAL, tile=tile)
    n, n_tiles = geom.shape[0], geo["n_tile_x"] * geo["n_tile_y"]
    cd = color.shape[1]
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, FOCAL, FOCAL,
                 color_dim=cd)
    jrs = JRSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, FOCAL, FOCAL,
                 128, cd, channel_major=True)
    jspec = JSpec(**geo, max_tiles_per_gaussian=K,
                  slot_capacity=(n * K // 128 + n_tiles + 1) * 128,
                  chunk_size=128)
    packed = t_pack(TSpec(**geo, max_tiles_per_gaussian=K),
                    *map(torch.from_numpy, (geom, color, depth, visible)))
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 128 and (counts == 0).any()
    out = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                trs, None if shv is None
                                else torch.from_numpy(shv)).numpy()

    jpk, meta = j_pack(jspec, *map(jnp.asarray, (geom, color, depth,
                                                 visible)))
    # JAX marks the tiles it holds no chunk for (the empty ones) not ok
    ok = np.asarray(meta.tile_ok)[:n_tiles]
    assert (ok == (counts > 0)).all()
    col, w = composite_chunks_jnp(jpk, meta.chunk_tile, meta.chunk_first,
                                  meta.chunk_len, jrs,
                                  sh_vecs=None if shv is None
                                  else jnp.asarray(shv))
    col = np.where(ok[:, None, None], np.asarray(col)[:n_tiles, :3], 0.0)
    w = np.where(ok[:, None], np.asarray(w)[:n_tiles], 0.0)
    np.testing.assert_allclose(out[:, :3], col, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(out[:, 3], w, atol=1e-5, rtol=1e-5)
    assert (out[counts == 0] == 0).all()
    if opaque:
        assert (out[:, 3] > 0.999).any(), "needs saturated pixels"


def _basis_f64(shv, fx, fy):
    """The SH basis (9, Px) of pixels (fx, fy) on the padded grid, float64
    (the expressions of ``ops/rasterize._sh_pixel_basis``)."""
    v = shv.astype(np.float64)
    comps = [v[1, k] + fx * v[2, k] + fy * v[3, k] - v[0, k]
             for k in range(3)]
    inv = 1.0 / (np.sqrt(sum(c * c for c in comps)) + 1e-7)
    x, y, z = (c * inv for c in comps)
    c2 = tsh.C2
    return np.stack([np.full_like(x, tsh.C0), -tsh.C1 * y, tsh.C1 * z,
                     -tsh.C1 * x, c2[0] * x * y, c2[1] * y * z,
                     c2[2] * (2 * z * z - x * x - y * y), c2[3] * x * z,
                     c2[4] * (x * x - y * y)])


def _composite_f64(geom, color, tile_start, spec, shv=None, relative=False):
    """The compositor in float64: for each tile its pairs in order, for each
    pixel w = α·T while T ≥ 1e-4, the stop tested before the pair.  The
    pixels of a tile are independent, so each pair is one numpy step over
    them.  ``relative``: the preset's tile-relative pixel centres."""
    g = geom.astype(np.float64)
    c = color.astype(np.float64)
    out = np.zeros((spec.n_tiles, 4, spec.px))
    p = np.arange(spec.px)
    for t in range(spec.n_tiles):
        tx, ty = t % spec.n_tile_x, t // spec.n_tile_x
        fx = tx * spec.tile_w + p % spec.tile_w
        fy = ty * spec.tile_h + p // spec.tile_w
        pxc = (fx + 0.5 - spec.padded_w / 2) / spec.focal_x
        pyc = (fy + 0.5 - spec.padded_h / 2) / spec.focal_y
        if relative:
            pxc -= (tx * spec.tile_w + spec.tile_w / 2
                    - spec.padded_w / 2) / spec.focal_x
            pyc -= (ty * spec.tile_h + spec.tile_h / 2
                    - spec.padded_h / 2) / spec.focal_y
        basis = None if shv is None else _basis_f64(shv, fx, fy)
        trans = np.ones(spec.px)
        for i in range(tile_start[t], tile_start[t + 1]):
            x, y, a, b, cc, d, opa = g[i, :7]
            dx, dy = pxc - x, pyc - y
            pm = -(d * dx * dx - (b + cc) * dx * dy + a * dy * dy)
            prob = np.exp(pm / (2.0 * (a * d - b * cc) + 1e-14))
            alpha = np.minimum(prob * opa, 0.9999)
            w = np.where(trans >= 1e-4, alpha * trans, 0.0)
            if basis is None:
                cols = c[i, :3, None]
            else:
                logits = c[i, :27].reshape(3, 9) @ basis
                cols = 1.0 / (1.0 + np.exp(-logits))
            out[t, :3] += w * cols
            out[t, 3] += w
            trans = np.where(trans >= 1e-4, trans * (1.0 - alpha), trans)
    return out


@pytest.mark.parametrize("tile", [16, 12])
@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("sh", [False, True])
@pytest.mark.parametrize("preset", [False, True])
def test_plain_fwd_matches_float64_on_ragged_tiles(preset, sh, opaque, tile):
    geom, color, start, geo, shv = ragged_pairs(0, tile, sh=sh)
    assert list(np.diff(start)) == list(RAGGED_COUNTS)
    assert FWD_BATCH + 1 in RAGGED_COUNTS
    if opaque:
        _opaque(geom)
    spec = TRSpec(geo["n_tile_x"], geo["n_tile_y"], tile, tile, FOCAL, FOCAL,
                  color_dim=color.shape[1])
    tshv = None if shv is None else torch.from_numpy(shv)
    pairs = types.SimpleNamespace(geom=torch.from_numpy(geom),
                                  color=torch.from_numpy(color),
                                  tile_start=torch.from_numpy(start))
    if preset:
        pairs = pack_preset(TSpec(**geo, max_tiles_per_gaussian=K), pairs)
        out = composite_tiles_preset_torch(pairs.geom, pairs.color,
                                           pairs.tile_start, spec, tshv)
        # the reference takes the same bf16 values, widened
        geom = pairs.geom.float().numpy()
        color = pairs.color[:, :color.shape[1]].float().numpy()
    else:
        out = composite_tiles_torch(pairs.geom, pairs.color,
                                    pairs.tile_start, spec, tshv)
    ref = _composite_f64(geom, color, start, spec, shv, relative=preset)
    out = out.numpy()
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
    counts = np.diff(start)
    assert (out[counts == 0] == 0).all()
    assert (out[counts > 0, 3] > 0).any()
    if opaque:
        assert (out[:, 3] > 0.999).any(), "needs saturated pixels"
