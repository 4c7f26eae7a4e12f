"""PyTorch port vs the JAX package: tiled compositing.

The port's plain compositor ``composite_tiles_torch`` takes the port's pack;
JAX's ``composite_chunks_jnp`` and ``composite_chunks_pallas`` (interpret
mode, as the JAX tests run it) take JAX's chunk-aligned pack of the same
gaussians.  The per-tile rows must agree within atol/rtol 1e-5 (the bound of
tests/test_rasterize.py:66-69: only the summation order differs), and the
assembled image must match both naive oracles within atol 2e-4 / rtol 1e-3.
Cases from the reference's fault history: tiles of several chunks, an empty
tile, near-opaque early stop, and weight normalisation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.binning import BinningSpec as JSpec
from gsplat_tpu.ops.binning import pack_sorted as j_pack
from gsplat_tpu.ops.rasterize import RasterSpec as JRSpec
from gsplat_tpu.ops.rasterize import (composite_chunks_jnp,
                                      composite_chunks_pallas)
from gsplat_tpu.ops.rasterize import rasterize as j_rasterize
from gsplat_tpu.ops.rasterize_ref import rasterize_oracle as j_oracle

from gsplat_tpu_torch.ops import cuda_build
from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
from gsplat_tpu_torch.ops.binning import pack_sorted as t_pack
from gsplat_tpu_torch.ops.rasterize import RasterSpec as TRSpec
from gsplat_tpu_torch.ops.rasterize import (LAUNCHES, composite_tiles,
                                            composite_tiles_torch, rasterize)
from gsplat_tpu_torch.ops.rasterize_ref import rasterize_oracle as t_oracle

from torch_helpers import TILE, image_space_pairs

torch.set_num_threads(1)
FOCAL = 40.0


def _scene(seed, opaque, n_tile_x=4, **kw):
    geom, color, depth, visible, geo = image_space_pairs(
        seed, n_tile_x=n_tile_x, focal=FOCAL, **kw)
    if opaque:
        # near-opaque: transmittance falls below 1e-4 within a few layers
        geom[:, 6] = np.minimum(geom[:, 6] * 10.0, 0.999)
    return geom, color, depth, visible, geo


def _specs(geo, k, thresh, wn):
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    tspec = TSpec(**geo, max_tiles_per_gaussian=k, thresh=thresh)
    trs = TRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 weight_normalize=wn)
    jrs = JRSpec(geo["n_tile_x"], geo["n_tile_y"], TILE, TILE, FOCAL, FOCAL,
                 128, 3, weight_normalize=wn, channel_major=True)
    return n_tiles, tspec, trs, jrs


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_composite_matches_jax(opaque, wn):
    geom, color, depth, visible, geo = _scene(0, opaque)
    k = 6
    n_tiles, tspec, trs, jrs = _specs(geo, k, 0.05, wn)
    packed = t_pack(tspec, *_t(geom, color, depth, visible))
    out = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                trs).numpy()
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 128 and (counts == 0).any()

    n = geom.shape[0]
    jspec = JSpec(**geo, max_tiles_per_gaussian=k,
                  slot_capacity=(n * k // 128 + n_tiles + 1) * 128,
                  chunk_size=128)
    jpk, meta = j_pack(jspec, *map(jnp.asarray, (geom, color, depth,
                                                 visible)))
    ok = np.asarray(meta.tile_ok)[:n_tiles]
    col_j, w_j = composite_chunks_jnp(jpk, meta.chunk_tile, meta.chunk_first,
                                      meta.chunk_len, jrs)
    col_p, w_p = composite_chunks_pallas(
        jpk, meta.chunk_tile, meta.chunk_first, meta.chunk_last,
        meta.chunk_len, jrs, interpret=True, tile_ok=meta.tile_ok)
    for col, w in ((col_j, w_j), (col_p, w_p)):
        col = np.where(ok[:, None, None], np.asarray(col)[:n_tiles, :3], 0.0)
        w = np.where(ok[:, None], np.asarray(w)[:n_tiles], 0.0)
        np.testing.assert_allclose(out[:, :3], col, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(out[:, 3], w, atol=1e-5, rtol=1e-5)
    img_t = rasterize(packed, trs).numpy()
    img_j = np.asarray(j_rasterize(jpk, meta, jrs, use_pallas=False))
    np.testing.assert_allclose(img_t, img_j, atol=1e-5, rtol=1e-5)
    if opaque:
        assert (out[:, 3] > 0.999).any(), "needs saturated pixels"


@pytest.mark.parametrize("wn", [False, True])
@pytest.mark.parametrize("opaque", [False, True])
def test_image_matches_oracles(opaque, wn):
    # 5 tile columns, no wide splats: column 4 stays empty even with the
    # 1e-6 culling threshold, and K covers every tile (nothing clipped)
    geom, color, depth, visible, geo = _scene(1, opaque, n_tile_x=5,
                                              n=300, wide=False)
    visible[9] = False                    # the oracle has no det <= 0 guard
    n_tiles, tspec, trs, _ = _specs(geo, 15, 1e-6, wn)
    packed = t_pack(tspec, *_t(geom, color, depth, visible))
    assert int(packed.n_clipped) == 0
    counts = np.diff(packed.tile_start.numpy())
    assert counts.max() > 128 and (counts == 0).any()
    img = rasterize(packed, trs).numpy()

    idx = np.argsort(np.where(visible, depth, np.inf), kind="stable")
    idx = idx[visible[idx]]
    args = (geom[idx, :2], geom[idx, 2:6], geom[idx, 6], color[idx])
    h, w = trs.padded_h, trs.padded_w
    ref_t = t_oracle(*_t(*args), h, w, FOCAL, FOCAL, weight_normalize=wn)
    ref_j = j_oracle(*map(jnp.asarray, args), h, w, FOCAL, FOCAL,
                     weight_normalize=wn)
    np.testing.assert_allclose(img, ref_t.numpy(), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(img, np.asarray(ref_j), atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j), atol=1e-5,
                               rtol=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    geom, color, depth, visible, geo = _scene(2, False)
    _, tspec, trs, _ = _specs(geo, 6, 0.05, False)
    packed = t_pack(tspec, *_t(geom, color, depth, visible))
    before = dict(LAUNCHES)
    out = composite_tiles(packed.geom, packed.color, packed.tile_start, trs)
    ref = composite_tiles_torch(packed.geom, packed.color, packed.tile_start,
                                trs)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert LAUNCHES == before                     # no kernel on the CPU


def test_wrapper_refuses_other_devices():
    trs = TRSpec(2, 1, TILE, TILE, FOCAL, FOCAL)
    meta = dict(device="meta")
    cases = [
        (torch.empty(4, 8, **meta), torch.empty(4, 3, **meta),
         torch.zeros(3, dtype=torch.int32, **meta)),
        (torch.zeros(4, 8), torch.zeros(4, 3, **meta),
         torch.zeros(3, dtype=torch.int32)),
    ]
    before = dict(LAUNCHES)
    for geom, color, start in cases:
        with pytest.raises(ValueError, match="CPU tensors"):
            composite_tiles(geom, color, start, trs)
    assert LAUNCHES == before


def test_input_checks():
    trs = TRSpec(2, 1, TILE, TILE, FOCAL, FOCAL)
    start = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        composite_tiles(torch.zeros(0, 8, dtype=torch.float64),
                        torch.zeros(0, 3), start, trs)
    with pytest.raises(TypeError):
        composite_tiles(torch.zeros(0, 8), torch.zeros(0, 3),
                        start.to(torch.int64), trs)
    with pytest.raises(ValueError):
        composite_tiles(torch.zeros(0, 8), torch.zeros(0, 3),
                        torch.zeros(4, dtype=torch.int32), trs)
    out = composite_tiles(torch.zeros(0, 8), torch.zeros(0, 3), start, trs)
    assert out.shape == (2, 4, 256) and (out == 0).all()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.find_nvcc()
    # no library built yet: loading must build, and the build must raise
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.load_kernel_library("rasterize_fwd")
    assert not (tmp_path / "_build").exists()
