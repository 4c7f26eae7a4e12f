"""PyTorch port vs the JAX package: tile binning and the depth-ordered pack.

The same image-space gaussians go through the port's ``pack_sorted`` and
JAX's dense-plane ``pack_sorted`` (exact depth ranks, f32).  JAX's buffers
are chunk-aligned with pad lanes; stripped through ``chunk_len`` and
``chunk_tile`` they must give, tile by tile, EXACTLY the port's pair rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu.ops.binning import BinningSpec as JSpec
from gsplat_tpu.ops.binning import pack_sorted as j_pack

from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
from gsplat_tpu_torch.ops.binning import pack_sorted as t_pack

from torch_helpers import DIVISION_SITES, TILE, division_rows, \
    image_space_pairs

torch.set_num_threads(1)

def jax_tile_rows(geom, color, depth, visible, geo, k, method, thresh):
    """JAX dense pack → per-tile (geom rows, color rows, counters)."""
    n = geom.shape[0]
    n_tiles = geo["n_tile_x"] * geo["n_tile_y"]
    spec = JSpec(**geo, max_tiles_per_gaussian=k,
                 slot_capacity=(n * k // 128 + n_tiles + 1) * 128,
                 chunk_size=128, method=method, thresh=thresh,
                 plane_mode="dense")
    (g_s, c_s), meta = j_pack(spec, jnp.asarray(geom), jnp.asarray(color),
                              jnp.asarray(depth), jnp.asarray(visible))
    g_s, c_s = np.asarray(g_s).T, np.asarray(c_s).T
    assert int(meta.n_dropped) == 0
    rows = {t: ([], []) for t in range(n_tiles)}
    for c, (t, ln) in enumerate(zip(np.asarray(meta.chunk_tile),
                                    np.asarray(meta.chunk_len))):
        if t < n_tiles:
            rows[t][0].append(g_s[c * 128:c * 128 + ln])
            rows[t][1].append(c_s[c * 128:c * 128 + ln, :3])
    rows = {t: (np.concatenate(g) if g else np.zeros((0, 8), np.float32),
                np.concatenate(c) if c else np.zeros((0, 3), np.float32))
            for t, (g, c) in rows.items()}
    return rows, meta


@pytest.mark.parametrize("method,thresh,k", [
    ("prob2", 0.05, 3),
    ("prob2", 0.05, 6),
    ("prob", 0.01, 4),
    ("dist", (TILE / 40.0 / 0.5) ** 2, 4),
])
@pytest.mark.parametrize("seed", [0, 1])
def test_pack_matches_jax_dense_exactly(seed, method, thresh, k):
    geom, color, depth, visible, geo = image_space_pairs(seed)
    rows, meta = jax_tile_rows(geom, color, depth, visible, geo, k, method,
                               thresh)
    spec = TSpec(**geo, max_tiles_per_gaussian=k, method=method,
                 thresh=thresh)
    out = t_pack(spec, torch.from_numpy(geom), torch.from_numpy(color),
                 torch.from_numpy(depth), torch.from_numpy(visible))
    ts = out.tile_start.numpy()
    assert out.tile_start.dtype == torch.int32
    assert ts[0] == 0 and ts[-1] == out.geom.shape[0]
    for t, (jg, jc) in rows.items():
        np.testing.assert_array_equal(out.geom[ts[t]:ts[t + 1]].numpy(), jg,
                                      err_msg=f"tile {t}")
        np.testing.assert_array_equal(out.color[ts[t]:ts[t + 1]].numpy(), jc,
                                      err_msg=f"tile {t}")
    for f in ("n_pairs", "n_clipped", "n_visible", "n_max_tiles"):
        assert int(getattr(out, f)) == int(getattr(meta, f)), f
    counts = np.diff(ts)
    # the scene covers what the contract cares about
    assert counts.max() > 128, "needs a multi-chunk tile"
    assert (counts == 0).any(), "needs an empty tile"
    if method != "dist":
        assert int(out.n_clipped) > 0, "needs gaussians clipped by K"


def test_pack_all_invisible():
    geom, color, depth, visible, geo = image_space_pairs(0, n=50)
    spec = TSpec(**geo, max_tiles_per_gaussian=4)
    out = t_pack(spec, torch.from_numpy(geom), torch.from_numpy(color),
                 torch.from_numpy(depth), torch.zeros(50, dtype=torch.bool))
    assert out.geom.shape == (0, 8) and out.color.shape == (0, 3)
    assert (out.tile_start == 0).all()
    assert int(out.n_pairs) == int(out.n_visible) == 0
    assert int(out.n_max_tiles) == 0


def test_tile_boxes_at_tile_boundaries_match_jax():
    # box edges a few ulps either side of a tile boundary: the floor of
    # each quotient decides the box, so the division must round as JAX's
    from gsplat_tpu.ops.binning import _tile_bbox_rows as j_rows
    from gsplat_tpu_torch.ops.binning import _tile_bbox_rows as t_rows
    from torch_helpers import bbox_boundary_rows

    geo, *rows = bbox_boundary_rows(0)
    j = j_rows(JSpec(**geo, max_tiles_per_gaussian=6, slot_capacity=128,
                     chunk_size=128), *map(jnp.asarray, rows))
    t = t_rows(TSpec(**geo, max_tiles_per_gaussian=6),
               *map(torch.from_numpy, rows))
    for jv, tv in zip(j, t):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the rows straddle boundaries: neighbouring quotients floor apart
    x0 = t[0].numpy()
    assert len(np.unique(x0)) > 40 and (t[2].numpy() >= 1).all()


def test_tile_boxes_divide_where_a_reciprocal_multiply_differs():
    # a CUDA tensor / Python number multiplies by the f32 reciprocal; on
    # these rows that floors hundreds of box edges a tile away from the
    # division, so the card test of the same rows
    # (test_torch_cuda.py::test_tile_boxes_on_cuda_match_cpu) can see it
    from gsplat_tpu_torch.ops.binning import _tile_bbox_rows as t_rows
    from gsplat_tpu_torch.ops.binning import div_rn
    from torch_helpers import bbox_boundary_rows

    geo, *rows = bbox_boundary_rows(0)
    spec = TSpec(**geo, max_tiles_per_gaussian=6)
    cx = torch.from_numpy(rows[0])
    num = cx - float(np.sqrt(spec.thresh)) - spec.leftmost
    inv = torch.tensor(np.float32(1) / np.float32(spec.tile_len_x))
    divided = torch.floor(div_rn(num, spec.tile_len_x))
    assert torch.equal(divided, torch.floor(num / spec.tile_len_x))
    multiplied = torch.floor(num * inv)
    assert int((multiplied != divided).sum()) > 100
    x0 = t_rows(spec, *map(torch.from_numpy, rows))[0]
    assert torch.equal(x0, divided.clamp(0, spec.n_tile_x).long())


@pytest.mark.parametrize("site", DIVISION_SITES)
def test_divisions_differ_under_a_reciprocal(site):
    # the rows of each division the port routes through div_rn (the ground
    # truth's / 255, Adam's bias corrections, the split's / 1.6, the SH
    # init's / C0): a multiply by the f32 reciprocal, what a CUDA tensor /
    # Python number computes, moves some of them by an ulp, so the card
    # test of the same rows (test_torch_cuda.py::
    # test_divisions_on_cuda_match_cpu) can see a site that multiplies
    from gsplat_tpu_torch.ops.binning import div_rn

    x, y = division_rows(site)
    x = torch.from_numpy(x)
    divided = div_rn(x, y)
    assert torch.equal(divided, x / torch.tensor(y, dtype=torch.float32))
    inv = torch.tensor(np.float32(1) / np.float32(y))
    assert int((x * inv != divided).sum()) > 0


def test_sqrt_rn_is_the_correctly_rounded_root():
    # Adam's sqrt(nu / bc2): the correctly rounded f32 root (numpy's, JAX's
    # and CUDA's), which PyTorch's f32 sqrt on the CPU is not everywhere
    from gsplat_tpu_torch.ops.binning import sqrt_rn

    x = np.random.default_rng(5).uniform(0, 10, 1 << 16).astype(np.float32)
    np.testing.assert_array_equal(sqrt_rn(torch.from_numpy(x)).numpy(),
                                  np.sqrt(x))
