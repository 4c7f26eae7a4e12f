"""PyTorch port vs the JAX package: every square root of the port.

PyTorch's f32 square root on the CPU is not correctly rounded (~0.7% of
values land one ulp away); JAX's, numpy's and CUDA's are.  The port takes
each root through ``ops/binning.sqrt_rn``.  Each test below builds rows at
which ``torch.sqrt`` is an ulp off and holds one site of the port to the
JAX package's f32 result there, bit for bit: the projection's depth and
normalised quaternion, the tile boxes, the SH pixel basis,
``adaptive_control``'s scale norm and split quaternion, and the viewer's far
cull.  The rows are integers scaled by a power of two, so every sum of
squares is exact in f32 and the two packages' summation orders cannot
differ: only the root is tested.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gsplat_tpu_torch.ops.binning import sqrt_rn

torch.set_num_threads(1)


def off_by_torch(x):
    """Where ``torch.sqrt`` on the CPU rounds ``x`` (f32) otherwise than the
    correctly rounded root."""
    return torch.sqrt(torch.from_numpy(x)).numpy() != np.sqrt(x)


def square_rows(seed, n_comp, hi, scale, n=64, keep=None):
    """Integer vectors of ``n_comp`` components in [-hi, hi] times
    ``scale`` (a power of two) whose f32 sum of squares ``torch.sqrt``
    rounds an ulp off; ``keep`` filters the candidates (a mask of the
    integer rows) → (rows (n, n_comp) f32, their sums of squares)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(-hi, hi + 1, (200_000, n_comp))
    if keep is not None:
        ints = ints[keep(ints)]
    rows = (ints * scale).astype(np.float32)
    sq = (rows.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    bad = off_by_torch(sq) & (sq > 0)
    assert bad.sum() >= n
    return rows[bad][:n], sq[bad][:n]


def test_rows_are_an_ulp_off_under_torch_sqrt():
    rows, sq = square_rows(0, 4, 64, 2.0 ** -5)
    assert np.array_equal(sqrt_rn(torch.from_numpy(sq)).numpy(), np.sqrt(sq))
    ulp = np.abs(torch.sqrt(torch.from_numpy(sq)).numpy().view(np.int32)
                 - np.sqrt(sq).view(np.int32))
    assert (ulp == 1).all()


def test_projection_depth_matches_jax():
    # identity pose: p_c == pos bit for bit in both packages
    from gsplat_tpu.ops.projection import project_gaussians as j_project
    from gsplat_tpu_torch.ops.projection import project_gaussians

    pos, _ = square_rows(1, 3, 40, 2.0 ** -3,
                         keep=lambda r: r[:, 2] > 20)
    quat, _ = square_rows(2, 4, 64, 2.0 ** -5)
    n = len(pos)
    scale = np.full((n, 3), 0.05, np.float32)
    rot, tran = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (pos, quat, scale, rot, tran)
    j = j_project(*map(jnp.asarray, args), 0.3, 0.8, 0.6, "abs")
    t = project_gaussians(*map(torch.from_numpy, args), 0.3, 0.8, 0.6, "abs")
    np.testing.assert_array_equal(t.depth.numpy(), np.asarray(j.depth))


def test_projection_quaternion_matches_jax():
    # gsplat_tpu/ops/projection.py:113, the quaternion the projection uses
    from gsplat_tpu_torch.ops.projection import normalize_quat

    quat, _ = square_rows(2, 4, 64, 2.0 ** -5)
    jq = jnp.asarray(quat)
    np.testing.assert_array_equal(
        normalize_quat(torch.from_numpy(quat)).numpy(),
        np.asarray(jq / jnp.linalg.norm(jq, axis=-1, keepdims=True)))


def test_sqrt_gradient_is_jax_rule():
    # the root's gradient is JAX's sqrt_p JVP, g * (0.5 / ans), in f32, at
    # the quaternions' sums of squares
    _, sq = square_rows(3, 4, 64, 2.0 ** -5, n=256)
    g = np.random.default_rng(4).normal(size=sq.shape).astype(np.float32)
    x = torch.from_numpy(sq).requires_grad_(True)
    sqrt_rn(x).backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jnp.sqrt, jnp.asarray(sq))
    np.testing.assert_array_equal(x.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_quaternion_gradient_matches_jax():
    # through the whole normalisation JAX's gradient to f32 rounding: the
    # division's own rule rounds otherwise in the two packages
    from gsplat_tpu_torch.ops.projection import normalize_quat

    quat, _ = square_rows(3, 4, 64, 2.0 ** -5, n=256)
    gq = np.random.default_rng(5).normal(size=quat.shape).astype(np.float32)
    q = torch.from_numpy(quat).requires_grad_(True)
    normalize_quat(q).backward(torch.from_numpy(gq))
    _, vjp = jax.vjp(lambda v: v / jnp.linalg.norm(v, axis=-1,
                                                   keepdims=True),
                     jnp.asarray(quat))
    np.testing.assert_allclose(q.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(gq))[0]),
                               rtol=1e-5, atol=1e-6)


def test_tile_boxes_match_jax_where_the_shift_is_an_ulp_off():
    # box shifts sqrt(a · log_t) that torch.sqrt rounds an ulp off, each
    # with a centre that puts one box edge between the two roots: a pair
    # moves unless the root is the correctly rounded one
    from gsplat_tpu.ops.binning import BinningSpec as JSpec
    from gsplat_tpu.ops.binning import _tile_bbox_rows as j_rows
    from gsplat_tpu_torch.ops.binning import BinningSpec as TSpec
    from gsplat_tpu_torch.ops.binning import _tile_bbox_rows as t_rows

    geo = dict(n_tile_x=64, n_tile_y=64, tile_len_x=0.25, tile_len_y=0.25,
               leftmost=0.0, topmost=0.0, method="prob2", thresh=0.05)
    log_t = -2.0 * np.log(geo["thresh"])
    a = np.random.default_rng(6).uniform(0.01, 0.5, 200_000) \
        .astype(np.float32)
    prod = (torch.from_numpy(a) * log_t).numpy()
    bad = off_by_torch(prod)
    a, prod = a[bad][:64], prod[bad][:64]
    good = np.sqrt(prod)
    wrong = torch.sqrt(torch.from_numpy(prod)).numpy()
    tl = np.float32(geo["tile_len_x"])
    cx = np.empty_like(a)
    for i, (s, w) in enumerate(zip(good, wrong)):
        # within 32 ulps of the tile edge 8 tiles in, a centre at which
        # cx - s and cx - w floor to different tiles
        c = np.float32(8 * tl + s)
        for _ in range(32):
            c = np.nextafter(c, np.float32(-np.inf))
        for _ in range(64):
            if np.floor((c - s) / tl) != np.floor((c - w) / tl):
                break
            c = np.nextafter(c, np.float32(np.inf))
        cx[i] = c
    # f32 subtraction at the edge keeps some pairs of roots together
    moved = np.floor((cx - good) / tl) != np.floor((cx - wrong) / tl)
    assert moved.sum() >= 16
    a, cx = a[moved], cx[moved]
    cy = np.full_like(a, 4.0)
    d = np.full_like(a, 0.05)
    zero = np.zeros_like(a)
    rows = (cx, cy, a, zero, zero, d, np.ones(len(a), bool))
    j = j_rows(JSpec(**geo, max_tiles_per_gaussian=6, slot_capacity=128,
                     chunk_size=128), *map(jnp.asarray, rows))
    t = t_rows(TSpec(**geo, max_tiles_per_gaussian=6),
               *map(torch.from_numpy, rows))
    for jv, tv in zip(j, t):
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_sh_pixel_basis_matches_jax():
    # RayInfo vectors on a 1/64 grid: every pixel's ray is exact, so its
    # squared length is too, and ~0.5% of the pixels' roots are an ulp off
    from gsplat_tpu.ops.rasterize import RasterSpec as JRSpec
    from gsplat_tpu.ops.rasterize import _sh_pixel_basis as j_basis
    from gsplat_tpu_torch.ops.rasterize import RasterSpec as TRSpec
    from gsplat_tpu_torch.ops.rasterize import _sh_pixel_basis as t_basis

    shv = np.array([[0.0, 0.0, 0.0], [-3.0, -2.0, 2.5],
                    [1 / 64, 0.0, 0.0], [0.0, 1 / 64, 0.0]], np.float32)
    spec = dict(n_tile_x=24, n_tile_y=16, tile_h=16, tile_w=16,
                focal_x=64.0, focal_y=64.0)
    tiles = np.arange(24 * 16)
    t = t_basis(TRSpec(**spec, color_dim=27), torch.from_numpy(tiles),
                torch.from_numpy(shv)).numpy()
    jspec = JRSpec(**spec, chunk_size=128, color_dim=27)
    j = np.stack([np.asarray(j_basis(jspec, int(k), jnp.asarray(shv)))
                  for k in tiles])
    # the pixels whose squared ray length torch.sqrt rounds an ulp off
    fx = (tiles[:, None] % 24) * 16 + np.arange(256)[None] % 16
    fy = (tiles[:, None] // 24) * 16 + np.arange(256)[None] // 16
    comps = np.stack([shv[1, k] + fx * shv[2, k] + fy * shv[3, k]
                      for k in range(3)]).astype(np.float32)
    sq = (comps.astype(np.float64) ** 2).sum(0).astype(np.float32)
    assert off_by_torch(sq.ravel()).sum() > 100
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("decision", ["delete", "split"])
def test_scale_norm_and_split_quaternion_match_jax(decision, monkeypatch):
    # one probe slot whose scale norm torch.sqrt rounds an ulp low (it
    # rounds low wherever it is off), with the decision's threshold where
    # the two roots fall either side of it: delete_thresh at the correctly
    # rounded norm, or taus at the ulp below it; every slot has the probe's
    # scale and an ulp-off quaternion row
    from gsplat_tpu.models.gaussians import GaussianTable as JTable
    from gsplat_tpu.models.gaussians import adaptive_control as j_control
    import gsplat_tpu_torch.models.gaussians as tg
    from gsplat_tpu_torch.utils.checkpoint import table_from_jax_arrays

    rows, sq = square_rows(7, 3, 40, 2.0 ** -8)
    probe = 0
    cap = 256
    scale = np.tile(rows[probe], (cap, 1))
    norm = float(np.sqrt(sq[probe]))
    quat, _ = square_rows(8, 4, 64, 2.0 ** -5, n=cap)
    rng = np.random.default_rng(9)
    arrs = {"pos": rng.normal(size=(cap, 3)).astype(np.float32),
            "rgb": rng.normal(size=(cap, 3)).astype(np.float32),
            "opa": np.full(cap, 2.0, np.float32),
            "quat": quat, "scale": scale,
            "live": np.ones(cap, bool), "n_live": np.int32(cap)}
    grad = np.full((cap, 3), 1e-3, np.float32)
    if decision == "delete":   # delete below the norm, split the rest
        kw = dict(taus=0.0, delete_thresh=norm)
    else:                      # split above the ulp below it, else clone
        kw = dict(taus=float(np.nextafter(np.float32(norm), np.float32(0))),
                  delete_thresh=10.0)
    kw.update(grad_thresh=2e-4, clone_dt=0.01)
    key = jax.random.PRNGKey(3)
    eps = np.array(jax.random.normal(key, (cap, 2, 3)))
    jt = JTable(**{k: jnp.asarray(v) for k, v in arrs.items()})
    jn, js = j_control(jt, jnp.asarray(grad), key, **kw,
                       use_clone=jnp.asarray(True),
                       use_split=jnp.asarray(True))
    seen = []
    rotmat = tg.quat_to_rotmat
    monkeypatch.setattr(tg, "quat_to_rotmat",
                        lambda q: seen.append(q) or rotmat(q))
    tt = table_from_jax_arrays(arrs, "cpu")
    tn, ts = tg.adaptive_control(tt, torch.from_numpy(grad),
                                 torch.from_numpy(eps), **kw,
                                 use_clone=True, use_split=True)
    assert (ts.n_deleted, ts.n_cloned, ts.n_split) == (
        int(js.n_deleted), int(js.n_cloned), int(js.n_split))
    np.testing.assert_array_equal(tn.live.numpy(), np.asarray(jn.live))
    # the split's quaternion, gsplat_tpu/models/gaussians.py:182
    jq = jnp.asarray(quat)
    np.testing.assert_array_equal(seen[0].numpy(), np.asarray(
        jq / (jnp.linalg.norm(jq, axis=-1, keepdims=True) + 1e-12)))


def test_viewer_far_cull_matches_jax(monkeypatch):
    # the far slider at the correctly rounded depth of gaussians whose
    # depth torch.sqrt rounds an ulp low: JAX's cull (viewer.py:144) drops
    # them
    import gsplat_tpu_torch.viewer as tv
    from gsplat_tpu_torch.config import SplatConfig
    from gsplat_tpu_torch.models.gaussians import table_from_numpy

    pos, sq = square_rows(10, 3, 40, 2.0 ** -3, n=256,
                          keep=lambda r: r[:, 2] > 20)
    low = torch.sqrt(torch.from_numpy(sq)).numpy() < np.sqrt(sq)
    far = float(np.sqrt(sq[low][0]))
    n = len(pos)
    table = table_from_numpy({
        "pos": pos, "rgb": np.zeros((n, 3), np.float32),
        "opa": np.zeros(n, np.float32),
        "quat": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        "scale": np.full((n, 3), 0.01, np.float32),
        "live": np.ones(n, bool)}, n, "cpu")
    splat = types.SimpleNamespace(cfg=SplatConfig(), table=table)
    seen = []

    def capture(params, live, *args):
        seen.append(live)
        return torch.zeros(3, 8, 8), {}

    monkeypatch.setattr(tv, "render_cropped", capture)
    tv.render_offscreen(splat, np.eye(4), 8, 8, 10.0, 10.0, far=far)
    # identity pose: p_c == pos bit for bit in both packages
    want = np.asarray(jnp.linalg.norm(jnp.asarray(pos), axis=-1) < far)
    assert (~want).sum() > 0 and want.sum() > 0
    np.testing.assert_array_equal(seen[0].numpy(), want)
