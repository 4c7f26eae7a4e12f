"""The stages of the port's AV1 compound prediction, each held to libaom
3.14.1's own function (the library cv2 5.0.0's wheel bundles) by ELF symbol
on random inputs from a seed, at 8, 10 and 12 bits and in every chroma
subsampling:

- the sub-pixel filter to the intermediate precision of a compound
  prediction (``av1_dist_wtd_convolve_2d_c``, ``_x_c``, ``_y_c``,
  ``_2d_copy_c`` and their highbd forms: InterRound1 7, libaom's offset),
  and the warp to it (``av1_warp_affine_c`` with a compound ConvolveParams);
- the average of two predictions and the distance-weighted one (the same
  functions' second pass, ``do_average``), and the distance weights from
  the order hints (``av1_dist_wtd_comp_weight_assign``, its order-hint
  wrap and MAX_FRAME_DISTANCE clamp);
- the masked blends (``aom_lowbd_blend_a64_d16_mask_c``,
  ``aom_highbd_blend_a64_d16_mask_c``) with each wedge of each size, both
  signs (``av1_init_wedge_masks``' masks) and difference-weighted masks,
  subsampled to the plane; the difference-weighted mask itself
  (``av1_build_compound_diffwtd_mask_d16_c``);
- the contexts of the reference syntax and the filters with compound
  neighbours (``av1_get_reference_mode_context``,
  ``av1_get_comp_reference_type_context``, the fourteen
  ``av1_get_pred_context_*_ref_p*``, ``av1_get_pred_context_switchable_interp``).

No cv2 is needed; the decodes against cv2 are in
``test_torch_avif_compound_files.py``.
"""

import itertools

import numpy as np
import pytest
import torch

import torch_avif_oracles as oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


_SUBS = [(0, 0), (1, 0), (1, 1)]
_SUB_IDS = ["444", "422", "420"]
# the planes of compound blocks (8x8 and larger): luma and subsampled sizes
_SIZES = [(4, 4), (4, 8), (8, 4), (8, 8), (16, 8), (8, 32), (32, 16),
          (64, 64)]


def _kind_subpels(kind, rng):
    sx, sy = (int(v) for v in rng.integers(1, 16, 2))
    return {"2d": (sx, sy), "x": (sx, 0), "y": (0, sy), "copy": (0, 0)}[kind]


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["2d", "x", "y", "copy"])
def test_intermediate_precision_matches_libaom(depth, kind):
    # av1_dist_wtd_convolve_{2d,x,y,2d_copy}_c (highbd above 8 bits) of one
    # prediction: the CONV_BUF values the port's compound predictor keeps,
    # at every filter pair
    rng = np.random.default_rng(depth * 7 + len(kind))
    for w, h in _SIZES:
        for fx, fy in itertools.product(range(4), range(4)):
            src = rng.integers(0, 1 << depth, (h + 7, w + 7))
            sx, sy = _kind_subpels(kind, rng)
            want = oracle.libaom_comp_convolve(src, w, h, fx, fy, sx, sy,
                                               depth, kind)
            got = oracle.port_convolve(src, w, h, fx, fy, sx, sy, depth,
                                       compound=True)
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{w}x{h} {fx} {fy}")


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["2d", "x", "y", "copy"])
def test_average_and_distance_weights_match_libaom(depth, kind):
    # the same functions' second pass (do_average): two predictions
    # averaged, or weighted by each pair of quant_dist_lookup_table, then
    # InterPostRound, against the port's average of its two intermediates
    rng = np.random.default_rng(depth * 11 + len(kind))
    weights = [None, (9, 7), (7, 9), (11, 5), (5, 11), (12, 4), (4, 12),
               (13, 3), (3, 13)]
    for (w, h), dist in itertools.product(_SIZES, weights):
        fx, fy = (int(v) for v in rng.integers(0, 4, 2))
        srcs = [rng.integers(0, 1 << depth, (h + 7, w + 7)) for _ in range(2)]
        subs = [_kind_subpels(kind, rng) for _ in range(2)]
        want = oracle.libaom_comp_convolve(
            srcs[0], w, h, fx, fy, *subs[0], depth, kind,
            second=(srcs[1], *subs[1]), dist=dist)
        p = [oracle.port_convolve(s, w, h, fx, fy, *sub, depth, compound=True)
             for s, sub in zip(srcs, subs)]
        got = oracle.port_comp_average(p[0], p[1], depth, dist)
        np.testing.assert_array_equal(got, want, err_msg=f"{w}x{h} {dist}")


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("sub", _SUBS, ids=_SUB_IDS)
def test_compound_warp_matches_libaom(depth, sub):
    # av1_warp_affine_c (highbd above 8 bits) of a compound prediction, a
    # GLOBAL_GLOBALMV block's: the intermediate precision, under random
    # models whose shear may warp
    rng = np.random.default_rng(depth * 5 + sub[0] + sub[1])
    done = 0
    while done < 30:
        mat = [int(rng.integers(-(1 << 20), 1 << 20)) for _ in range(2)] + [
            (1 << 16) + int(rng.integers(-900, 900)),
            int(rng.integers(-900, 900)), int(rng.integers(-900, 900)),
            (1 << 16) + int(rng.integers(-900, 900))]
        ok, mat, shear = oracle.port_shear(mat)
        if not ok:
            continue
        ref = rng.integers(0, 1 << depth, (int(rng.integers(24, 72)),
                                           int(rng.integers(24, 72))))
        pw, ph = (int(rng.choice([8, 16, 32])) for _ in range(2))
        col, row = (8 * int(rng.integers(-2, 10)) for _ in range(2))
        want = oracle.libaom_comp_warp(mat, shear, ref, col, row, pw, ph,
                                       *sub, depth)
        got = oracle.port_warp(mat, shear, ref, col, row, pw, ph, *sub, depth,
                               compound=True)
        np.testing.assert_array_equal(got, want, err_msg=f"{mat} {shear}")
        done += 1


def test_distance_weights_match_libaom():
    # av1_dist_wtd_comp_weight_assign: the weights of each pair of
    # distances, near and far (past MAX_FRAME_DISTANCE's clamp), across
    # the order hints' wrap at 1-8 bits and without order hints
    rng = np.random.default_rng(3)
    cases = 0
    for bits in range(0, 9):
        top = 1 << max(bits, 1)
        for _ in range(200):
            cur, first, second = (int(v) for v in rng.integers(0, top, 3))
            want = oracle.libaom_dist_weights(cur, first, second, bits)
            got = oracle.port_dist_weights(cur, first, second, bits)
            assert got == want, (cur, first, second, bits)
            cases += 1
    for d0, d1 in itertools.product(range(-40, 41, 3), repeat=2):
        cur = 100
        want = oracle.libaom_dist_weights(cur, cur - d1, cur + d0, 8)
        assert oracle.port_dist_weights(cur, cur - d1, cur + d0, 8) == want
    assert cases == 1800


_WEDGE_SIZES = [3, 4, 5, 6, 7, 8, 9, 18, 19]


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("sub", _SUBS, ids=_SUB_IDS)
def test_wedge_blend_matches_libaom(depth, sub):
    # aom_lowbd_blend_a64_d16_mask_c (highbd above 8 bits) of two
    # intermediate-precision predictions by each wedge of each size with
    # wedges, both signs, the mask subsampled to the plane
    rng = np.random.default_rng(depth * 13 + sub[0] * 2 + sub[1])
    for bsize in _WEDGE_SIZES:
        w, h = oracle.BLOCK_SIZES[bsize]
        pw, ph = w >> sub[0], h >> sub[1]
        for sign in (0, 1):
            for index in range(16):
                p = [oracle.port_convolve(
                    rng.integers(0, 1 << depth, (ph + 7, pw + 7)), pw, ph, 0, 0,
                    *(int(v) for v in rng.integers(0, 16, 2)), depth,
                    compound=True) for _ in range(2)]
                mask = oracle.libaom_wedge_mask(bsize, sign, index)
                np.testing.assert_array_equal(
                    oracle.port_mask_blend(p[0], p[1], mask, *sub, depth),
                    oracle.libaom_mask_blend(p[0], p[1], mask, *sub, depth),
                    err_msg=f"size {bsize} sign {sign} wedge {index}")


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("inverse", [0, 1])
def test_diffwtd_mask_matches_libaom(depth, inverse):
    # av1_build_compound_diffwtd_mask_d16_c: 38 plus the luma predictions'
    # difference (rounded to 8 bits, over 16), clamped, inverted or not;
    # predictions near each other and far apart
    rng = np.random.default_rng(depth * 2 + inverse)
    for w, h in _SIZES[3:]:
        for spread in (4, 64, 1 << depth):
            base = rng.integers(0, (1 << depth) - spread + 1, (h + 7, w + 7))
            srcs = [base, base + rng.integers(0, spread, base.shape)]
            p = [oracle.port_convolve(s, w, h, 0, 0, 5, 9, depth,
                                      compound=True) for s in srcs]
            np.testing.assert_array_equal(
                oracle.port_diffwtd_mask(p[0], p[1], inverse, depth),
                oracle.libaom_diffwtd_mask(p[0], p[1], inverse, depth),
                err_msg=f"{w}x{h} {spread}")


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("sub", _SUBS, ids=_SUB_IDS)
def test_diffwtd_blend_matches_libaom(depth, sub):
    # the whole difference-weighted compound of a block: libaom's mask of
    # its luma predictions, then each plane's blend by it
    rng = np.random.default_rng(depth * 17 + sub[0] * 2 + sub[1])
    for w, h in [(8, 8), (16, 32), (32, 8), (64, 16)]:
        for inverse in (0, 1):
            luma = [oracle.port_convolve(
                rng.integers(0, 1 << depth, (h + 7, w + 7)), w, h, 1, 2,
                *(int(v) for v in rng.integers(0, 16, 2)), depth,
                compound=True) for _ in range(2)]
            mask = oracle.libaom_diffwtd_mask(luma[0], luma[1], inverse,
                                              depth)
            pw, ph = w >> sub[0], h >> sub[1]
            p = [oracle.port_convolve(
                rng.integers(0, 1 << depth, (ph + 7, pw + 7)), pw, ph, 0, 1,
                *(int(v) for v in rng.integers(0, 16, 2)), depth,
                compound=True) for _ in range(2)]
            np.testing.assert_array_equal(
                oracle.port_mask_blend(p[0], p[1], mask, *sub, depth),
                oracle.libaom_mask_blend(p[0], p[1], mask, *sub, depth),
                err_msg=f"{w}x{h} {inverse}")


# a neighbour: unavailable, intra, each single reference, inter-intra, each
# unidirectional pair and each bidirectional one (libaom's ref_frame[0],
# ref_frame[1])
_NEIGHBOURS = [None, (0, -1)] + [(r, -1) for r in range(1, 8)] + [
    (r, 0) for r in (1, 4, 5, 7)] + [(1, 2), (1, 3), (1, 4), (5, 7)] + [
    (f, b) for f in range(1, 5) for b in range(5, 8)]


@pytest.mark.parametrize("cur", [(1, -1), (5, -1), (7, -1), (1, 3), (4, 6),
                                 (5, 7)])
def test_reference_contexts_match_libaom(cur):
    # comp_mode's, comp_ref_type's, the reference bits' and the filters'
    # contexts of a block (single or compound) beside every pair of
    # neighbours: compound ones count both their references, and match a
    # block's filters by either
    rng = np.random.default_rng(cur[0] * 10 + cur[1])
    for above, left in itertools.product(_NEIGHBOURS, repeat=2):
        fa, fl = (tuple(int(v) for v in rng.integers(0, 3, 2))
                  for _ in range(2))
        a = None if above is None else above + fa
        lf = None if left is None else left + fl
        want = oracle.libaom_ref_contexts(a, lf, cur)
        got = oracle.port_ref_contexts(a, lf, cur)
        assert got == want, (above, left)
