"""The port's AV1 decoder on the inter tools libaom's encoder uses at its
defaults, against cv2 5.0.0 (libavif 1.4.2 over libaom 3.14.1) bit for
bit: motion-field projection (the temporal MV candidates), local warped
motion, non-identity global motion, OBMC and inter-intra (smooth and
wedge), in an item, a grid tile, an alpha item and a track's first sample,
at 8, 10 and 12 bits in every chroma format, with and without film grain.

Each stage is held to libaom's own function by ELF symbol on random inputs
from a seed: the warp filter (``av1_warp_affine_c``,
``av1_highbd_warp_affine_c``), the shear (``av1_get_shear_params``), the
least squares model (``av1_find_projection``) and its samples
(``av1_selectSamples``), the MV projection (``av1_get_mv_projection``),
OBMC's masks and blends (``av1_get_obmc_mask``,
``aom_blend_a64_vmask_c``, ``aom_blend_a64_hmask_c`` and their highbd
forms), the wedge masks ``av1_init_wedge_masks`` builds, inter-intra's
blend (``aom_blend_a64_mask_c``, ``aom_highbd_blend_a64_mask_c``) and the
global motion parameters' reading
(``aom_rb_read_signed_primitive_refsubexpfin``).  The files come from
libaom's own good-quality encoder at its default inter tools
(``torch_avif_oracles.libaom_encode_frames``); the committed ones
(``tests/torch_images/``, written by ``torch_make_image_fixtures.py
--inter-tools``) need no cv2.
"""

import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif

import torch_avif_oracles as oracle
import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _same_as_cv2(cv2, tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want is not None, name
    np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])


# compound prediction's controls (the next slice's tools) off: libaom's
# other inter tools stay at their defaults
_NO_COMPOUND = dict.fromkeys(oracle.COMPOUND_TOOLS, 0)


def _item(seed, depth, fmt, n=3, size=(64, 96), warped=False, **kw):
    """An AVIF item of n frames of a photo crop (translated, or rotated and
    zoomed), libaom's inter tools at their defaults but compound's."""
    rng = np.random.default_rng(seed)
    img = oracle.avif_image("photo", *size, rng)
    frames = fx.warped_frames(img, n, 4.0, 1.03, 1.5, -2.0) if warped \
        else fx.inter_frames(img, n, 2, -3)
    controls = {**_NO_COMPOUND, "cpu-used": 4, "cq-level": 30,
                **kw.pop("controls", {})}
    return fx.inter_item(frames, depth, fmt, controls=controls, **kw)


# ---------------------------------------------------- the stages, by symbol


def _random_model(rng, spread=900):
    """A random affine model near the identity (1/65536)."""
    return [int(rng.integers(-(1 << 20), 1 << 20)),
            int(rng.integers(-(1 << 20), 1 << 20)),
            (1 << 16) + int(rng.integers(-spread, spread)),
            int(rng.integers(-spread, spread)),
            int(rng.integers(-spread, spread)),
            (1 << 16) + int(rng.integers(-spread, spread))]


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("sub", [(0, 0), (1, 0), (1, 1)],
                         ids=["444", "422", "420"])
def test_warp_filter_matches_libaom(depth, sub):
    # av1_warp_affine_c (av1_highbd_warp_affine_c above 8 bits) of blocks
    # 8-32 a side anywhere in a plane, the reference read past its edges,
    # under random models whose shear may warp
    rng = np.random.default_rng(depth * 10 + sub[0] + sub[1])
    done = 0
    while done < 40:
        ok, mat, shear = oracle.port_shear(_random_model(rng))
        if not ok:
            continue
        h, w = int(rng.integers(24, 72)), int(rng.integers(24, 72))
        ref = rng.integers(0, 1 << depth, (h, w))
        pw, ph = (int(rng.choice([8, 16, 32])) for _ in range(2))
        col, row = (8 * int(rng.integers(-2, 10)) for _ in range(2))
        want = oracle.libaom_warp(mat, shear, ref, col, row, pw, ph, *sub,
                                  depth)
        got = oracle.port_warp(mat, shear, ref, col, row, pw, ph, *sub,
                               depth)
        np.testing.assert_array_equal(got, want, err_msg=f"{mat} {shear}")
        done += 1


def test_shear_matches_libaom():
    # av1_get_shear_params: the shear, its rounding and its verdict on
    # models near the identity, far from it and degenerate
    rng = np.random.default_rng(5)
    verdicts = set()
    for k in range(3000):
        spread = [300, 3000, 9000, 40000][k % 4]
        mat = _random_model(rng, spread)
        if k % 50 == 0:
            mat[2] = -mat[2]
        want = oracle.libaom_shear(mat)
        assert oracle.port_shear(mat) == want, mat
        verdicts.add(want[0])
    assert verdicts == {0, 1}


_WARP_SIZES = [3, 4, 5, 6, 7, 8, 9, 12, 15, 16, 17, 18, 19]


@pytest.mark.parametrize("bsize", _WARP_SIZES)
def test_projection_matches_libaom(bsize):
    # av1_find_projection: the least squares model of 1-8 neighbour
    # samples about the block's MV, valid or not
    rng = np.random.default_rng(bsize)
    w, h = oracle.BLOCK_SIZES[bsize]
    verdicts = set()
    for _ in range(300):
        n = int(rng.integers(1, 9))
        pts = rng.integers(-80 * 8, 80 * 8, 2 * n)
        jitter = rng.integers(-300, 300, 2 * n) if rng.random() < 0.3 else \
            rng.integers(-40, 40, 2 * n)
        mvy, mvx = (int(v) for v in rng.integers(-600, 600, 2))
        ref = pts + np.tile([mvx, mvy], n) + jitter
        mi_row, mi_col = (int(v) for v in rng.integers(0, 300, 2))
        args = (pts.tolist(), ref.tolist(), bsize, mvy, mvx, mi_row, mi_col)
        want = oracle.libaom_projection(*args)
        assert oracle.port_projection(*args) == want, (args, w, h)
        verdicts.add(want[0])
    assert verdicts == {0, 1}


def test_select_samples_matches_libaom():
    # av1_selectSamples: the samples within the block size's threshold of
    # the block's MV, at least one
    rng = np.random.default_rng(7)
    for _ in range(2000):
        bsize = int(rng.choice(_WARP_SIZES))
        n = int(rng.integers(1, 9))
        pts = rng.integers(-400, 400, 2 * n).tolist()
        ref = (np.array(pts) + rng.integers(-150, 150, 2 * n)).tolist()
        mv = [int(v) for v in rng.integers(-100, 100, 2)]
        want = oracle.libaom_select_samples(*mv, pts, ref, bsize)
        assert oracle.port_select_samples(*mv, pts, ref, bsize) == want


def test_mv_projection_matches_libaom():
    # av1_get_mv_projection with libaom's div_mult: every distance pair
    # (num clamped to +-31, den to 31) on MVs within REFMVS_LIMIT
    rng = np.random.default_rng(8)
    for num in range(-40, 41):
        for den in range(1, 40):
            for row, col in rng.integers(-4095, 4096, (3, 2)):
                want = oracle.libaom_mv_projection(int(row), int(col), num,
                                                   den)
                got = oracle.port_mv_projection(int(row), int(col), num, den)
                assert got == want, (row, col, num, den)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("direction", [0, 1], ids=["above", "left"])
def test_obmc_blend_matches_libaom(depth, direction):
    # av1_get_obmc_mask of every overlap and aom_blend_a64_vmask_c /
    # hmask_c (aom_highbd_blend_a64_* above 8 bits) of a neighbour's
    # prediction over the block's
    rng = np.random.default_rng(depth + direction)
    for overlap in (1, 2, 4, 8, 16, 32):
        for other in (2, 4, 8, 16, 32, 64):
            shape = (other, overlap) if direction else (overlap, other)
            dst = rng.integers(0, 1 << depth, shape)
            src = rng.integers(0, 1 << depth, shape)
            want = oracle.libaom_obmc_blend(dst, src, direction, depth)
            got = oracle.port_obmc_blend(dst, src, direction)
            np.testing.assert_array_equal(got, want)


_WEDGE_SIZES = [3, 4, 5, 6, 7, 8, 9, 18, 19]


@pytest.mark.parametrize("bsize", _WEDGE_SIZES)
def test_wedge_masks_match_libaom(bsize):
    # the masks av1_init_wedge_masks builds into av1_wedge_params_lookup:
    # each size's 16 wedges and their complements
    for neg in (0, 1):
        for index in range(16):
            np.testing.assert_array_equal(
                oracle.port_wedge_mask(bsize, neg, index),
                oracle.libaom_wedge_mask(bsize, neg, index),
                err_msg=f"size {bsize} sign {neg} wedge {index}")


# inter-intra's block sizes (8x8 to 32x32) and the plane's size in each
# chroma format
_II_SIZES = [3, 4, 5, 6, 7, 8, 9]


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("sub", [(0, 0), (1, 0), (1, 1)],
                         ids=["444", "422", "420"])
def test_interintra_blend_matches_libaom(depth, sub):
    # combine_interintra's blend (aom_blend_a64_mask_c, its highbd form)
    # of the intra prediction over the inter one: each mode's smooth mask
    # (smooth_interintra_mask_buf) and each wedge, subsampled to the plane
    rng = np.random.default_rng(depth * 3 + sub[0] + sub[1])
    for bsize in _II_SIZES:
        w, h = oracle.BLOCK_SIZES[bsize]
        pw, ph = w >> sub[0], h >> sub[1]
        for mode in range(4):
            for wedge, index in [(0, 0)] + [(1, int(i)) for i in
                                             rng.integers(0, 16, 3)]:
                intra = rng.integers(0, 1 << depth, (ph, pw))
                inter = rng.integers(0, 1 << depth, (ph, pw))
                want = oracle.libaom_interintra_blend(
                    intra, inter, bsize, *sub, mode, wedge, index, depth)
                got = oracle.port_interintra_blend(intra, inter, bsize, *sub,
                                                   mode, wedge, index)
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{bsize} {mode} {wedge} {index}")


def test_interintra_modes_are_libaoms():
    # the intra mode of each inter-intra mode (interintra_to_intra_mode):
    # DC, V, H, SMOOTH, which the decoder predicts through predict_intra
    import ctypes

    at = oracle._aom_address("interintra_to_intra_mode")
    assert list(ctypes.string_at(at, 4)) == [0, 1, 2, 9]


def test_global_motion_reading_matches_libaom():
    # aom_rb_read_signed_primitive_refsubexpfin (SUBEXPFIN_K 3) at each
    # parameter's range (the 2x2 part, a translation at either precision,
    # a translation only) against every kind of reference value
    rng = np.random.default_rng(9)
    for n in (4097, 4097, 513, 257, 4097):
        for _ in range(400):
            data = rng.integers(0, 256, 8, dtype=np.uint8).tobytes()
            ref = int(rng.integers(-n + 1, n))
            assert oracle.port_refsubexpfin(data, n, ref) == \
                oracle.libaom_refsubexpfin(data, n, ref), (n, ref, data)


# ------------------------------------------ libaom's default inter tools


_FORMATS = [(d, f) for d in (8, 10, 12) for f in ("420", "422", "444", "400")
            if (d, f) != (12, "400")]


@pytest.mark.parametrize("depth,fmt", _FORMATS,
                         ids=[f"d{d}_{f}" for d, f in _FORMATS])
def test_default_tools_match_cv2(cv2, tmp_path, depth, fmt):
    # three or four frames at libaom's default inter tools: motion-field
    # projection in every inter frame, the others where the encoder takes
    # them (rotated and zoomed frames in a third of the files)
    seed = depth * 10 + int(fmt[1])
    data = _item(seed, depth, fmt, n=3 + seed % 2, warped=seed % 3 == 0,
                 size=(56 + seed % 17, 80 + seed % 29),
                 controls={"cpu-used": seed % 7, "cq-level": 14 + seed % 37})
    _same_as_cv2(cv2, tmp_path, f"tools_{depth}_{fmt}.avif", data)
    assert fx.tools_info(data)[0] > 0


_TOOLS = {
    # 128x128 superblocks in 2x2 tiles
    "sb128_tiles": dict(size=(136, 296), controls={
        "superblock-size": 1, "tile-columns": 1, "tile-rows": 1}),
    # film grain at 10 bits
    "grain": dict(depth=10, controls={"film-grain-test-vector": 7}),
    # rotated and zoomed frames at speed 1: global motion warps
    "rotzoom": dict(warped=True, n=4, size=(96, 128), controls={
        "cpu-used": 1}),
    # speed 0, loop restoration, 4:4:4
    "slow_444": dict(fmt="444", controls={"cpu-used": 0,
                                          "enable-restoration": 1}),
    # 12-bit 4:2:2 at speed 6
    "fast_d12_422": dict(depth=12, fmt="422", controls={"cpu-used": 6}),
}


@pytest.mark.parametrize("kind", list(_TOOLS))
def test_default_tool_kinds_match_cv2(cv2, tmp_path, kind):
    opts = dict(_TOOLS[kind])
    depth, fmt = opts.pop("depth", 8), opts.pop("fmt", "420")
    data = _item(len(kind), depth, fmt, **opts)
    _same_as_cv2(cv2, tmp_path, f"{kind}.avif", data)
    assert fx.tools_info(data)[0] > 0


def test_default_tools_in_grid_alpha_and_track(cv2, tmp_path):
    # the frames as a grid's tiles, as an alpha item (4:0:0) and as a
    # sequence track's first sample
    tiles = [oracle.tile_item(_item(k, 8, "420", size=(64, 64)))
             for k in range(4)]
    _same_as_cv2(cv2, tmp_path, "grid.avif",
                 oracle.grid_avif(tiles, 2, 2, 128, 128))
    colour = _item(5, 8, "420", size=(64, 96))
    alpha = _item(6, 8, "400", size=(64, 96))
    _same_as_cv2(cv2, tmp_path, "alpha.avif",
                 oracle.alpha_file(colour, alpha, False))
    obu, props = oracle.item_parts(_item(7, 10, "444", size=(48, 64)))
    _same_as_cv2(cv2, tmp_path, "track.avif",
                 oracle.build_sequence([obu], props, 64, 48))


@pytest.mark.parametrize("tool", list(fx.AVIF_TOOLS_ALONE))
def test_one_tool_on_matches_cv2(cv2, tmp_path, tool):
    # each tool alone on (the others of INTER_TOOLS_OFF off), on frames
    # that call for it, at 10 bits
    on = {fx.AVIF_TOOLS_ALONE[tool]: 1}
    if tool.startswith("interintra"):
        on["enable-interintra-comp"] = 1
    data = _item(len(tool), 10, "420", n=4, warped=tool == "global",
                 size=(80, 112), controls={**oracle.INTER_TOOLS_OFF, **on,
                                           "cpu-used": 1})
    _same_as_cv2(cv2, tmp_path, f"{tool}.avif", data)


# ------------------------------------------------- the committed files


# what each committed file's decode counts (decode_av1's info[58:67] and
# the frames): the tool it is there for
_MOVED = {"avif_unported_ref_frame_mvs.avif": lambda t: t[0] and t[1],
          "avif_unported_warped.avif": lambda t: t[2],
          "avif_unported_global.avif": lambda t: t[4] and t[5],
          "avif_unported_obmc.avif": lambda t: t[6],
          "avif_unported_interintra.avif": lambda t: t[7] + t[8]}


def _uses(name, t, info):
    if name in _MOVED:
        return bool(_MOVED[name](t))
    if name.startswith("avif_tool_"):
        return t[fx.AVIF_TOOLS_COUNTER[name[10:-5]]] > 0
    if name == "avif_tools_rotzoom.avif":
        return t[4] > 0 and t[5] > 0 and t[2] > 0
    if name == "avif_tools_invalid_warp.avif":
        return t[3] > 0
    if name == "avif_tools_sb128_tiles.avif":
        return t[0] > 0 and info[12] == 1 and info[10:12] == [2, 2]
    if name == "avif_tools_grain.avif":
        return t[0] > 0 and info[22] == 1
    return t[0] > 0 and t[9] >= 3


@pytest.mark.parametrize("name", fx.AVIF_TOOLS_CASES)
def test_committed_tool_fixtures_match_cv2(name):
    # no cv2 here: the decode is cv2's recorded one
    got = read_avif(os.path.join(fx.FOLDER, name))
    want = image_io.read_png(os.path.join(fx.FOLDER, fx._want(name)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", fx.AVIF_TOOLS_CASES)
def test_committed_tool_fixtures_use_their_tools(name):
    # the decoder's counters show the tool each file is there for
    with open(os.path.join(fx.FOLDER, name), "rb") as f:
        data = f.read()
    heif = image_io._Heif(data, name)
    heif.parse()
    info = image_io.decode_av1(heif.primary_item()[0])[1]
    assert _uses(name, fx.tools_info(data), info), info[46:]


# ------------------------------------------- OBUs after a frame (libaom)


def _obu(kind, payload):
    return bytes([(kind << 3) | 2]) + oracle._leb(len(payload)) + payload


_LAYOUTS = {
    # a temporal delimiter: zero bytes in its payload, then a frame, read;
    # a nonzero byte refused (the last frame's OBU retyped by a flip)
    "td_zero_payload": lambda ob, last: ob[:-1] + [_obu(2, b"\0"), last],
    "td_frame_payload": lambda ob, last: ob[:-1] + [_obu(2, last[2:])],
    "td_empty_last": lambda ob, last: ob + [_obu(2, b"")],
    # a redundant frame header with no frame pending, between frames or
    # last (a flip's retyped frame too), refused
    "redundant_between": lambda ob, last: ob[:-1] + [_obu(7, b"\0"), last],
    "redundant_last": lambda ob, last: ob + [_obu(7, last[2:])],
    # a tile list, refused; reserved types, refused where all zero
    "tile_list": lambda ob, last: ob[:-1] + [_obu(8, b"\0"), last],
    "reserved_zero": lambda ob, last: ob + [_obu(9, b"\0")],
    "reserved_zero_type0": lambda ob, last: ob + [_obu(0, b"\0\0")],
    "reserved_bytes": lambda ob, last: ob + [_obu(12, b"\1\0")],
    # a sequence header or padding after the last frame, read
    "sequence_header_last": lambda ob, last: ob + [ob[1]],
    "padding_last": lambda ob, last: ob + [_obu(15, b"\x80")],
}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_obus_after_a_frame_match_cv2(cv2, tmp_path, layout):
    # OBUs between and after the frames of libaom's stream held to cv2's
    # verdict: libaom refuses a temporal delimiter with a nonzero byte, a
    # redundant frame header without a frame pending, a tile list and a
    # reserved OBU of zero bytes, and the port raises naming the file
    with open(os.path.join(fx.FOLDER, "avif_inter_d8_420.avif"), "rb") as f:
        obu, props = oracle.item_parts(f.read())
    ob = [h + oracle._leb(len(p)) + p for _, h, p in oracle.obus(obu)]
    data = oracle.build_avif(b"".join(_LAYOUTS[layout](ob, ob[-1])), props)
    path = tmp_path / f"{layout}.avif"
    path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(RuntimeError, match=f"{layout}.avif: AV1 data "
                                               f"cv2 does not read"):
            read_avif(str(path))
    else:
        np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])
