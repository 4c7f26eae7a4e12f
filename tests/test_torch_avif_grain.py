"""The port's AVIF reader on film grain and grid images, against cv2 5.0.0
(libavif 1.4.2, libaom 3.14.1, libyuv 1924) bit for bit, or both refuse
(cv2 returns None; the port raises naming the file).

Film grain: the synthesis of ``csrc/avif_codec.cpp`` held to libaom's own
``av1_add_film_grain`` by ELF symbol (``tests/torch_avif_oracles.py``) on
planes made from a seed, at 8, 10 and 12 bits, 4:2:0, 4:2:2, 4:4:4 and
4:0:0, odd and even sides, for libaom's 16 ``film_grain_test_vectors`` and
random parameters; Pillow's grain files (each test vector, libaom's
denoiser, every subsampling, RGBA, screen content) and files whose grain
fields are rewritten here (random valid parameters at every depth, the
ones libaom's ``read_film_grain_params`` refuses, one-bit flips) against
cv2.  Grids: hand-built ``grid`` items (colour and alpha, with and without
grain) from tiles that cv2's and Pillow's writers make, and libavif's grid
rules, each held to cv2's verdict; with them the container rules the grid
work found (two colr of a kind, ipma's order, OpenCV's 500-byte signature
test).
"""

import copy
import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif, read_image

import torch_avif_oracles as oracle

# decode_av1's info: film grain applied
GRAIN = 22
SUBS = {"4:2:0": (1, 1), "4:2:2": (1, 0), "4:4:4": (0, 0), "4:0:0": (1, 1)}
ODD_SIZES = [(1, 1), (3, 5), (17, 33), (130, 67)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def pil():
    pytest.importorskip("PIL.AvifImagePlugin")


def _same_as_cv2(cv2, path, data=None):
    """The port's decode against cv2's: equal bit for bit, or cv2 refuses
    and the port raises naming the file.  → whether cv2 read it."""
    if data is not None:
        path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


def _grain_applied(data: bytes) -> bool:
    heif = image_io._Heif(data, "file")
    heif.parse()
    return bool(image_io.decode_av1(heif.primary_item()[0])[1][GRAIN])


# ------------------------------------------------ the synthesis alone


@pytest.mark.parametrize("sub", list(SUBS))
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_synthesis_matches_libaom(cv2, depth, sub):
    # the port's av1_film_grain against libaom's av1_add_film_grain on the
    # same planes and parameters: its 16 test vectors (at this depth) and
    # random valid parameters, odd and even sides, the identity matrix's
    # chroma range under clip_to_restricted_range
    mono = sub == "4:0:0"
    sx, sy = SUBS[sub]
    vectors = oracle.grain_test_vectors()
    rng = np.random.default_rng(depth * 10 + len(sub) + mono)
    top = (1 << depth) - 1
    for h, w in ODD_SIZES + [(64, 64), (40, 98)]:
        for k in range(20):
            params = oracle.with_depth(vectors[k], depth) if k < 16 else \
                oracle.random_grain(rng, depth, sx, sy, mono)
            mc = 0 if (sub == "4:4:4" and k % 2) else 1
            planes = [rng.integers(0, top + 1, (h, w)).astype(np.uint16)]
            if not mono:
                planes += [rng.integers(0, top + 1, ((h + sy) >> sy,
                                                     (w + sx) >> sx))
                           .astype(np.uint16) for _ in range(2)]
            want = oracle.libaom_film_grain(params, planes, depth, sx, sy,
                                            mono, mc)
            got = oracle.port_film_grain(params, planes, sx, sy, mono, mc)
            for p, (a, b) in enumerate(zip(got, want)):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"{h}x{w} parameters {k} plane {p}")
            if depth == 8 and not mono:     # libaom's 8-bit path agrees
                low = oracle.libaom_film_grain(
                    params, [a.astype(np.uint8) for a in planes], 8, sx, sy,
                    mono, mc, hbd=False)
                for a, b in zip(low, want):
                    np.testing.assert_array_equal(a, b)


def test_test_vectors_are_libaoms(cv2):
    # the oracle's layout of aom_film_grain_t reads libaom's own table:
    # vector 1 is the specification's example, every vector's fields lie in
    # their coded ranges
    vectors = [oracle.grain_fields(v) for v in oracle.grain_test_vectors()]
    assert vectors[0]["num_y_points"] == 14 and vectors[0]["y0"] == 16
    for f in vectors:
        assert f["apply_grain"] == 1 and f["bit_depth"] == 8
        assert 0 <= f["num_y_points"] <= 14 and 8 <= f["scaling_shift"] <= 11
        assert 0 <= f["ar_coeff_lag"] <= 3 and 6 <= f["ar_coeff_shift"] <= 9


def test_planes_with_libaoms_grain_match_libavif(cv2, pil):
    # a file cv2 reads: the port's frame before its grain, with libaom's
    # av1_add_film_grain on the port's parsed parameters, is libavif's
    # decode (the aom_image_t and aom_film_grain_t layouts hold), and so
    # is the port's own synthesis
    rng = np.random.default_rng(21)
    for sub, k in (("4:2:0", 1), ("4:4:4", 7), ("4:2:2", 12)):
        img = oracle.avif_image("photo", 67, 130, rng)
        data = oracle.pillow_avif(img, subsampling=sub, advanced={
            "film-grain-test": str(k)})
        obu, _ = oracle.item_parts(data)
        planes, params, info = oracle.port_grain_params(obu)
        want, depth, _ = oracle.libavif_planes(data)
        assert oracle.grain_fields(params)["apply_grain"] == 1
        sx, sy = SUBS[sub]
        aom = oracle.libaom_film_grain(params, planes, depth, sx, sy,
                                       mc=info[8])
        with_grain, _ = image_io.decode_av1(obu)
        for a, b, c in zip(aom, want, with_grain):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(c, b)
        assert not all((a == b).all() for a, b in zip(planes, want))


# ------------------------------------------------------ Pillow's files


@pytest.mark.parametrize("vector", range(1, 17))
def test_pillow_test_vectors_match_cv2(cv2, pil, tmp_path, vector):
    # libaom's film-grain-test 1-16, at 4:2:0 and an odd-sided 4:4:4
    rng = np.random.default_rng(vector)
    for sub, size in (("4:2:0", (96, 128)), ("4:4:4", (67, 130))):
        data = oracle.pillow_avif(oracle.avif_image("photo", *size, rng),
                                  subsampling=sub,
                                  advanced={"film-grain-test": str(vector)})
        assert _grain_applied(data)
        assert _same_as_cv2(cv2, tmp_path / f"v{vector}.avif", data)


@pytest.mark.parametrize("sub", list(SUBS))
@pytest.mark.parametrize("size", ODD_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_grain_sides_match_cv2(cv2, pil, tmp_path, size, sub):
    # odd sides: libaom synthesises on a copy padded to even sides
    rng = np.random.default_rng(size[0] * 7 + len(sub))
    for vector in (1, 6, 10, 16):
        data = oracle.pillow_avif(oracle.avif_image("photo", *size, rng),
                                  subsampling=sub,
                                  advanced={"film-grain-test": str(vector)})
        assert _same_as_cv2(cv2, tmp_path / "s.avif", data)


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:0:0"])
@pytest.mark.parametrize("level", [10, 25, 50])
def test_denoiser_matches_cv2(cv2, pil, tmp_path, level, sub):
    # libaom's denoiser writes its noise model as grain parameters; for
    # 4:0:0 at some sizes libaom writes fields a monochrome header does not
    # have, which both refuse
    rng = np.random.default_rng(level)
    img = oracle.avif_image("photo", 96, 160, rng)
    data = oracle.pillow_avif(img, subsampling=sub, advanced={
        "denoise-noise-level": str(level)})
    if _same_as_cv2(cv2, tmp_path / "d.avif", data):
        assert _grain_applied(data)


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_grain_alpha_matches_cv2(cv2, pil, tmp_path, sub):
    # Pillow passes its options to the alpha's encoder too: the alpha
    # stream carries grain, decoded as libavif decodes it before cv2 drops
    # it
    rng = np.random.default_rng(31)
    img = oracle.avif_image("photo", 67, 130, rng)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)])
    for vector in (2, 9):
        data = oracle.pillow_avif(rgba, subsampling=sub, advanced={
            "film-grain-test": str(vector)})
        assert _same_as_cv2(cv2, tmp_path / "a.avif", data)
        _, _, aobu, _ = oracle.alpha_parts(data)
        assert image_io.decode_av1(aobu)[1][GRAIN] == 1


@pytest.mark.parametrize("kind", oracle.SCREEN_KINDS)
def test_grain_with_screen_tools_matches_cv2(cv2, pil, tmp_path, kind):
    # grain over palette and intra block copy frames: libaom keeps grain
    # on a frame that allows intra block copy
    rng = np.random.default_rng(41)
    img = oracle.screen_image(kind, 96, 160, rng)
    for vector in (3, 13):
        data = oracle.pillow_avif(img, advanced={
            "film-grain-test": str(vector), "tune-content": "screen"})
        assert _same_as_cv2(cv2, tmp_path / "t.avif", data)
        heif = image_io._Heif(data, "t")
        heif.parse()
        info = image_io.decode_av1(heif.primary_item()[0])[1]
        assert info[GRAIN] == 1
        assert kind != "text" or (info[20] > 0 and info[21] > 0)


# ------------------------------------------------- rewritten fields


def _writer_file(depth: int, sub: str, rng):
    """(OBUs, properties) of a small cv2 (8, 10, 12 bits) or Pillow file."""
    img = oracle.avif_image("photo", int(rng.integers(9, 70)),
                            int(rng.integers(9, 70)), rng)
    if depth == 8 and sub != "4:2:0":
        data = oracle.pillow_avif(img, subsampling=sub)
    else:
        if depth > 8:
            img = oracle.deepen(img, rng)
        data = oracle.cv2_avif(img, int(rng.integers(0, 101)),
                               None if depth == 8 else depth)
    return oracle.item_parts(data)


@pytest.mark.parametrize("depth,sub", [(8, "4:2:0"), (8, "4:2:2"),
                                       (8, "4:4:4"), (8, "4:0:0"),
                                       (10, "4:2:0"), (12, "4:2:0")])
def test_random_grain_fields_match_cv2(cv2, pil, tmp_path, depth, sub):
    # each file's film_grain_params() rewritten with random valid fields
    # (the sequence header's film_grain_params_present set): 10- and 12-bit
    # grain, which no local writer makes, among them
    rng = np.random.default_rng(depth + len(sub))
    sx, sy = SUBS[sub]
    for trial in range(8):
        obu, props = _writer_file(depth, sub, rng)
        g = oracle.grain_dict(oracle.random_grain(rng, depth, sx, sy,
                                                  sub == "4:0:0"))
        data = oracle.build_avif(oracle.with_grain(obu, g), props)
        assert _same_as_cv2(cv2, tmp_path / f"r{trial}.avif", data)
        assert _grain_applied(data) or not g["apply"]


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_identity_matrix_clip_matches_cv2(cv2, tmp_path, depth):
    # cv2's lossless files (the identity matrix, 4:4:4): grain clipped to
    # restricted range keeps chroma within luma's 16-235
    rng = np.random.default_rng(depth)
    img = oracle.avif_image("photo", 33, 47, rng)
    if depth > 8:
        img = oracle.deepen(img, rng)
    obu, props = oracle.item_parts(oracle.cv2_avif(img, 100, None if
                                                   depth == 8 else depth))
    assert oracle.port_grain_params(obu)[2][8] == 0
    for trial in range(3):
        g = oracle.grain_dict(oracle.random_grain(rng, depth, 0, 0, False))
        g["clip"] = 1
        assert _same_as_cv2(cv2, tmp_path / "i.avif", oracle.build_avif(
            oracle.with_grain(obu, g), props))


def _refusals(g0):
    """Grain fields libaom's read_film_grain_params refuses (True) or takes
    (False) at 4:2:0: name -> (fields, refused)."""
    def edit(**kw):
        g = copy.deepcopy(g0)
        g["csfl"] = 0
        g.update(kw)
        return g
    ramp = lambda n, step: [(i * step, 5 + i) for i in range(n)]  # noqa
    return {
        "y_15_points": (edit(y=ramp(15, 16)), True),
        "y_14_points": (edit(y=ramp(14, 16)), False),
        "y_equal_x": (edit(y=[(10, 1), (10, 2)]), True),
        "y_decreasing_x": (edit(y=[(20, 1), (10, 2)]), True),
        "cb_11_points": (edit(cb=ramp(11, 20), cr=[(0, 5)]), True),
        "cr_11_points": (edit(cr=ramp(11, 20), cb=[(0, 5)]), True),
        "cb_cr_10_points": (edit(cb=ramp(10, 20), cr=ramp(10, 20)), False),
        "cb_equal_x": (edit(cb=[(5, 5), (5, 6)], cr=[(0, 5)]), True),
        "cr_decreasing_x": (edit(cr=[(5, 5), (4, 6)], cb=[(0, 5)]), True),
        "cb_only": (edit(cb=[(0, 5)], cr=[]), True),
        "cr_only": (edit(cr=[(0, 5)], cb=[]), True),
        "no_luma": (edit(y=[], cb=[(0, 77)], cr=[(0, 5)]), False),
        "chroma_from_luma": (dict(g0, csfl=1), False),
        "no_chroma": (edit(cb=[], cr=[]), False),
        "not_applied": (dict(g0, apply=0), False),
    }


@pytest.mark.parametrize("sub", ["4:2:0", "4:2:2", "4:4:4"])
def test_grain_refusals_match_cv2(cv2, pil, tmp_path, sub):
    # libaom's checks: at most 14 luma and 10 chroma points, increasing
    # x, and in 4:2:0 grain on both chroma planes or neither; cv2 then
    # returns None and the port raises naming the file
    rng = np.random.default_rng(51)
    data = oracle.pillow_avif(oracle.avif_image("photo", 40, 56, rng),
                              subsampling=sub,
                              advanced={"film-grain-test": "1"})
    obu, props = oracle.item_parts(data)
    g0 = oracle.grain_dict(oracle.port_grain_params(obu)[1])
    for name, (g, refused) in _refusals(g0).items():
        if sub != "4:2:0" and name in ("cb_only", "cr_only"):
            refused = False             # the rule is 4:2:0's alone
        path = tmp_path / f"{name}.avif"
        read = _same_as_cv2(cv2, path, oracle.build_avif(
            oracle.with_grain(obu, g), props))
        assert read != refused, name
        if refused:
            with pytest.raises(RuntimeError, match="film grain"):
                read_image(str(path))


def test_grain_bit_flips_match_cv2(cv2, pil, tmp_path):
    # one flipped bit among a grain file's film grain fields: both refuse,
    # or both read the same image
    rng = np.random.default_rng(61)
    counts = {"same": 0, "both refuse": 0}
    for trial in range(40):
        img = oracle.avif_image("photo", 40, 56, rng)
        data = oracle.pillow_avif(img, advanced={
            "film-grain-test": str(trial % 16 + 1)})
        obu, props = oracle.item_parts(data)
        _, params, info = oracle.port_grain_params(obu)
        at, gbit = info[23], info[24]
        n = len(oracle.grain_bits(oracle.grain_dict(params), False, 1, 1))
        bit = gbit + int(rng.integers(0, n))
        flipped = bytearray(obu)
        flipped[at + bit // 8] ^= 0x80 >> (bit % 8)
        path = tmp_path / f"flip{trial}.avif"
        read = _same_as_cv2(cv2, path, oracle.build_avif(bytes(flipped),
                                                         props))
        counts["same" if read else "both refuse"] += 1
    assert counts["same"] and counts["both refuse"], counts


# -------------------------------------------------------------- grids


def _view(h: int, w: int, seed: int = 0) -> np.ndarray:
    return oracle.avif_image("photo", h, w, np.random.default_rng(seed))


def _tiles(img, rows, cols, tw, th, writer=oracle.cv2_avif):
    return [oracle.tile_item(writer(t))
            for t in oracle.split_tiles(img, rows, cols, tw, th)]


def _pillow(**opts):
    return lambda t: oracle.pillow_avif(t, **opts)


def _deep(depth):
    rng = np.random.default_rng(depth)
    return lambda t: oracle.cv2_avif(oracle.deepen(t, rng), 50, depth)


# name -> (rows, cols, tile w, tile h, output w, output h, tile writer)
GRIDS = {
    "2x2_420": (2, 2, 96, 64, 180, 120, oracle.cv2_avif),
    "3x2_444_odd": (2, 3, 97, 65, 289, 129, _pillow(subsampling="4:4:4")),
    "1x1_cropped": (1, 1, 100, 80, 90, 70, oracle.cv2_avif),
    "exact_cover": (2, 2, 96, 64, 192, 128, oracle.cv2_avif),
    "422_odd_height": (2, 2, 96, 65, 180, 121, _pillow(subsampling="4:2:2")),
    "400": (2, 2, 96, 64, 180, 120, _pillow(subsampling="4:0:0")),
    "gray": (2, 2, 96, 64, 180, 120, lambda t: oracle.cv2_avif(t[..., 1])),
    "10_bit": (2, 2, 96, 64, 180, 120, _deep(10)),
    "12_bit": (2, 2, 96, 64, 180, 120, _deep(12)),
    "lossless_identity": (2, 2, 64, 64, 120, 100,
                          lambda t: oracle.cv2_avif(t, 100)),
    "grain": (2, 2, 96, 64, 180, 120,
              _pillow(advanced={"film-grain-test": "5"})),
    "screen": (3, 1, 128, 64, 128, 150,
               _pillow(advanced={"tune-content": "screen"})),
    "4x1_tall": (4, 1, 64, 64, 64, 250, oracle.cv2_avif),
}


@pytest.mark.parametrize("name", list(GRIDS))
def test_grids_match_cv2(cv2, pil, tmp_path, name):
    # a grid item's tiles decoded one by one, placed in dimg order, cropped
    # to the output size, and the colour converted once over the whole
    rows, cols, tw, th, w, h, writer = GRIDS[name]
    img = _view(h, w, len(name))
    if name == "screen":
        img = oracle.screen_image("text", h, w, np.random.default_rng(3))
    data = oracle.grid_avif(_tiles(img, rows, cols, tw, th, writer), rows,
                            cols, w, h)
    assert _same_as_cv2(cv2, tmp_path / f"{name}.avif", data)
    heif = image_io._Heif(data, "g")
    heif.parse()
    tiles, _, grid = heif.primary_image()
    assert len(tiles) == rows * cols and grid == (rows, cols, w, h)


def _edit_props(tiles, k, fn):
    out = list(tiles)
    obu, props = out[k]
    out[k] = (obu, fn(props))
    return out


def _drop(kind):
    return lambda props: [(b, e) for b, e in props if b[4:8] != kind]


def _replace(kind, box):
    return lambda props: [(box if b[4:8] == kind else b, e)
                          for b, e in props]


def _av1c_xor(byte, bit):
    def fn(props):
        out = []
        for b, e in props:
            if b[4:8] == b"av1C":
                b = bytearray(b)
                b[8 + byte] ^= 1 << bit
                b = bytes(b)
            out.append((b, e))
        return out
    return fn


def _grid_cases():
    """name -> (file, whether cv2 reads it): libavif's grid rules."""
    img = _view(120, 180)
    t = _tiles(img, 2, 2, 96, 64)
    grid = lambda tiles=t, **kw: oracle.grid_avif(  # noqa: E731
        tiles, 2, 2, kw.pop("w", 180), kw.pop("h", 120), **kw)
    zzzz = struct.pack(">I4s", 8, b"zzzz")
    irot = struct.pack(">I4sB", 9, b"irot", 1)
    t444 = _tiles(img, 2, 2, 96, 64, _pillow(subsampling="4:4:4"))
    t10 = _tiles(img, 2, 2, 96, 64, _deep(10))
    tq = _tiles(img, 2, 2, 96, 64, lambda x: oracle.cv2_avif(x, 100))
    t66 = _tiles(_view(132, 180), 2, 2, 96, 66)
    seq = [o for o in oracle.obus(t[1][0]) if o[0] == 1][0]
    config = oracle.box(b"av1C", [b for b, _ in t[1][1]
                                  if b[4:8] == b"av1C"][0][8:] +
                        seq[1] + bytes([len(seq[2])]) + seq[2])
    pixi10 = [b for b, _ in t[1][1] if b[4:8] == b"pixi"][0][:13] + \
        bytes([10, 10, 10])
    return {
        "reordered": (grid(dimg=[1, 0, 3, 2]), True),
        "32_bit_sizes": (grid(payload=oracle.grid_payload(2, 2, 180, 120,
                                                          flags=1)), True),
        "other_flags": (grid(payload=oracle.grid_payload(2, 2, 180, 120,
                                                         flags=2)), True),
        "version_1": (grid(payload=oracle.grid_payload(2, 2, 180, 120,
                                                       version=1)), False),
        "trailing_byte": (grid(payload=oracle.grid_payload(2, 2, 180, 120) +
                               b"\0"), False),
        "no_size": (grid(payload=oracle.grid_payload(2, 2, 0, 120),
                         grid_props=[(oracle.ispe_box(0, 120), False)]),
                    False),
        "last_column_past": (grid(w=96), False),
        "not_covered": (grid(w=200), False),
        "tiles_under_64": (oracle.grid_avif(_tiles(img, 2, 2, 62, 64), 2, 2,
                                            120, 120), False),
        "odd_output_420": (grid(w=181), False),
        "odd_tile_422": (oracle.grid_avif(_tiles(
            img, 2, 2, 97, 64, _pillow(subsampling="4:2:2")), 2, 2, 181,
            120), False),
        "three_tiles": (grid(dimg=[0, 1, 2]), False),
        "a_tile_twice": (grid(dimg=[0, 0, 1, 2]), False),
        "grid_ispe_other": (grid(grid_props=[(oracle.ispe_box(170, 120),
                                              False)]), False),
        "grid_no_ispe": (grid(grid_props=[]), False),
        "grid_pixi_10": (grid(grid_props=[(oracle.ispe_box(180, 120),
                                           False), (pixi10, False)]), False),
        "tile_unknown_essential": (grid(_edit_props(
            t, 1, lambda p: p + [(zzzz, True)])), False),
        "tile_unknown": (grid(_edit_props(t, 1, lambda p: p + [(zzzz,
                                                                 False)])),
                         True),
        "tile_irot": (grid(_edit_props(t, 1, lambda p: p + [(irot, True)])),
                      True),
        "tile_no_ispe": (grid(_edit_props(t, 1, _drop(b"ispe"))), False),
        "tile_no_av1C": (grid(_edit_props(t, 1, _drop(b"av1C"))), False),
        "first_tile_no_av1C": (grid(_edit_props(t, 0, _drop(b"av1C"))),
                               False),
        "tile_no_pixi": (grid(_edit_props(t, 1, _drop(b"pixi"))), True),
        "tile_pixi_10": (grid(_edit_props(t, 1, _replace(b"pixi", pixi10))),
                         True),
        "tile_av1C_level": (grid(_edit_props(t, 1, _av1c_xor(1, 0))), False),
        "tile_av1C_sample_position": (grid(_edit_props(t, 2,
                                                       _av1c_xor(2, 0))),
                                      False),
        "tile_av1C_delay": (grid(_edit_props(t, 3, _av1c_xor(3, 4))), True),
        "tile_av1C_config_obus": (grid(_edit_props(t, 1, _replace(
            b"av1C", config))), True),
        "tile_ispe_other": (grid(_edit_props(t, 1, _replace(
            b"ispe", oracle.ispe_box(96, 66)))), False),
        "mixed_subsampling": (grid([t[0], t[1], t444[2], t[3]]), False),
        "mixed_depth": (grid([t[0], t10[1], t[2], t[3]]), False),
        "mixed_size": (grid([t[0], t[1], t[2], t66[3]]), False),
        "mixed_matrix": (grid([tq[0], t[1], t[2], t[3]]), False),
    }


@pytest.mark.parametrize("case", list(_grid_cases()))
def test_grid_rules_match_cv2(cv2, tmp_path, case):
    data, reads = _grid_cases()[case]
    assert _same_as_cv2(cv2, tmp_path / f"{case}.avif", data) == reads


def _alpha_tiles(img, rows, cols, tw, th, **opts):
    """(alpha OBUs, properties) tiles from Pillow's RGBA files."""
    out = []
    for t in oracle.split_tiles(img, rows, cols, tw, th):
        rgba = np.dstack([t, (t[..., 0] // 2 + t[..., 2] // 3)
                          .astype(np.uint8)])
        _, _, aobu, aprops = oracle.alpha_parts(oracle.pillow_avif(
            rgba, **opts))
        out.append((aobu, [(b, e) for b, e in aprops if b[4:8] != b"auxC"]))
    return out


@pytest.mark.parametrize("case", ["2x2", "1x2", "grain", "three_tiles",
                                  "tiles_under_64"])
def test_alpha_grids_match_cv2(cv2, pil, tmp_path, case):
    # a grid alpha item (auxl to the colour grid), decoded and checked as
    # libavif does, then dropped as cv2's 3-channel read drops it
    img = _view(120, 180, 5)
    colour = _tiles(img, 2, 2, 96, 64)
    layout = {"2x2": (2, 2, 96, 64), "1x2": (1, 2, 96, 120),
              "grain": (2, 2, 96, 64), "three_tiles": (2, 2, 96, 64),
              "tiles_under_64": (2, 4, 48, 64)}[case]
    rows, cols, tw, th = layout
    opts = {"advanced": {"film-grain-test": "4"}} if case == "grain" else {}
    alpha = _alpha_tiles(img, rows, cols, tw, th, **opts)
    if case == "three_tiles":
        alpha = alpha[:3]
    data = oracle.grid_avif(colour, 2, 2, 180, 120, alpha=(alpha, rows, cols))
    reads = case in ("2x2", "1x2", "grain")
    assert _same_as_cv2(cv2, tmp_path / f"{case}.avif", data) == reads


def test_grid_colour_from_the_grid_item(cv2, tmp_path):
    # the grid's own colr decides the conversion; without one, the tiles'
    # sequence header (cv2's tiles: BT.601 full range)
    img = _view(120, 180, 6)
    t = _tiles(img, 2, 2, 96, 64)
    assert _same_as_cv2(cv2, tmp_path / "n.avif", oracle.grid_avif(
        t, 2, 2, 180, 120, grid_props=[(oracle.ispe_box(180, 120), False)]))
    limited = [b for b, _ in t[0][1] if b[4:8] == b"colr"][0]
    limited = limited[:18] + bytes([limited[18] & 0x7F])
    path = tmp_path / "l.avif"
    path.write_bytes(oracle.grid_avif(t, 2, 2, 180, 120, grid_props=[
        (oracle.ispe_box(180, 120), False), (limited, False)]))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(RuntimeError, match="limited-range.*not read yet"):
        read_image(str(path))


def test_grid_payload_past_the_signature_window(cv2, tmp_path):
    # OpenCV's signature test parses the first 500 bytes alone: where meta
    # ends inside them, a grid payload that begins past them fails it
    t = _tiles(_view(120, 180, 7), 2, 2, 96, 64)
    seen = set()
    for n in range(8, 40):
        zzzz = struct.pack(">I4s", n, b"zzzz") + bytes(n - 8)
        data = oracle.grid_avif(t, 2, 2, 180, 120, grid_props=[
            (oracle.ispe_box(180, 120), False), (zzzz, False)] + [
            (b, False) for b, _ in t[0][1] if b[4:8] in (b"pixi", b"colr")],
            pad=0)
        payload = data.index(b"mdat") + 4
        seen.add((payload > 500, _same_as_cv2(cv2, tmp_path / "w.avif",
                                              data)))
    assert seen == {(False, True), (True, False), (True, True)}, seen


# ------------------------------------- container rules found on the way


def test_two_colr_of_a_kind_refused(cv2, tmp_path):
    # libavif takes at most one nclx and one ICC colr an item
    img = _view(50, 60, 8)
    obu, props = oracle.item_parts(oracle.cv2_avif(img))
    base = [(props[b"ispe"], False), (props[b"av1C"], True)]
    nclx = props[b"colr"]
    prof = oracle.box(b"colr", b"prof" + bytes(20))
    ricc = oracle.box(b"colr", b"rICC" + bytes(20))
    for name, colrs, reads in (("nclx_prof", [nclx, prof], True),
                               ("nclx_nclx", [nclx, nclx], False),
                               ("prof_ricc", [prof, ricc], False)):
        data = oracle.build_items([(1, b"av01", obu, base + [
            (c, False) for c in colrs])], [])
        assert _same_as_cv2(cv2, tmp_path / f"{name}.avif", data) == reads


def test_ipma_item_order_refused(cv2, pil, tmp_path):
    # libavif refuses ipma entries whose item IDs do not increase
    img = _view(50, 60, 9)
    c, cp, a, ap = oracle.alpha_parts(oracle.pillow_avif(np.dstack(
        [img, img[..., 1]])))
    refs = [(b"auxl", 2, [1])]
    assert _same_as_cv2(cv2, tmp_path / "up.avif", oracle.build_items(
        [(1, b"av01", c, cp), (2, b"av01", a, ap)], refs))
    assert not _same_as_cv2(cv2, tmp_path / "down.avif", oracle.build_items(
        [(2, b"av01", a, ap), (1, b"av01", c, cp)], refs))


@pytest.mark.parametrize("size", [(50, 60), (100, 100), (200, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_mdat_before_meta_matches_cv2(cv2, tmp_path, size):
    # an mdat before meta: OpenCV's 500-byte signature test fails where
    # meta's header lies past those bytes
    img = _view(*size, 10)
    data = oracle.cv2_avif(img)
    obu, _ = oracle.item_parts(data)
    ftyp_end = struct.unpack_from(">I", data)[0]
    meta_len = struct.unpack_from(">I", data, ftyp_end)[0]
    mdat = oracle.box(b"mdat", obu)
    moved = oracle.shift_iloc(data[:ftyp_end] + mdat +
                              data[ftyp_end:ftyp_end + meta_len], -meta_len)
    reads = _same_as_cv2(cv2, tmp_path / "m.avif", moved)
    assert reads == (ftyp_end + len(mdat) + 8 <= 500)
