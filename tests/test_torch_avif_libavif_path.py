"""The port's AVIF reader on libavif 1.4.2's own YUV → RGB path, its
scaling, a monochrome frame under a colour av1C, and two container and
stream kinds, against cv2 5.0.0 (libavif 1.4.2, libaom 3.14.1, libyuv
1924) bit for bit, or both refuse (cv2 returns None; the port raises naming
the file).

* libavif's own conversion (``image_io.libavif_builtin_rgb``), which it
  takes where libyuv has no constants for the matrix: FCC (4), SMPTE 240
  (7), YCgCo (8), 15, YCgCo-Re (16), chroma-derived NCL (12) of other
  primaries, the identity matrix at limited range; its float32 lookup
  tables, bilinear chroma, alpha and premultiplied cases.  Held to
  ``avifImageYUVToRGB`` on random planes and to ``avifCalcYUVCoefficients``
  and libavif's tables by ELF symbol.
* libavif's scaling (``image_io.avif_scale`` over ``libyuv_scale_plane``):
  an item's frame of another size than its ispe, grid tiles, alpha items
  and tracks, held to libyuv's ``ScalePlane``, ``ScalePlane_12``,
  ``ScalePlane_16`` and libavif's ``avifImageScale`` by symbol.
* A monochrome frame under a colour av1C at 10 and 12 bits and limited
  range (libavif's luma table, or libyuv's I400 rows where it converts to
  BGRA).
* An iloc item of construction method 2 (cv2 refuses it: the port's
  message said otherwise) and a scalability metadata OBU.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_image

import torch_avif_oracles as oracle


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def pil():
    pytest.importorskip("PIL.AvifImagePlugin")


_SUB = {"444": (0, 0), "422": (1, 0), "420": (1, 1)}


def _verdict(cv2, path, data):
    """"equal" (the port's decode is cv2's) or "refused" (both refuse,
    the port naming the file); fails on anything else."""
    path.write_bytes(data)
    name = os.path.basename(str(path))
    want = cv2.imread(str(path))
    try:
        got = read_image(str(path))
    except RuntimeError as err:
        assert name in str(err), str(err)
        assert want is None, f"{name}: cv2 reads it, the port: {err}"
        return "refused"
    assert want is not None, f"{name}: cv2 refuses what the port reads"
    np.testing.assert_array_equal(got, want[..., ::-1], err_msg=name)
    return "equal"


def _view(seed: int, h: int = 40, w: int = 60) -> np.ndarray:
    return oracle.avif_image("photo", h, w, np.random.default_rng(seed))


def _port_rgb(planes, depth, subx, suby, matrix, primaries, full, alpha,
              prem):
    return image_io.avif_planes_to_rgb(
        [p.astype(np.uint16) for p in planes], depth, subx, suby, matrix,
        full, "planes", primaries,
        None if alpha is None else alpha.astype(np.uint16), prem)


# ------------------------------------------ libavif's own conversion


def test_libavif_tables_are_the_library_tables():
    # the port's copies of avifColorPrimariesTables and
    # matrixCoefficientsTables are the library's float literals
    prim, mat = oracle.libavif_tables()
    assert sorted(prim) == sorted(image_io._AVIF_PRIMARIES)
    for code, values in prim.items():
        mine = np.array(image_io._AVIF_PRIMARIES[code].split(), np.float32)
        np.testing.assert_array_equal(mine, values)
    assert sorted(mat) == sorted(image_io._AVIF_KR_KB)
    for code, (kr, kb) in mat.items():
        mine = np.array(image_io._AVIF_KR_KB[code].split(), np.float32)
        np.testing.assert_array_equal(mine, [kr, kb])


def test_coefficients_match_avifCalcYUVCoefficients():
    # kr, kg, kb bit for bit: each table matrix, chroma-derived NCL under
    # every primaries code (unknown ones take BT.709's), and the codes
    # libavif defaults to BT.601's
    cases = [(m, 1) for m in range(0, 20)] + \
        [(12, p) for p in list(range(0, 26)) + [100, 255, 65535]]
    for matrix, primaries in cases:
        want = oracle.libavif_coefficients(matrix, primaries)
        got = np.array(image_io.avif_coefficients(matrix, primaries),
                       np.float32)
        np.testing.assert_array_equal(got, want, err_msg=str(cases))


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", ["444", "422", "420", "400"])
def test_builtin_conversion_matches_libavif(depth, fmt):
    # random planes (odd sides too) through avifImageYUVToRGB as cv2 asks
    # (BGR, BGRA where an alpha is present, premultiplied or not) against
    # the port's conversion: every matrix libavif converts itself, the
    # libyuv ones on a monochrome frame, full and limited range; cv2's
    # refusals (libavif's conversion fails) where the port refuses
    rng = np.random.default_rng(depth * 10 + len(fmt) + int(fmt))
    subx, suby = _SUB.get(fmt, (1, 1))
    top = (1 << depth) - 1
    matrices = [0, 4, 7, 8, 12, 15, 16] + ([1, 2, 5, 6, 9] if fmt == "400"
                                           else [])
    for k in range(40):
        h, w = int(rng.integers(1, 20)), int(rng.integers(1, 20))
        planes = [rng.integers(0, top + 1, (h, w))]
        if fmt != "400":
            planes += [rng.integers(0, top + 1, ((h + suby) >> suby,
                                                 (w + subx) >> subx))
                       for _ in range(2)]
        matrix = matrices[k % len(matrices)]
        primaries = int(rng.choice([0, 3, 4, 7, 8, 10, 11, 12, 22, 300])) \
            if matrix == 12 else 1
        full = bool(k % 2)
        alpha = rng.integers(0, top + 1, (h, w)) if k % 3 == 0 else None
        if alpha is not None:
            alpha[rng.random((h, w)) < 0.2] = 0
            alpha[rng.random((h, w)) < 0.2] = top
        prem = alpha is not None and k % 2 == 0
        try:
            want = oracle.libavif_yuv_to_rgb(
                planes, depth, subx, suby, channels=3 if alpha is None
                else 4, matrix=matrix, primaries=primaries, full=full,
                alpha=alpha, premultiplied=prem)[..., 2::-1]
        except ValueError:
            want = None
        try:
            got = _port_rgb(planes, depth, subx, suby, matrix, primaries,
                            full, alpha, prem)
        except RuntimeError:
            got = None
        case = (fmt, depth, matrix, primaries, full, alpha is not None,
                prem, h, w)
        assert (got is None) == (want is None), case
        if want is not None:
            np.testing.assert_array_equal(got, want, err_msg=str(case))


@pytest.mark.parametrize("nclx", [(1, 13, 4, True), (1, 13, 7, False),
                                  (1, 13, 8, True), (1, 13, 15, True),
                                  (3, 13, 12, True), (22, 13, 12, False),
                                  (10, 13, 12, True), (1, 13, 0, False),
                                  (1, 13, 8, False)],
                         ids=["fcc", "smpte240_limited", "ycgco",
                              "m15", "cd_ncl_p3", "cd_ncl_p22_limited",
                              "cd_ncl_xyz", "identity_limited",
                              "ycgco_limited"])
def test_libavif_matrices_match_cv2(cv2, tmp_path, nclx):
    # cv2's files at 8, 10 and 12 bits with a hand-edited nclx: the matrix
    # libavif converts on its own path (4:2:0: its bilinear chroma); the
    # identity matrix and YCgCo at limited range in libavif's encoder's
    # 4:4:4 and 4:2:0 (identity needs 4:4:4; YCgCo at limited range is
    # refused)
    rng = np.random.default_rng(sum(nclx))
    img = _view(sum(nclx), 42, 62)
    verdicts = []
    for depth in (8, 10, 12):
        src = oracle.deepen(img, rng) >> (16 - depth) if depth > 8 else img
        data = oracle.cv2_avif(src, 70, None if depth == 8 else depth)
        verdicts.append(_verdict(cv2, tmp_path / f"c{depth}.avif",
                                 oracle.with_colr(data,
                                                  [oracle.nclx(*nclx)])))
    yuv = oracle.deepen(img, rng).astype(np.int64) >> 6
    for fmt in ("444", "420"):
        sx, sy = _SUB[fmt]
        planes = [yuv[..., 0], yuv[::1 + sy, ::1 + sx, 1],
                  yuv[::1 + sy, ::1 + sx, 2]]
        data = oracle.libavif_encode(planes, 10, fmt, nclx[3])
        verdicts.append(_verdict(cv2, tmp_path / f"l{fmt}.avif",
                                 oracle.with_colr(data,
                                                  [oracle.nclx(*nclx)])))
    want = "refused" if nclx == (1, 13, 8, False) else "equal"
    if nclx[2] == 0:       # the identity matrix needs 4:4:4 chroma
        assert verdicts == ["refused"] * 3 + ["equal", "refused"]
    else:
        assert verdicts == [want] * 5, verdicts


@pytest.mark.parametrize("fmt", ["444", "420", "422"])
def test_ycgco_re_matches_cv2(cv2, tmp_path, fmt):
    # YCgCo-Re (16) at full range and 10 bits: libavif's integer lifting
    # into 8-bit RGB, any chroma format; at 8 and 12 bits, or limited
    # range, refused
    rng = np.random.default_rng(len(fmt) + int(fmt))
    sx, sy = _SUB[fmt]
    h, w = 37, 51
    y = rng.integers(0, 256, (h, w))
    planes = [y] + [rng.integers(0, 1024, ((h + sy) >> sy, (w + sx) >> sx))
                    for _ in range(2)]
    for depth, full, want in ((10, True, "equal"), (10, False, "refused"),
                              (12, True, "refused")):
        p = planes if depth == 10 else [a << 2 for a in planes]
        data = oracle.libavif_encode(p, depth, fmt, full)
        got = _verdict(cv2, tmp_path / f"re{depth}{full}.avif",
                       oracle.with_colr(data, [oracle.nclx(1, 13, 16,
                                                           full)]))
        assert got == want, (depth, full)


@pytest.mark.parametrize("prem", [False, True])
def test_libavif_path_alpha_matches_cv2(cv2, tmp_path, prem):
    # an alpha item over colour libavif converts itself (SMPTE 240, YCgCo):
    # premultiplied, 4:2:0 divides in float in the slow path, 4:4:4 takes
    # the fast path and libyuv's ARGBUnattenuate after it
    rng = np.random.default_rng(40 + prem)
    img = _view(41, 44, 58)
    deep = oracle.deepen(img, rng)
    for depth, fmt, matrix in ((10, "420", 7), (12, "444", 7),
                               (10, "444", 8), (12, "420", 8)):
        yuv = deep.astype(np.int64) >> (16 - depth)
        sx, sy = _SUB[fmt]
        colour = oracle.libavif_encode(
            [yuv[..., 0], yuv[::1 + sy, ::1 + sx, 1],
             yuv[::1 + sy, ::1 + sx, 2]], depth, fmt)
        alpha = oracle.libavif_encode([rng.integers(0, 1 << depth,
                                                    img.shape[:2])],
                                      depth, "400")
        colour = oracle.with_colr(colour, [oracle.nclx(1, 13, matrix, True)])
        data = oracle.alpha_file(colour, alpha, prem)
        assert _verdict(cv2, tmp_path / f"a{depth}{fmt}{matrix}.avif",
                        data) == "equal"


# ------------------------------------------------- a monochrome frame


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("full", [True, False])
def test_monochrome_frame_under_colour_av1c_matches_cv2(cv2, tmp_path,
                                                        depth, full):
    # cv2's gray file (a monochrome AV1 frame) with av1C's monochrome flag
    # cleared and an nclx of each kind: libavif converts the 4:0:0 frame
    # through its own luma table (identity, YCgCo at limited range and
    # YCgCo-Re refused as for colour)
    img = _view(depth + full, 38, 54)
    gray = img[..., 1].astype(np.uint16) << (depth - 8)
    data = bytearray(oracle.cv2_avif(gray if depth > 8 else img[..., 1],
                                     60, None if depth == 8 else depth))
    s, e = oracle.find_box(bytes(data), (b"meta", b"iprp", b"ipco"))
    at = [bs for k, _, bs, _ in oracle.boxes(bytes(data), s + 8, e)
          if k == b"av1C"][0]
    data[at + 10] &= ~0x10
    for matrix in (1, 6, 9, 0, 4, 7, 8, 15, 16):
        _verdict(cv2, tmp_path / f"m{matrix}.avif", oracle.with_colr(
            bytes(data), [oracle.nclx(1, 13, matrix, full)]))


@pytest.mark.parametrize("prem", [False, True])
def test_monochrome_frame_with_alpha_matches_cv2(cv2, tmp_path, prem):
    # the same frame under an alpha item: libavif converts into BGRA,
    # where libyuv's I400 rows take the 4:0:0 frame of a matrix it has
    # constants for (the identity matrix as BT.601), 10- and 12-bit
    # samples cut to 8 bits first, and its own luma table otherwise
    rng = np.random.default_rng(50 + prem)
    for depth in (8, 10, 12):
        gray = oracle.libavif_encode([rng.integers(0, 1 << depth, (30, 44))],
                                     depth, "400")
        alpha = oracle.libavif_encode([rng.integers(0, 1 << depth,
                                                    (30, 44))], depth, "400")
        gobu, _ = oracle.item_parts(gray)
        aobu, _ = oracle.item_parts(alpha)
        keep = [(b, e) for b, e in oracle.item_props(gray, 1)
                if b[4:8] not in (b"av1C", b"colr")]
        aprops = [(b, e) for b, e in oracle.item_props(alpha, 1)
                  if b[4:8] != b"colr"] + [(oracle.ALPHA_AUXC, False)]
        for matrix, full in ((1, True), (6, False), (0, False), (4, True),
                             (9, False)):
            cprops = keep + [(oracle.av1c_box(depth, 1, 1), True),
                             (oracle.nclx(1, 13, matrix, full), False)]
            refs = [(b"auxl", 2, [1])] + ([(b"prem", 1, [2])] if prem
                                          else [])
            _verdict(cv2, tmp_path / f"g{depth}{matrix}{full}.avif",
                     oracle.build_items([(1, b"av01", gobu, cprops),
                                         (2, b"av01", aobu, aprops)], refs))


# ------------------------------------------------------------ scaling


@pytest.mark.parametrize("bits", [8, 12, 16])
def test_scale_plane_matches_libyuv(bits):
    # libyuv_scale_plane against libyuv's ScalePlane / ScalePlane_12 /
    # ScalePlane_16 by symbol (box filter): each of its paths (3/4, 1/2,
    # 3/8, 1/4, the box, 2x up linear and bilinear, bilinear up and down,
    # one side equal, one-sample sides)
    rng = np.random.default_rng(bits)
    sizes = [(48, 32, 36, 24), (66, 34, 33, 17), (48, 32, 18, 12),
             (64, 40, 16, 10), (100, 90, 23, 17), (21, 13, 42, 26),
             (21, 13, 41, 25), (30, 20, 60, 20), (31, 7, 62, 2),
             (40, 30, 40, 55), (40, 30, 40, 12), (1, 9, 5, 30),
             (9, 1, 30, 1), (57, 43, 130, 77), (130, 77, 57, 43),
             (77, 130, 70, 120), (5, 5, 1, 1), (1, 1, 7, 3)]
    for _ in range(30):
        sizes.append(tuple(int(v) for v in rng.integers(1, 90, 4)))
    top = (1 << min(bits, 12)) - 1
    for sw, sh, dw, dh in sizes:
        src = rng.integers(0, top + 1, (sh, sw))
        want = oracle.libyuv_scale_plane(src, dw, dh, bits)
        got = image_io.libyuv_scale_plane(src, dw, dh, bits > 8)
        np.testing.assert_array_equal(got, want,
                                      err_msg=str((sw, sh, dw, dh)))


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", ["444", "422", "420", "400"])
def test_avif_scale_matches_avifImageScale(depth, fmt):
    # avif_scale on decoded planes (and an alpha) against libavif's own
    # avifImageScale on the same avifImage
    rng = np.random.default_rng(depth + len(fmt) * 7 + int(fmt))
    subx, suby = _SUB.get(fmt, (1, 1))
    for _ in range(8):
        h, w = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        planes = [rng.integers(0, 1 << depth, (h, w))]
        if fmt != "400":
            planes += [rng.integers(0, 1 << depth, ((h + suby) >> suby,
                                                    (w + subx) >> subx))
                       for _ in range(2)]
        alpha = rng.integers(0, 1 << depth, (h, w))
        dw, dh = int(rng.integers(1, 90)), int(rng.integers(1, 90))
        want, want_a = oracle.libavif_scale(planes, depth, subx, suby, dw,
                                            dh, alpha)
        info = [w, h, depth, subx, suby, int(fmt == "400")]
        got, ginfo = image_io.avif_scale([p.astype(np.uint16)
                                          for p in planes], info, dw, dh)
        assert ginfo[:2] == [dw, dh]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(image_io.avif_scale(
            [alpha.astype(np.uint16)], info, dw, dh)[0][0], want_a)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_item_scaled_to_its_ispe_matches_cv2(cv2, tmp_path, depth):
    # an item whose AV1 frame is not its ispe's size: libavif scales the
    # frame up or down to it (every path of the scaler), then converts
    rng = np.random.default_rng(60 + depth)
    img = _view(61, 48, 64)
    src = oracle.deepen(img, rng) >> (16 - depth) if depth > 8 else img
    data = oracle.cv2_avif(src, 60, None if depth == 8 else depth)
    obu, _ = oracle.item_parts(data)
    props = oracle.item_props(data, 1)
    for w, h in ((96, 72), (128, 96), (36, 48), (32, 24), (16, 12),
                 (127, 33), (64, 200), (1, 1), (300, 211)):
        edit = [(oracle.ispe_box(w, h) if b[4:8] == b"ispe" else b, e)
                for b, e in props]
        got = _verdict(cv2, tmp_path / f"i{w}x{h}.avif", oracle.build_items(
            [(1, b"av01", obu, edit)], []))
        assert got == "equal", (w, h)


def test_grid_tiles_scaled_to_their_ispe_match_cv2(cv2, pil, tmp_path):
    # a grid whose tiles' frames are not their ispe's size: each tile is
    # scaled to its ispe before the grid is placed (and the grid rules
    # hold on the scaled size)
    img = _view(70, 128, 192)
    tiles = [oracle.tile_item(oracle.cv2_avif(t)) for t in
             oracle.split_tiles(img[::2, ::2], 2, 3, 32, 32)]
    for size, want in (((64, 64), "equal"), ((48, 64), "refused")):
        scaled = [(obu, [(oracle.ispe_box(*size) if b[4:8] == b"ispe"
                          else b, e) for b, e in props])
                  for obu, props in tiles]
        data = oracle.grid_avif(scaled, 2, 3, 3 * size[0], 2 * size[1])
        assert _verdict(cv2, tmp_path / f"g{size[0]}.avif", data) == want


@pytest.mark.parametrize("prem", [False, True])
def test_alpha_item_scaled_matches_cv2(cv2, pil, tmp_path, prem):
    # an alpha frame of another size than its ispe (the colour's): scaled
    # to it first, then divided out where premultiplied
    rng = np.random.default_rng(80 + prem)
    rgba = np.dstack([_view(81, 48, 64), rng.integers(
        0, 256, (48, 64)).astype(np.uint8)])
    cobu, cprops, _, _ = oracle.alpha_parts(oracle.pillow_avif(
        rgba, alpha_premultiplied=prem))
    for asz in ((32, 24), (100, 75), (64, 17)):
        small = oracle.pillow_avif(np.dstack([_view(82, asz[1], asz[0]),
                                              rng.integers(0, 256, asz[::-1])
                                              .astype(np.uint8)]))
        _, _, aobu, aprops = oracle.alpha_parts(small)
        for aispe in (None, (64, 48), asz):
            ap = [(b, e) for b, e in aprops if b[4:8] != b"ispe"] + (
                [(oracle.ispe_box(*aispe), False)] if aispe else [])
            refs = [(b"auxl", 2, [1])] + ([(b"prem", 1, [2])] if prem
                                          else [])
            got = _verdict(cv2, tmp_path / f"a{asz}{aispe}.avif",
                           oracle.build_items([(1, b"av01", cobu, cprops),
                                               (2, b"av01", aobu, ap)],
                                              refs))
            # an alpha ispe of another size than the colour's is refused
            assert got == ("refused" if aispe == asz else "equal")


@pytest.mark.parametrize("prem", [False, True])
def test_tracks_scaled_to_their_tkhd_match_cv2(cv2, pil, tmp_path, prem):
    # a sequence's colour and alpha tracks whose tkhd sizes differ from
    # their frames': each frame scaled to its track's size
    img = np.dstack([_view(90, 48, 64), np.full((48, 64), 150, np.uint8)])
    (samples, props, w, h, _), (asamples, aprops, *_) = \
        oracle.sequence_parts(oracle.pillow_sequence(img))[:2]
    for tk, atk in (((96, 72), None), ((32, 24), None), ((96, 72), (96, 72)),
                    ((64, 48), (32, 24)), ((100, 75), (100, 75))):
        data = oracle.build_sequence(samples, props, w, h, tkhd_size=tk,
                                     alpha=(asamples, aprops),
                                     alpha_tkhd_size=atk,
                                     prem_by=2 if prem else 0)
        _verdict(cv2, tmp_path / f"t{tk}{atk}.avif", data)


# ------------------------------------------- container and stream kinds


@pytest.mark.parametrize("method", [2, 3, 15])
def test_iloc_construction_method_2_refused_as_cv2(cv2, tmp_path, method):
    # an item built from another item's data (construction method 2) or a
    # reserved method: libavif refuses it, so cv2 returns None; the port
    # said it read it not yet (cv2 does), a fault in its message
    obu, props = oracle.item_parts(oracle.cv2_avif(_view(100)))
    data = bytearray(oracle.build_avif(obu, props, iloc_version=1))
    at = data.find(b"iloc") + 14
    assert data[at:at + 2] == b"\0\0"
    data[at + 1] = method
    path = tmp_path / "method.avif"
    assert _verdict(cv2, path, bytes(data)) == "refused"
    with pytest.raises(RuntimeError, match="cv2 does not read: an iloc "
                                           f"construction method {method}"):
        read_image(str(path))


def _scalability(bits: str) -> bytes:
    bits += "1"
    bits += "0" * (-len(bits) % 8)
    return oracle.obu(5, bytes([3]) + int(bits, 2).to_bytes(len(bits) // 8,
                                                             "big"))


@pytest.mark.parametrize("case", ["mode0", "mode3", "ss", "ss_dims",
                                  "ss_all", "ss_cut", "no_trailing",
                                  "junk_after"])
def test_scalability_metadata_matches_cv2(cv2, tmp_path, case):
    # a scalability metadata OBU (libaom's read_metadata_scalability: its
    # mode, for SCALABILITY_SS the structure, then trailing bits and zero
    # padding) before and after the frame
    payload = {
        "mode0": _scalability("00000000"),
        "mode3": _scalability("00000011"),
        "ss": _scalability("00001110" + "00" + "000" + "000"),
        "ss_dims": _scalability("00001110" + "01" + "100" + "000" +
                                "0000000010000000" * 4),
        "ss_all": _scalability("00001110" + "00" + "111" + "000" +
                               "0" * 32 + "00000001" + "00000010" +
                               "00000" + "001" + "00000001" +
                               "00000" + "000"),
        "ss_cut": oracle.obu(5, bytes([3, 14])),
        "no_trailing": oracle.obu(5, bytes([3, 0, 0x40])),
        "junk_after": oracle.obu(5, bytes([3, 0, 0x80, 0x55])),
    }[case]
    obu, props = oracle.item_parts(oracle.cv2_avif(_view(110)))
    parts = [oracle.obu(t, p) for t, _, p in oracle.obus(obu)]
    want = "refused" if case in ("ss_cut", "no_trailing",
                                 "junk_after") else "equal"
    for where in (1, len(parts)):
        stream = b"".join(parts[:where]) + payload + b"".join(parts[where:])
        assert _verdict(cv2, tmp_path / f"{case}{where}.avif",
                        oracle.build_avif(stream, props)) == want


def test_committed_libavif_views_take_their_paths():
    # the committed timing views of this slice decode through the path
    # they stand for: libavif's own conversion, a scaled frame
    folder = os.path.join(os.path.dirname(__file__), "torch_images")
    with open(os.path.join(folder, "timing_ycgco_1297x840.avif"), "rb") as f:
        heif = image_io._Heif(f.read(), "ycgco")
    heif.parse()
    tiles, props, _ = heif.primary_image()
    assert image_io._avif_cicp(props, image_io.decode_av1(
        tiles[0][0])[1])[1] == 8
    with open(os.path.join(folder, "timing_scaled_1297x840.avif"),
              "rb") as f:
        heif = image_io._Heif(f.read(), "scaled")
    heif.parse()
    tiles, props, _ = heif.primary_image()
    info = image_io.decode_av1(tiles[0][0])[1]
    assert tuple(info[:2]) != struct.unpack_from(">II", props[b"ispe"], 4)
