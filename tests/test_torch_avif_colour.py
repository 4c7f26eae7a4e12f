"""The port's AVIF reader on the colour and orientation kinds, against cv2
5.0.0 (libavif 1.4.2, libyuv 1924) bit for bit, or both refuse (cv2
returns None; the port raises naming the file), or the port raises naming
a kind it does not read yet where libavif converts on its own path.

The kinds: an nclx ``colr`` after an ICC one (Pillow's ``icc_profile=``,
the repaired fault: the port kept only the first ``colr``), the
transformative properties ``irot``, ``imir`` and ``clap`` (Pillow's EXIF
orientations; cv2 reads the image as coded), limited range and libyuv's
BT.601, BT.709 and BT.2020 NCL tables as libavif picks them by matrix,
range and colour primaries, an alpha's own path past 8 bits (libyuv's
10-bit rows, its 12-bit 4:2:0 one, libavif's downshift) and a
premultiplied alpha (``prem``: libyuv's ``ARGBUnattenuate``).  Each stage
is also held to its oracle by ELF symbol in the libavif that cv2's wheel
bundles: libyuv's constant tables, its row conversions and unattenuate,
libavif's ``avifLimitedToFullY``.  Files come from Pillow, from cv2, from
libavif's own encoder (10- and 12-bit 4:2:2 and 4:4:4, 4:0:0 alpha frames)
and from hand-edited boxes (``torch_avif_oracles``).
"""

import ctypes
import os

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


def _verdict(cv2, path, data=None):
    """The port against cv2 on one file: "equal" (bit for bit), "refused"
    (cv2 returns None, the port raises naming the file) or "not read yet"
    (cv2 reads it, the port raises naming the file and saying so); fails
    on anything else."""
    if data is not None:
        path.write_bytes(data)
    name = os.path.basename(str(path))
    want = cv2.imread(str(path))
    try:
        got = read_image(str(path))
    except RuntimeError as err:
        assert name in str(err), str(err)
        if want is None:
            return "refused"
        assert "not read yet" in str(err), str(err)
        return "not read yet"
    assert want is not None, f"{name}: cv2 refuses what the port reads"
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1], err_msg=name)
    return "equal"


def _view(seed: int, h: int = 40, w: int = 60) -> np.ndarray:
    return oracle.avif_image("photo", h, w, np.random.default_rng(seed))


# ------------------------------------------------ nclx after an ICC colr


@pytest.mark.parametrize("form", ["still", "sequence"])
def test_icc_profile_then_nclx_reads_as_cv2(cv2, pil, tmp_path, form):
    # the repaired fault: Pillow writes colr prof, then colr nclx 2/2/6
    # over a stream whose matrix is 2; the nclx sets the colour
    write = oracle.pillow_sequence if form == "sequence" else \
        oracle.pillow_avif
    data = write(_view(1), icc_profile=oracle.icc_profile())
    assert _verdict(cv2, tmp_path / f"icc_{form}.avif", data) == "equal"


@pytest.mark.parametrize("nclx", [(1, 13, 6, False), (1, 13, 1, True),
                                  (1, 13, 7, True)],
                         ids=["601_limited", "709_full", "smpte240"])
def test_nclx_after_hand_made_icc_colr(cv2, tmp_path, nclx):
    # cv2's file with a colr prof and then an nclx: the nclx's matrix and
    # range are the colour's (before the repair the port decoded these by
    # the stream's BT.601 full range: max abs diff 20 and 17), SMPTE 240
    # through libavif's own path (libavif_builtin_rgb) too
    data = oracle.cv2_avif(_view(2, 48, 64))
    for order in ("icc_first", "nclx_first"):
        colrs = [oracle.box(b"colr", b"prof" + oracle.icc_profile()),
                 oracle.nclx(*nclx)]
        if order == "nclx_first":
            colrs = colrs[::-1]
        got = _verdict(cv2, tmp_path / f"{order}.avif",
                       oracle.with_colr(data, colrs))
        assert got == "equal"


@pytest.mark.parametrize("colrs", [
    ("nclx", "nclx"), ("prof", "rICC"), ("prof", "prof"), ("rICC", "nclx"),
    ("zzzz", "nclx"), ("nclx_short",), ("nclx_reserved",)])
def test_colr_kinds_and_counts_match_cv2(cv2, tmp_path, colrs):
    # one colr of each kind: a second nclx or ICC is refused, an unknown
    # colour type ignored, an nclx cut short or with reserved bits refused
    boxes = {"nclx": oracle.nclx(1, 13, 1, False),
             "prof": oracle.box(b"colr", b"prof" + oracle.icc_profile()),
             "rICC": oracle.box(b"colr", b"rICC" + oracle.icc_profile()),
             "zzzz": oracle.box(b"colr", b"zzzz\0\0"),
             "nclx_short": oracle.box(b"colr", b"nclx\0\1\0\1\0"),
             "nclx_reserved": oracle.box(b"colr", b"nclx\0\1\0\1\0\1\x81")}
    data = oracle.with_colr(oracle.cv2_avif(_view(3, 48, 64)),
                            [boxes[k] for k in colrs])
    want = "refused" if colrs in (("nclx", "nclx"), ("prof", "rICC"),
                                  ("prof", "prof"), ("nclx_short",),
                                  ("nclx_reserved",)) else "equal"
    assert _verdict(cv2, tmp_path / "colr.avif", data) == want


# ------------------------------------------------ irot, imir, clap


def _clap(*fields) -> bytes:
    return oracle.box(b"clap", b"".join(
        (v & 0xFFFFFFFF).to_bytes(4, "big") for v in fields))


_TRANSFORMS = {
    "irot": ([(oracle.box(b"irot", b"\x03"), True)], "equal"),
    "irot_long": ([(oracle.box(b"irot", b"\x01\x00"), True)], "equal"),
    "irot_reserved": ([(oracle.box(b"irot", b"\x05"), True)], "refused"),
    "irot_empty": ([(oracle.box(b"irot", b""), True)], "refused"),
    "irot_not_essential": ([(oracle.box(b"irot", b"\x01"), False)],
                           "refused"),
    "imir": ([(oracle.box(b"imir", b"\x01"), True)], "equal"),
    "imir_reserved": ([(oracle.box(b"imir", b"\x03"), True)], "refused"),
    "imir_not_essential": ([(oracle.box(b"imir", b"\x00"), False)],
                           "refused"),
    "clap_whole": ([(_clap(64, 1, 48, 1, 0, 1, 0, 1), True)], "equal"),
    "clap_crop": ([(_clap(41, 1, 21, 1, -3, 2, 5, 1), True)], "equal"),
    "clap_invalid": ([(_clap(640, 0, 48, 1, 0, 1, 0, 1), True)], "equal"),
    "clap_cut": ([(oracle.box(b"clap", bytes(28)), True)], "refused"),
    "clap_not_essential": ([(_clap(64, 1, 48, 1, 0, 1, 0, 1), False)],
                           "refused"),
    "all_three": ([(_clap(40, 1, 20, 1, 0, 1, 0, 1), True),
                   (oracle.box(b"irot", b"\x02"), True),
                   (oracle.box(b"imir", b"\x00"), True)], "equal"),
}


@pytest.mark.parametrize("kind", list(_TRANSFORMS))
def test_item_transforms_match_cv2(cv2, tmp_path, kind):
    # cv2 reads the image as coded whatever the transforms say; libavif's
    # own checks refuse a malformed box and one not marked essential
    extra, want = _TRANSFORMS[kind]
    data = oracle.cv2_avif(_view(4, 48, 64))
    obu, _ = oracle.item_parts(data)
    props = oracle.item_props(data, 1)
    got = _verdict(cv2, tmp_path / f"{kind}.avif", oracle.build_items(
        [(1, b"av01", obu, props + extra)], []))
    assert got == want


@pytest.mark.parametrize("box", ["irot_reserved", "clap_cut",
                                 "irot_not_essential", "irot"])
def test_transforms_on_other_items_match_cv2(cv2, tmp_path, box):
    # libavif parses every property of ipco and checks every association:
    # a malformed box on an item it never reads is refused all the same
    extra, _ = _TRANSFORMS[box]
    data = oracle.cv2_avif(_view(5, 48, 64))
    obu, _ = oracle.item_parts(data)
    props = oracle.item_props(data, 1)
    got = _verdict(cv2, tmp_path / f"other_{box}.avif", oracle.build_items(
        [(1, b"av01", obu, props), (2, b"zzzz", b"data", extra)], []))
    assert got == ("equal" if box == "irot" else "refused")


@pytest.mark.parametrize("kind", ["irot", "imir", "clap_whole"])
def test_transform_on_the_alpha_item_refused(cv2, pil, tmp_path, kind):
    rgba = np.dstack([_view(6), np.full((40, 60), 200, np.uint8)])
    data = oracle.pillow_avif(rgba)
    cobu, cprops, aobu, aprops = oracle.alpha_parts(data)
    got = _verdict(cv2, tmp_path / f"alpha_{kind}.avif", oracle.build_items(
        [(1, b"av01", cobu, cprops),
         (2, b"av01", aobu, aprops + _TRANSFORMS[kind][0])],
        [(b"auxl", 2, [1])]))
    assert got == "refused"


@pytest.mark.parametrize("value", [1, 2, 3, 4, 5, 6, 7, 8])
def test_pillow_exif_orientations_read_as_cv2(cv2, pil, tmp_path, value):
    # Pillow writes an essential irot and/or imir and drops the tag; cv2's
    # image is the one saved without EXIF
    img = _view(7)
    data = oracle.pillow_avif(img, exif=oracle.orientation_exif(value))
    assert _verdict(cv2, tmp_path / f"exif{value}.avif", data) == "equal"
    plain = tmp_path / "plain.avif"
    plain.write_bytes(oracle.pillow_avif(img))
    np.testing.assert_array_equal(read_image(str(tmp_path /
                                                 f"exif{value}.avif")),
                                  read_image(str(plain)))


@pytest.mark.parametrize("extra", [
    ("irot", "imir"), ("clap_whole",), ("irot_reserved",), ("clap_cut",)])
def test_track_transforms_match_cv2(cv2, pil, tmp_path, extra):
    # the sample entry's transforms (Pillow segfaults writing a sequence
    # with an EXIF orientation, so the boxes are added here)
    samples, props, w, h, _ = oracle.sequence_parts(
        oracle.pillow_sequence(_view(8)))[0]
    boxes = {"irot": oracle.box(b"irot", b"\x01"),
             "imir": oracle.box(b"imir", b"\x01"),
             "clap_whole": _clap(60, 1, 40, 1, 0, 1, 0, 1),
             "irot_reserved": oracle.box(b"irot", b"\x09"),
             "clap_cut": oracle.box(b"clap", bytes(20))}
    data = oracle.build_sequence(samples, props, w, h,
                                 extra=[boxes[k] for k in extra])
    want = "refused" if extra in (("irot_reserved",), ("clap_cut",)) \
        else "equal"
    assert _verdict(cv2, tmp_path / "track.avif", data) == want


# ------------------------------------------------ range and matrices


@pytest.mark.parametrize("form", ["still", "sequence", "444", "422"])
def test_pillow_limited_range_reads_as_cv2(cv2, pil, tmp_path, form):
    img = _view(9)
    if form == "sequence":
        data = oracle.pillow_sequence(img, range="limited")
    else:
        sub = {"still": {}, "444": dict(subsampling="4:4:4"),
               "422": dict(subsampling="4:2:2")}[form]
        data = oracle.pillow_avif(img, range="limited", **sub)
    assert _verdict(cv2, tmp_path / f"limited_{form}.avif", data) == "equal"


# matrix codes by what libavif 1.4.2 does with them (cv2 verdicts): libyuv
# tables for 1, 2, 5, 6, 9 and 12 under primaries 1, 2, 5, 6, 9; its own
# path for 4, 7, 8 (full range), 15, 16 (full range, 10 bits), 12 under
# other primaries and the identity matrix at limited range; refused:
# 3, 10, 11, 13, 14, 17 up, 8 at limited range, 16 otherwise, the identity
# matrix with subsampled chroma
_MATRICES = [(m, 1) for m in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14,
                              15, 16, 17, 18, 255)] + \
    [(12, p) for p in (1, 2, 4, 5, 6, 9, 12)]


def _encoded(depth: int, fmt: str, seed: int):
    """libavif's file of a photo's channels as Y, U and V planes."""
    sx, sy = {"444": (0, 0), "422": (1, 0), "420": (1, 1)}[fmt]
    img = _view(seed, 34, 50).astype(np.int64) << (depth - 8)
    return oracle.libavif_encode([img[..., 0], img[::1 << sy, ::1 << sx, 1],
                                  img[::1 << sy, ::1 << sx, 2]], depth, fmt)


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", ["420", "422", "444"])
def test_matrices_and_ranges_match_cv2(cv2, tmp_path, depth, fmt):
    # each code at both ranges through a hand-edited nclx: equal where
    # libavif converts through libyuv or its identity path, refused where
    # cv2 refuses, not read yet where libavif takes its own path
    data = _encoded(depth, fmt, 10 + depth)
    seen = {}
    for matrix, primaries in _MATRICES:
        for full in (True, False):
            got = _verdict(cv2, tmp_path / "m.avif", oracle.with_colr(
                data, [oracle.nclx(primaries, 13, matrix, full)]))
            seen[matrix, primaries, full] = got
            libyuv = (matrix in (1, 2, 5, 6, 9) or (
                matrix == 12 and primaries in (1, 2, 5, 6, 9)))
            if libyuv or (matrix == 0 and full and fmt == "444"):
                assert got == "equal", (matrix, primaries, full)
    assert list(seen.values()).count("equal") >= 16


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_hand_edited_cv2_matrices_read_as_cv2(cv2, tmp_path, depth):
    # cv2's own 4:2:0 files at 8, 10 and 12 bits with BT.709 and BT.2020
    # NCL nclx, full and limited range
    img = _view(11, 48, 64)
    data = oracle.cv2_avif(img if depth == 8 else oracle.deepen(
        img, np.random.default_rng(depth)), depth=None if depth == 8
        else depth)
    for matrix, primaries in ((1, 1), (9, 9), (6, 1), (5, 5)):
        for full in (True, False):
            assert _verdict(cv2, tmp_path / "hand.avif", oracle.with_colr(
                data, [oracle.nclx(primaries, 13, matrix, full)])) == "equal"


# ------------------------------------------------ alpha and prem


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", ["420", "422", "444"])
def test_alpha_paths_and_premultiplication_match_cv2(cv2, tmp_path, depth,
                                                      fmt):
    # an alpha item of the colour's depth, full or limited range, with and
    # without prem, under libyuv's BT.709 limited table and the identity
    # matrix: libyuv's 10-bit rows, its 12-bit 4:2:0 row, libavif's
    # downshift, the unattenuate, libavif's float division on its identity
    # path past 8 bits
    rng = np.random.default_rng(depth)
    colour = _encoded(depth, fmt, 20 + depth)
    for afull in (True, False):
        alpha = oracle.libavif_encode([rng.integers(0, 1 << depth, (34, 50))],
                                      depth, "400", afull)
        for prem in (False, True):
            for matrix, full in ((1, False), (6, True), (0, True)):
                if matrix == 0 and fmt != "444":
                    continue
                data = oracle.alpha_file(
                    oracle.with_colr(colour, [oracle.nclx(1, 13, matrix,
                                                          full)]),
                    alpha, prem)
                assert _verdict(cv2, tmp_path / "a.avif", data) == "equal", \
                    (afull, prem, matrix)


@pytest.mark.parametrize("form", ["still", "sequence", "422", "444"])
def test_pillow_premultiplied_alpha_reads_as_cv2(cv2, pil, tmp_path, form):
    # Pillow's alpha_premultiplied=True: the colour divided by an alpha
    # that runs through 0, 1, 2, 127, 128, 254 and 255 under a ramp of
    # colours, as libyuv's unattenuate divides it
    img = oracle.avif_image("smooth", 40, 64, np.random.default_rng(12))
    alpha = np.tile(np.array([0, 1, 2, 127, 128, 254, 255, 64], np.uint8),
                    8)[None].repeat(40, 0)
    rgba = np.dstack([img, alpha])
    if form == "sequence":
        data = oracle.pillow_sequence(rgba, alpha_premultiplied=True)
    else:
        sub = {"still": {}, "444": dict(subsampling="4:4:4"),
               "422": dict(subsampling="4:2:2")}[form]
        data = oracle.pillow_avif(rgba, alpha_premultiplied=True, **sub)
    assert _verdict(cv2, tmp_path / f"prem_{form}.avif", data) == "equal"


def test_track_alpha_of_its_own_range_and_prem(cv2, pil, tmp_path):
    # a sequence's alpha track: limited range made full, a prem tref from
    # the colour track, as libavif reads an item's
    rng = np.random.default_rng(13)
    samples, props, w, h, _ = oracle.sequence_parts(
        oracle.pillow_sequence(_view(14)))[0]
    alpha = oracle.libavif_encode([rng.integers(0, 256, (h, w))], 8, "400",
                                  False)
    aobu, aprops = oracle.item_parts(alpha)
    aprops = {b"av1C": aprops[b"av1C"]}
    for prem in (0, 2):
        data = oracle.build_sequence(samples, props, w, h,
                                     alpha=([aobu, aobu], aprops),
                                     prem_by=prem)
        assert _verdict(cv2, tmp_path / f"track_{prem}.avif",
                        data) == "equal"


def test_premultiplied_alpha_of_another_size_not_read_yet(cv2, pil,
                                                          tmp_path):
    # libavif scales an alpha frame of another size than its item's before
    # dividing by it (avif_scale, libyuv's box filter); the port reads the
    # file as cv2 reads it
    rgba = np.dstack([_view(15, 48, 64), np.full((48, 64), 160, np.uint8)])
    colour = oracle.pillow_avif(rgba, alpha_premultiplied=True)
    cobu, cprops, _, aprops = oracle.alpha_parts(colour)
    small = oracle.pillow_avif(np.dstack([_view(15, 24, 32), np.full(
        (24, 32), 160, np.uint8)]))
    aobu = oracle.alpha_parts(small)[2]
    data = oracle.build_items([(1, b"av01", cobu, cprops),
                               (2, b"av01", aobu, aprops)],
                              [(b"auxl", 2, [1]), (b"prem", 1, [2])])
    assert _verdict(cv2, tmp_path / "small_alpha.avif", data) == "equal"


# ------------------------------------------------ stages by symbol


def test_libyuv_constants_are_the_library_tables():
    names = {("601", True): "kYuvJPEGConstants",
             ("601", False): "kYuvI601Constants",
             ("709", True): "kYuvF709Constants",
             ("709", False): "kYuvH709Constants",
             ("2020", True): "kYuvV2020Constants",
             ("2020", False): "kYuv2020Constants"}
    for key, name in names.items():
        t = oracle.libavif_table(name, np.uint8, (160,))
        y = t[96:128].view(np.int16)
        yb = t[128:160].view(np.int16)
        # kUVToB, kUVToG (u, v), kUVToR, kYToRgb, kYBiasToRgb
        assert image_io._LIBYUV_CONSTANTS[key] == (
            t[0], t[32], t[33], t[65], y[0], yb[0]), name
    tbl = oracle.libavif_table("fixed_invtbl8", np.uint32, (256,))
    np.testing.assert_array_equal(image_io._UNATTENUATE, tbl & 0xFFFF)


def test_unattenuate_matches_libyuv():
    # every colour under every alpha, odd widths too, against libyuv's
    # ARGBUnattenuate (its dispatcher: the AVX2 row on this CPU) and its
    # SSE2 and AVX2 rows by symbol
    v = np.arange(256, dtype=np.uint8)
    px = np.zeros((256, 256, 4), np.uint8)
    px[..., :3] = v[None, :, None]
    px[..., 3] = v[:, None]
    want = px.copy()
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int)(oracle.libavif_symbol(
                              "ARGBUnattenuate"))
    assert fn(px.ctypes.data, 1024, want.ctypes.data, 1024, 256, 256) == 0
    got = image_io.unattenuate(px[..., :3], px[..., 3])
    np.testing.assert_array_equal(got, want[..., :3])
    np.testing.assert_array_equal(want[..., 3], px[..., 3])
    with open("/proc/cpuinfo") as f:
        flags = set(next((line for line in f if line.startswith("flags")),
                         "").split())
    for row, flag in (("ARGBUnattenuateRow_SSE2", "sse2"),
                      ("ARGBUnattenuateRow_AVX2", "avx2")):
        if flag not in flags:
            continue
        fn_row = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int)(oracle.libavif_symbol(row))
        out = px.copy()
        for a in range(256):
            fn_row(px[a].ctypes.data, out[a].ctypes.data, 256)
        np.testing.assert_array_equal(out, want, err_msg=row)
    rng = np.random.default_rng(16)
    for width in (1, 7, 13, 33):
        odd = rng.integers(0, 256, (3, width, 4)).astype(np.uint8)
        out = odd.copy()
        assert fn(odd.ctypes.data, 4 * width, out.ctypes.data, 4 * width,
                  width, 3) == 0
        np.testing.assert_array_equal(
            image_io.unattenuate(odd[..., :3], odd[..., 3]), out[..., :3])


def _yuv_call(name, planes, constants, width, height, *extra):
    """libyuv's YUV(A) → ARGB function ``name`` on 16-bit planes (strides
    in samples) → (H, W, 4) BGRA."""
    i, vp = ctypes.c_int, ctypes.c_void_p
    out = np.zeros((height, width, 4), np.uint8)
    ps = [np.ascontiguousarray(p.astype(np.uint16)) for p in planes]
    args, types = [], []
    for p in ps:
        args += [p.ctypes.data, p.shape[1]]
        types += [vp, i]
    args += [out.ctypes.data, 4 * width, constants, width, height, *extra]
    types += [vp, i, vp, i, i] + [i] * len(extra)
    assert ctypes.CFUNCTYPE(i, *types)(oracle.libavif_symbol(name))(
        *args) == 0
    return out


@pytest.mark.parametrize("kind", ["601", "709", "2020"])
@pytest.mark.parametrize("full", [True, False])
def test_high_depth_rows_match_libyuv(kind, full):
    # the port's 10-bit (I410Alpha, I210AlphaFilter linear, I010AlphaFilter
    # bilinear) and 12-bit 4:2:0 (I012ToARGBMatrix) conversions against
    # libyuv's own functions by symbol, on random planes of odd and even
    # sizes
    names = {("601", True): "kYuvJPEGConstants",
             ("601", False): "kYuvI601Constants",
             ("709", True): "kYuvF709Constants",
             ("709", False): "kYuvH709Constants",
             ("2020", True): "kYuvV2020Constants",
             ("2020", False): "kYuv2020Constants"}
    table = ctypes.c_void_p(oracle.libavif_symbol(names[kind, full]))
    constants = image_io._LIBYUV_CONSTANTS[kind, full]
    rng = np.random.default_rng(17)
    for height, width in ((6, 8), (7, 9), (1, 5), (16, 33)):
        for name, depth, sx, sy, extra in (
                ("I410AlphaToARGBMatrix", 10, 0, 0, ()),
                ("I210AlphaToARGBMatrixFilter", 10, 1, 0, (2,)),
                ("I010AlphaToARGBMatrixFilter", 10, 1, 1, (2,)),
                ("I012ToARGBMatrix", 12, 1, 1, ())):
            y = rng.integers(0, 1 << depth, (height, width))
            cshape = ((height + sy) >> sy, (width + sx) >> sx)
            u, v = (rng.integers(0, 1 << depth, cshape) for _ in range(2))
            a = rng.integers(0, 1 << depth, (height, width))
            planes = [y, u, v] + ([] if name.startswith("I012") else [a])
            want = _yuv_call(name, planes, table, width, height,
                             *((0,) + extra if len(planes) == 4 else ()))
            got = image_io.avif_planes_to_rgb(
                [y, u, v], depth, sx, sy, {"601": 6, "709": 1,
                                           "2020": 9}[kind], full,
                primaries=1, alpha=a)
            np.testing.assert_array_equal(got, want[..., 2::-1],
                                          err_msg=f"{name} {height}x{width}")


def test_alpha_limited_to_full_matches_libavif():
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_uint32, ctypes.c_int)(
        oracle.libavif_symbol("avifLimitedToFullY"))
    for depth in (8, 10, 12):
        v = np.arange(1 << depth)
        want = [fn(depth, int(x)) for x in v]
        np.testing.assert_array_equal(
            image_io.alpha_limited_to_full(v, depth), want)


def test_colour_stage_matches_libavif(cv2, pil):
    # the conversion alone, alpha and prem included: libavif's planes
    # through the port's stage equal libavif's own avifImageYUVToRGB
    rgba = np.dstack([_view(18, 48, 64),
                      np.random.default_rng(18).integers(
                          0, 256, (48, 64)).astype(np.uint8)])
    for opts in (dict(alpha_premultiplied=True), dict(range="limited"),
                 dict(subsampling="4:4:4", alpha_premultiplied=True)):
        data = oracle.pillow_avif(rgba, **opts)
        heif = image_io._Heif(data, "file")
        heif.parse()
        obu, props = heif.primary_item()
        planes, depth, (sx, sy) = oracle.libavif_planes(data)
        alpha = image_io.decode_av1(heif.alpha_item()[0][0][0])[0][0]
        primaries, matrix, full = image_io._avif_cicp(
            props, image_io.decode_av1(obu)[1])
        got = image_io.avif_planes_to_rgb(
            planes, depth, sx, sy, matrix, full, primaries=primaries,
            alpha=alpha, premultiplied=heif.prem_by == heif.alpha)
        np.testing.assert_array_equal(
            got, oracle.libavif_bgra(data)[..., 2::-1], err_msg=str(opts))
