"""The port's AV1 decoder on superres and the delta loop filter, against
cv2 5.0.0 (libavif 1.4.2 over libaom 3.14.1) bit for bit, or both refuse
(cv2 returns None; the port raises naming the file).

The files come from libaom's own encoder (``aom_codec_av1_cx``, the
library cv2's wheel bundles) driven through its C API by
``torch_avif_oracles.libaom_encode``, with the options ``avifenc -a``
passes and Pillow's ``advanced`` refuses: ``superres-mode`` with its
denominators (the config's ``rc_superres_*``), and ``deltaq-mode`` with
``deltalf-mode`` (its controls).  The stages are held to libaom's own
functions by ELF symbol: the upscaling to ``av1_upscale_normative_rows``
and the delta loop filter's symbols to ``read_delta_lflevel``.
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


_SUB = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}


def _planes(seed: int, h: int, w: int, depth: int, fmt: str):
    """YUV planes of a photo crop at ``depth`` bits in chroma format fmt."""
    img = oracle.avif_image("photo", h, w, np.random.default_rng(seed))
    img = img.astype(np.int64) << (depth - 8)
    sx, sy = _SUB[fmt]
    return [img[..., 0], img[::1 + sy, ::1 + sx, 1],
            img[::1 + sy, ::1 + sx, 2]]


def _read(cv2, tmp_path, name, data):
    """(the port's decode or None where it raises naming the file, cv2's
    RGB or None)."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    try:
        got = read_image(str(path))
    except RuntimeError as err:
        assert name in str(err), str(err)
        assert "not read yet" not in str(err), str(err)
        got = None
    return got, None if want is None else want[..., ::-1]


def _same_as_cv2(cv2, tmp_path, name, data):
    got, want = _read(cv2, tmp_path, name, data)
    assert want is not None, f"{name}: cv2 refuses it"
    assert got is not None, f"{name}: the port refuses what cv2 reads"
    np.testing.assert_array_equal(got, want, err_msg=name)


def _info(data):
    return image_io.decode_av1(oracle.item_parts(data)[0])[1]


# ------------------------------------------------------------- superres


@pytest.mark.parametrize("denom", range(9, 17))
def test_superres_matches_cv2(cv2, tmp_path, denom):
    # every denominator, at 8, 10 and 12 bits and each chroma format in
    # turn, loop restoration on: the frame is predicted, deblocked and
    # CDEF-filtered at the coded width, upscaled, then restored
    depth = (8, 10, 12)[denom % 3]
    fmt = ("420", "444", "422")[denom % 3] if depth > 8 else "420"
    h, w = 56 + 3 * denom, 150 + 7 * denom
    data = oracle.encoded_avif(
        _planes(denom, h, w, depth, fmt), depth, *_SUB[fmt],
        superres=(1, denom, denom),
        controls={"enable-restoration": 1, "cq-level": 20 + denom})
    info = _info(data)
    assert info[40] == denom and info[:2] == [w, h]
    assert info[41] == max(min(16, w), (w * 8 + denom // 2) // denom)
    _same_as_cv2(cv2, tmp_path, f"superres_{denom}.avif", data)
    # the planes before the colour stage are libaom's
    want = oracle.libavif_planes(data)[0]
    got = image_io.decode_av1(oracle.item_parts(data)[0])[0]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("usage", [0, 2])
def test_superres_tiles_and_loop_restoration_units(cv2, tmp_path, usage):
    # two tile columns wide enough for libaom's minimum tile width under
    # superres (128 coded samples), 128x128 superblocks or 64x64, both
    # usages (libavif's still images, its sequences' good-quality frames):
    # the restoration units lie on the upscaled frame
    data = oracle.encoded_avif(
        _planes(3 + usage, 120, 520, 8, "420"), 8, 1, 1, usage=usage,
        superres=(1, 12, 12),
        controls={"enable-restoration": 1, "tile-columns": 1,
                  "cq-level": 30})
    info = _info(data)
    assert info[40] == 12 and info[10] == 2
    assert info[29] + info[30] > 0, "no loop restoration unit decoded"
    _same_as_cv2(cv2, tmp_path, f"superres_tiles_{usage}.avif", data)


def test_superres_narrow_tiles_refused_as_cv2(cv2, tmp_path):
    # libaom's av1_is_min_tile_width_satisfied: an inner tile column of
    # 64 coded samples in an upscaled frame (libaom's own encoder writes
    # such streams with 64x64 superblocks)
    data = oracle.encoded_avif(
        _planes(4, 64, 260, 8, "420"), 8, 1, 1, superres=(1, 14, 14),
        controls={"tile-columns": 2, "deltaq-mode": 3, "cq-level": 30})
    got, want = _read(cv2, tmp_path, "narrow.avif", data)
    assert want is None and got is None
    with pytest.raises(RuntimeError, match="minimum tile width"):
        image_io.decode_av1(oracle.item_parts(data)[0])


@pytest.mark.parametrize("vector", [1, 6, 11])
def test_superres_film_grain_after_upscaling(cv2, tmp_path, vector):
    # film grain (libaom's film-grain-test vectors) is synthesised on the
    # upscaled frame
    data = oracle.encoded_avif(_planes(5, 72, 200, 8, "420"), 8, 1, 1,
                               superres=(1, 16, 16))
    stream, props = oracle.item_parts(data)
    g = oracle.grain_dict(oracle.grain_test_vectors()[vector])
    with_grain = oracle.build_avif(oracle.with_grain(stream, g), props)
    assert _info(with_grain)[22] == 1 and _info(with_grain)[40] == 16
    _same_as_cv2(cv2, tmp_path, f"superres_grain_{vector}.avif", with_grain)


@pytest.mark.parametrize("depth,ss_x", [(8, 0), (8, 1), (10, 0), (12, 1)])
def test_upscaling_matches_libaom(depth, ss_x):
    # av1_upscale_rows (the decoder's upscale_rows) against libaom's
    # av1_upscale_normative_rows by symbol, its 8-bit and high bit depth
    # rows, one or two tile columns: random coded widths and denominators
    lib = image_io._load_avif_codec()
    rng = np.random.default_rng(depth * 2 + ss_x)
    for _ in range(40):
        up = int(rng.integers(1, 600))
        denom = int(rng.integers(9, 17))
        coded = max(min(16, up), (up * 8 + denom // 2) // denom)
        aligned = (8 * ((coded + 7) >> 3)) >> ss_x
        rows = int(rng.integers(1, 5))
        src = rng.integers(0, 1 << depth, (rows, aligned)).astype(np.uint16)
        sbs = (2 * ((coded + 7) >> 3) + 15) >> 4
        tiles = None
        if sbs > 2 and rng.random() < 0.5:
            k = int(rng.integers(1, sbs))
            tiles = [k, sbs - k]
        for hbd in ((True,) if depth > 8 else (False, True)):
            want = oracle.libaom_upscale_rows(src, coded, up, denom, ss_x,
                                              depth, hbd, tiles)
            uw = (up + ss_x) >> ss_x
            got = np.zeros((rows, uw), np.uint16)
            lib.av1_upscale_rows(
                src.ctypes.data_as(ctypes.c_void_p), aligned,
                got.ctypes.data_as(ctypes.c_void_p), uw,
                (coded + ss_x) >> ss_x, uw, rows, aligned - 1, depth)
            np.testing.assert_array_equal(got, want)


# --------------------------------------------------- delta loop filter


@pytest.mark.parametrize("mode", [2, 3, 6])
def test_delta_loop_filter_matches_cv2(cv2, tmp_path, mode):
    # libaom's deltaq-mode 2, 3 and 6 with deltalf-mode 1 write
    # delta_lf_present and per-superblock DeltaLF; at 8, 10 and 12 bits,
    # one with superres too (libaom's cpu-used 7 corrupts its own heap with
    # deltalf-mode, so these stay at its default speed)
    depth = {2: 8, 3: 10, 6: 12}[mode]
    fmt = {2: "420", 3: "444", 6: "422"}[mode]
    for sr in (None, (1, 11, 11)):
        data = oracle.encoded_avif(
            _planes(mode, 160, 300, depth, fmt), depth, *_SUB[fmt],
            superres=sr, controls={"deltaq-mode": mode, "deltalf-mode": 1,
                                   "cq-level": 40})
        info = _info(data)
        assert info[16] == 1 and info[42] == 1 and info[44] > 0, info[40:]
        _same_as_cv2(cv2, tmp_path, f"deltalf_{mode}_{bool(sr)}.avif",
                     data)


def test_delta_lf_multi_matches_cv2(cv2, tmp_path):
    # delta_lf_multi (one DeltaLF a filter: 4, 2 for a monochrome frame),
    # which libaom's encoder never sets: the header bit set by hand, the
    # symbols then read from the same data by both decoders; and each
    # bit of delta_lf_res
    data = oracle.encoded_avif(_planes(7, 160, 300, 8, "420"), 8, 1, 1,
                               controls={"deltaq-mode": 3,
                                         "deltalf-mode": 1,
                                         "cq-level": 40})
    stream, _ = oracle.item_parts(data)
    info = _info(data)
    bit = 8 * info[23] + info[45]
    off = len(data) - len(stream)
    verdicts = []
    for flip in (3, 1, 2, (1, 3), (2, 3)):
        edit = bytearray(data)
        for b in (flip if isinstance(flip, tuple) else (flip,)):
            edit[off + (bit + b) // 8] ^= 0x80 >> ((bit + b) % 8)
        got, want = _read(cv2, tmp_path, f"multi_{flip}.avif", bytes(edit))
        assert (got is None) == (want is None), flip
        if want is not None:
            np.testing.assert_array_equal(got, want)
        verdicts.append(want is not None)
    assert any(verdicts), "cv2 refused every edit"


@pytest.mark.parametrize("disable_update", [False, True])
def test_delta_lf_symbols_match_libaom(disable_update):
    # av1_read_delta_lf (read_delta_lf_symbol) against libaom's
    # read_delta_lflevel by symbol on the same bytes, the CDF adapting or
    # not; data of mostly-set bits reach the remainder bits too
    lib = image_io._load_avif_codec()
    rng = np.random.default_rng(int(disable_update))
    for k in range(40):
        data = rng.integers(0, 256, 200).astype(np.uint8)
        if k % 2:
            data |= rng.integers(0, 256, 200).astype(np.uint8)
        data = data.tobytes()
        want = oracle.libaom_delta_lf(data, 50, disable_update)
        out = (ctypes.c_int * 50)()
        assert lib.av1_read_delta_lf(data, len(data), 50,
                                     int(disable_update), out) == 0
        assert list(out) == want


def test_encoder_options_are_its_controls():
    # the control ids libaom_encode passes are the ones the library's
    # encoder_ctrl_maps pairs with its ctrl_set_* functions
    ids = oracle.aom_control_ids()
    names = {"cpu-used": "cpuused", "cq-level": "cq_level",
             "tile-columns": "tile_columns", "tile-rows": "tile_rows",
             "color-range": "color_range", "enable-cdef": "enable_cdef",
             "enable-restoration": "enable_restoration",
             "enable-superres": "enable_superres",
             "deltaq-mode": "deltaq_mode", "deltalf-mode": "deltalf_mode"}
    for opt, cid in oracle.AOM_CONTROLS.items():
        assert ids[f"ctrl_set_{names[opt]}"] == cid, opt


def test_committed_superres_and_delta_lf_views_use_the_tools():
    # the committed fixtures of this kind decode with each tool in use
    folder = os.path.join(os.path.dirname(__file__), "torch_images")
    for name, (col, least) in {
            "avif_superres_d8.avif": (40, 9),
            "avif_superres_d10_444.avif": (40, 9),
            "avif_superres_d12_422.avif": (40, 9),
            "avif_deltalf.avif": (44, 1),
            "timing_superres_1297x840.avif": (40, 9),
            "timing_deltalf_1297x840.avif": (44, 1)}.items():
        with open(os.path.join(folder, name), "rb") as f:
            info = _info(f.read())
        assert info[col] >= least, (name, info[40:])
