"""The port's JPEG 2000 reader on Part 2's CBD, MCT, MCC and MCO markers
(``csrc/jpeg2000_codec.cpp``: ``read_cbd``, ``read_mct``, ``read_mcc``,
``read_mco``, ``add_mct``) against cv2 5.0.0 (OpenJPEG 2.5.3): every file
decodes to ``cv2.imread(path)[..., ::-1]`` bit for bit, or both refuse and
the port's message names the file.

The files are the system libopenjp2's (``opj_set_MCT`` through
``torch_make_image_fixtures.openjpeg_encode``: the 9/7, COD's MCT byte 2,
CBD, MCT, MCC and MCO as its encoder writes them) and hand edits of them
and of Part 1 and HT codestreams: each marker's fields, lengths and
element types, its place (main or tile-part header), its absence.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_image

import torch_j2k_ht as ht
import torch_make_image_fixtures as fx

H, W = 27, 35


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def same_as_cv2(cv2, path, data) -> bool:
    """Equal to cv2's decode, or both refuse → whether cv2 read it."""
    path.write_bytes(data)
    try:
        want = cv2.imread(str(path))
    except cv2.error:
        want = None
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


# the marker writers are torch_j2k_ht's
split, join, seg, mct, mcc, mco, cbd = (
    ht.main_markers, ht.join_markers, ht.seg, ht.mct, ht.mcc, ht.mco, ht.cbd)


def _planes(seed=0):
    img = fx.fixture_image(H, W, seed=seed)
    return [img[..., k] for k in range(3)]


def _opj(offsets=(0, 0, 0), matrix=None, seed=0, **kw) -> bytes:
    """libopenjp2's own Part 2 file: opj_set_MCT with an encoding matrix
    and per-component offsets."""
    m = np.eye(3) if matrix is None else matrix
    return fx.openjpeg_encode(_planes(seed), mct_array=(m, offsets), **kw)


def _cod_mct(cs: bytes, value: int) -> bytes:
    ms, rest = split(cs)
    for code, body in ms:
        if code == 0xFF52:
            body[4] = value
    return join(ms, rest)


def _drop(cs: bytes, *codes) -> tuple:
    ms, rest = split(cs)
    return [m for m in ms if m[0] not in codes], rest


def _with(cs: bytes, *extra, after=0xFF5C, drop=(0xFF74, 0xFF75, 0xFF77,
                                                  0xFF78)) -> bytes:
    """A codestream with its Part 2 markers replaced by ``extra`` (put
    after the marker ``after``), COD's MCT byte 0."""
    ms, rest = _drop(_cod_mct(cs, 0), *drop)
    at = next(i for i, m in enumerate(ms) if m[0] == after) + 1
    return join(ms[:at] + list(extra) + ms[at:], rest)


# ------------------------------------------------ the encoder's own files


@pytest.mark.parametrize("offsets", [(0, 0, 0), (128, 128, 128),
                                     (10, -20, 300), (-128, 5, 60)])
@pytest.mark.parametrize("cod", [2, 0, 1])
def test_openjpeg_encoder_files_match_cv2(cv2, tmp_path, cod, offsets):
    # as written (COD's MCT byte 2: OpenJPEG refuses it, "Invalid multiple
    # component transformation"), then with the byte 0 or 1: the MCC's
    # offsets are the components' DC level shifts
    data = _cod_mct(_opj(offsets), cod)
    assert same_as_cv2(cv2, tmp_path / "p2.j2k", data) == (cod != 2)


@pytest.mark.parametrize("matrix", ["swap", "scale", "mix"])
def test_a_custom_matrix_is_not_applied(cv2, tmp_path, matrix):
    # COD's MCT byte 0 or 1 never selects the array transform: the
    # decorrelation array is read and checked, then unused
    # (libopenjp2's encoder asserts on an entry of 2: its fixed point)
    m = {"swap": np.eye(3)[[2, 0, 1]], "scale": np.diag([0.5, 1.0, 0.75]),
         "mix": np.array([[.299, .587, .114], [-.169, -.331, .5],
                          [.5, -.419, -.081]])}[matrix]
    for cod in (0, 1):
        assert same_as_cv2(cv2, tmp_path / f"{matrix}{cod}.j2k",
                           _cod_mct(_opj((40, 0, -9), m), cod))


def test_jp2_file_with_part2_markers(cv2, tmp_path):
    data = fx.openjpeg_encode(_planes(2), jp2=True,
                              mct_array=(np.eye(3), (3, 2, 1)))
    assert not same_as_cv2(cv2, tmp_path / "p2.jp2", data)
    at = data.find(b"\xff\x52")
    fixed = data[:at + 8] + b"\x00" + data[at + 9:]
    assert same_as_cv2(cv2, tmp_path / "p2_fixed.jp2", fixed)


# -------------------------------------------------------- hand edits

_OFF = (30, -40, 7)
_VALS = {"i16": (30, 0xFFD8, 7), "i32": _OFF, "f32": (30.75, -40.5, 7.999),
         "f64": (30.5, -40.25, 7.75)}


def _cases():
    """name → the bytes of a hand-edited file."""
    base = _opj(_OFF)
    deco = mct(1, 1, np.eye(3).ravel().tolist(), "f32")
    off = mct(2, 2, _OFF)
    ok = [deco, off, mcc(3, 1, 2), mco(3)]
    out = {"reference": _with(base, *ok)}
    for el, vals in _VALS.items():
        out[f"offsets_{el}"] = _with(base, deco, mct(2, 2, vals, el),
                                     mcc(3, 1, 2), mco(3))
    out["offsets_f32_huge"] = _with(base, mct(2, 2, (3e9, -3e9, 1e3), "f32"),
                                    mcc(3, 0, 2), mco(3))
    out["offsets_f64_nan"] = _with(base, mct(2, 2, (float("nan"), 1.0,
                                                    -7.0), "f64"),
                                   mcc(3, 0, 2), mco(3))
    out["offset_only"] = _with(base, off, mcc(3, 0, 2), mco(3))
    out["deco_only"] = _with(base, deco, mcc(3, 1, 0), mco(3))
    out["no_mco"] = _with(base, *ok[:3])
    out["mco_no_stage"] = _with(base, *ok[:3], mco())
    out["mco_two_stages"] = _with(base, *ok[:3], mco(3, 3))
    out["mco_short"] = _with(base, *ok[:3], seg(0xFF77, b""))
    out["mco_long"] = _with(base, *ok[:3], seg(0xFF77, b"\x01\x03\x00"))
    out["mco_unknown_index"] = _with(base, *ok[:3], mco(9))
    out["mco_before_mcc"] = _with(base, deco, off, mco(3), mcc(3, 1, 2))
    out["mcc_second_record"] = _with(base, deco, off, mcc(4, 0, 0),
                                     mcc(3, 1, 2), mco(3))
    out["mcc_first_record"] = _with(base, deco, off, mcc(3, 1, 2),
                                    mcc(4, 0, 0), mco(3))
    out["mcc_redefined"] = _with(base, deco, off, mcc(3, 0, 0),
                                 mcc(3, 1, 2), mco(3))
    out["mcc_zmcc"] = _with(base, deco, off, mcc(3, 1, 2, zmcc=1), mco(3))
    out["mcc_ymcc"] = _with(base, deco, off, mcc(3, 1, 2, ymcc=1), mco(3))
    out["mcc_two_collections"] = _with(base, deco, off, mcc(3, 1, 2, coll=2),
                                       mco(3))
    out["mcc_no_collection"] = _with(base, deco, off, mcc(3, 1, 2, coll=0),
                                     mco(3))
    out["mcc_other_type"] = _with(base, deco, off, mcc(3, 1, 2, xmcc=3),
                                  mco(3))
    out["mcc_shuffled"] = _with(base, deco, off,
                                mcc(3, 1, 2, comps=[0, 2, 1]), mco(3))
    out["mcc_outputs_shuffled"] = _with(base, deco, off,
                                        mcc(3, 1, 2, outs=[1, 0, 2]), mco(3))
    out["mcc_fewer_outputs"] = _with(base, deco, off,
                                     mcc(3, 1, 2, outs=[0, 1]), mco(3))
    out["mcc_two_components"] = _with(base, mct(1, 1, [1, 0, 0, 1], "f32"),
                                      mct(2, 2, _OFF[:2]),
                                      mcc(3, 1, 2, n=2), mco(3))
    out["mcc_wide_indices"] = _with(base, deco, off, mcc(3, 1, 2, wide=True),
                                    mco(3))
    out["mcc_reversible"] = _with(base, deco, off,
                                  mcc(3, 1, 2, reversible=True), mco(3))
    out["mcc_missing_mct"] = _with(base, deco, mcc(3, 1, 5), mco(3))
    out["mcc_trailing_byte"] = _with(base, deco, off, [0xFF75, mcc(
        3, 1, 2)[1] + b"\0"], mco(3))
    out["mcc_short"] = _with(base, deco, off, seg(0xFF75, b"\0\0\3\0\0\0"),
                             mco(3))
    out["mcc_cut"] = _with(base, deco, off, [0xFF75, mcc(3, 1, 2)[1][:-4]],
                           mco(3))
    out["mct_zmct"] = _with(base, deco, mct(2, 2, _OFF, zmct=1),
                            mcc(3, 1, 2), mco(3))
    out["mct_ymct"] = _with(base, deco, mct(2, 2, _OFF, ymct=1),
                            mcc(3, 1, 2), mco(3))
    out["mct_short"] = _with(base, deco, seg(0xFF74, b"\0\0\x0a\x02\0\0"),
                             mcc(3, 1, 2), mco(3))
    out["mct_replaced"] = _with(base, deco, mct(2, 2, (1, 2, 3)), off,
                                mcc(3, 1, 2), mco(3))
    out["mct_replaced_after_mcc"] = _with(base, deco, off, mcc(3, 1, 2),
                                          mct(2, 2, (90, 80, 70)), mco(3))
    out["mct_offsets_too_few"] = _with(base, deco, mct(2, 2, _OFF[:2]),
                                       mcc(3, 1, 2), mco(3))
    out["mct_matrix_too_small"] = _with(base, mct(1, 1, [1.0] * 4, "f32"),
                                        off, mcc(3, 1, 2), mco(3))
    out["mct_array_type_3"] = _with(base, deco, mct(2, 3, _OFF),
                                    mcc(3, 1, 2), mco(3))
    out["cbd_as_siz"] = _with(base, cbd([7, 7, 7]), *ok)
    out["cbd_prec_10"] = _with(base, cbd([9, 9, 9]), *ok)
    out["cbd_prec_6"] = _with(base, cbd([5, 7, 7]), *ok)
    out["cbd_signed"] = _with(base, cbd([0x87, 7, 7]), *ok)
    out["cbd_prec_32"] = _with(base, cbd([31, 7, 7]), *ok)
    out["cbd_count"] = _with(base, cbd([7, 7, 7], count=2), *ok)
    out["cbd_length"] = _with(base, cbd([7, 7, 7, 7], count=3), *ok)
    out["cbd_after_cod"] = _with(base, *ok, cbd([9, 7, 9]), after=0xFF52)
    # markers in the tile-part header
    ms, rest = _drop(_cod_mct(base, 0), 0xFF74, 0xFF75, 0xFF77, 0xFF78)
    tph = b"".join(struct.pack(">HH", c, len(b) + 2) + bytes(b)
                   for c, b in ok)
    psot = struct.unpack(">I", rest[6:10])[0] + len(tph)
    out["tile_header"] = join(ms, rest[:6] + struct.pack(">I", psot)
                              + rest[10:12] + tph + rest[12:])
    tph_cbd = struct.pack(">HH", 0xFF78, 5) + bytes([0, 3, 7, 7, 7])
    psot = struct.unpack(">I", rest[6:10])[0] + len(tph_cbd)
    out["cbd_tile_header"] = join(ms, rest[:6] + struct.pack(">I", psot)
                                  + rest[10:12] + tph_cbd + rest[12:])
    # Part 1's reversible codestream with an offset array: the DC shift
    # added in 32 bits
    p1 = fx.openjpeg_encode(_planes(4), numres=3)
    for name, vals in (("p1_offsets", (-100, 27, 3)),
                       ("p1_offsets_wrap", (0x7FFFFFF0, -0x7FFFFFF0,
                                            1 << 30))):
        out[name] = _with(p1, mct(2, 2, vals), mcc(1, 0, 2), mco(1),
                          after=0xFF5C)
    # an HT codestream with them
    hts = ht.ht_codestream(_planes(5), numres=3, passes=3, plane=1)
    out["ht_offsets"] = _with(hts, mct(7, 2, (64, 64, 64)), mcc(1, 0, 7),
                              mco(1))
    out["ht_cbd"] = _with(hts, cbd([8, 8, 8]))
    return out


_NAMES = ["reference", "offsets_i16", "offsets_i32", "offsets_f32",
          "offsets_f64", "offsets_f32_huge", "offsets_f64_nan",
          "offset_only", "deco_only", "no_mco", "mco_no_stage",
          "mco_two_stages", "mco_short", "mco_long", "mco_unknown_index",
          "mco_before_mcc", "mcc_second_record", "mcc_first_record",
          "mcc_redefined", "mcc_zmcc", "mcc_ymcc", "mcc_two_collections",
          "mcc_no_collection", "mcc_other_type", "mcc_shuffled",
          "mcc_outputs_shuffled", "mcc_fewer_outputs", "mcc_two_components",
          "mcc_wide_indices", "mcc_reversible", "mcc_missing_mct",
          "mcc_trailing_byte", "mcc_short", "mcc_cut", "mct_zmct",
          "mct_ymct", "mct_short", "mct_replaced", "mct_replaced_after_mcc",
          "mct_offsets_too_few", "mct_matrix_too_small", "mct_array_type_3",
          "cbd_as_siz", "cbd_prec_10", "cbd_prec_6", "cbd_signed",
          "cbd_prec_32", "cbd_count", "cbd_length", "cbd_after_cod",
          "tile_header", "cbd_tile_header", "p1_offsets", "p1_offsets_wrap",
          "ht_offsets", "ht_cbd"]


@pytest.fixture(scope="module")
def cases():
    return _cases()


def test_the_case_list_is_whole(cases):
    assert sorted(cases) == sorted(_NAMES)


@pytest.mark.parametrize("name", _NAMES)
def test_hand_edited_markers_match_cv2(cv2, tmp_path, cases, name):
    same_as_cv2(cv2, tmp_path / f"{name}.j2k", cases[name])
