"""The port's JPEG 2000 reader and writer (``utils/image_io.read_jpeg2000``,
``write_jpeg2000``; the codestream codec of ``csrc/jpeg2000_codec.cpp``)
against cv2 5.0.0 (OpenJPEG 2.5.3), the JAX package's reader: every decode
bit for bit ``cv2.imread(path)[..., ::-1]``, or both refuse (cv2 returns
None or raises; the port raises naming the file); the writer's bytes those
of ``cv2.imwrite(name.jp2, bgr, [IMWRITE_JPEG2000_COMPRESSION_X1000, x])``
at x = 1000 (lossless), at cv2's default 250 and at other rates (OpenJPEG
2.5.3's rate allocation).  The files come from PIL (its bundled OpenJPEG
2.5.4), cv2, the system libopenjp2's encoder through ctypes and the JP2 box
writers of ``tests/torch_make_image_fixtures.py``, cut short and
corrupted.  The
committed fixtures are checked without cv2 in
``tests/test_torch_image_formats.py``.

The cv2 tests take cv2 with ``pytest.importorskip`` inside a fixture.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_image, write_jpeg2000

import torch_j2k_ht as ht
import torch_make_image_fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 29, 38


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _cv2_read(cv2, path):
    try:
        return cv2.imread(str(path))
    except cv2.error:              # cv2's image size check raises
        return None


def _same_as_cv2(cv2, path, data=None):
    """The port's decode against cv2's: equal bit for bit, or cv2 refuses
    and the port raises naming the file.  → whether cv2 read it."""
    if data is not None:
        path.write_bytes(data)
    want = _cv2_read(cv2, path)
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


def _image(h=H, w=W, seed=0):
    return fx.fixture_image(h, w, seed=seed)


# ----------------------------------------------------------- PIL's files


_PIL = {
    "default": {},
    "irreversible": dict(irreversible=True),
    "lrcp_3_layers": dict(quality_layers=[40, 20, 10]),
    "rlcp_2_layers": dict(progression="RLCP", quality_layers=[30, 10]),
    "rpcl_precincts": dict(progression="RPCL", precinct_size=(16, 16),
                           num_resolutions=4),
    "pcrl_97": dict(progression="PCRL", precinct_size=(32, 32),
                    quality_layers=[20, 5], irreversible=True),
    "cprl_97": dict(progression="CPRL", irreversible=True,
                    quality_layers=[25]),
    "tiles_16": dict(tile_size=(16, 16)),
    "tiles_odd_97": dict(tile_size=(13, 21), irreversible=True),
    "tiles_odd_rpcl": dict(tile_size=(11, 17), progression="RPCL",
                           quality_layers=[30, 12]),
    "cblk_16x16": dict(codeblock_size=(16, 16)),
    "cblk_4x32_97": dict(codeblock_size=(4, 32), irreversible=True),
    "cblk_64x4": dict(codeblock_size=(64, 4), quality_layers=[15]),
    "res_1": dict(num_resolutions=1),
    "res_2_97": dict(num_resolutions=2, irreversible=True),
    "res_3_precincts": dict(num_resolutions=3, precinct_size=(8, 8)),
    "mct_0": dict(mct=0),
    "mct_1": dict(mct=1, quality_layers=[20]),
    "mct_1_97": dict(mct=1, irreversible=True),
    "plt": dict(plt=True, quality_layers=[30, 10]),
    "raw_codestream": dict(no_jp2=True),
    "raw_codestream_97": dict(no_jp2=True, irreversible=True,
                              progression="RPCL"),
}


@pytest.mark.parametrize("kind", list(_PIL))
def test_pil_files_match_cv2(cv2, tmp_path, kind):
    data = fx.pil_jpeg2000(_image(seed=1), **_PIL[kind])
    assert _same_as_cv2(cv2, tmp_path / "v.jp2", data)


@pytest.mark.parametrize("size,kw", [
    ((1, 1), {}), ((1, 37), {}), ((41, 1), {}), ((2, 3), {}),
    ((97, 1297), {}), ((97, 1297), dict(irreversible=True,
                                        quality_layers=[30, 10])),
    ((64, 129), dict(num_resolutions=6, tile_size=(40, 50))),
    ((33, 65), dict(num_resolutions=6, irreversible=True))],
    ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple)
    else ("97" if v.get("irreversible") else "53"))
def test_pil_sizes_match_cv2(cv2, tmp_path, size, kw):
    data = fx.pil_jpeg2000(_image(*size, seed=2), **kw)
    assert _same_as_cv2(cv2, tmp_path / "v.jp2", data)


@pytest.mark.parametrize("mode", ["L", "RGBA", "LA", "I;16", "L_j2k"])
def test_pil_modes_match_cv2(cv2, tmp_path, mode):
    # gray: the one channel in all three; RGBA: alpha dropped; 16 bits: the
    # top 8; a raw gray codestream: sRGB assumed, refused
    rng = np.random.default_rng(3)
    img = _image(seed=3)
    arrays = {"L": img[..., 0], "RGBA": np.dstack([img, img[..., :1]]),
              "LA": img[..., :2].copy(), "L_j2k": img[..., 0],
              "I;16": rng.integers(0, 65536, (H, W)).astype(np.uint16)}
    data = fx.pil_jpeg2000(arrays[mode], no_jp2=mode == "L_j2k")
    assert _same_as_cv2(cv2, tmp_path / "v.jp2", data) == (mode != "L_j2k")


# ------------------------------------------------------------ cv2's files


@pytest.mark.parametrize("x1000", [1000, 500, 250, 100, 50, 10, 1])
def test_cv2_files_match_cv2(cv2, tmp_path, x1000):
    # 250 is cv2's default (rate 4): OpenJPEG's rate allocation cuts passes
    path = tmp_path / "v.jp2"
    img = _image(45, 61, seed=4)
    assert cv2.imwrite(str(path), np.ascontiguousarray(img[..., ::-1]),
                       [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    assert _same_as_cv2(cv2, path)


# --------------------------------------------- libopenjp2's encoder kinds


_OPJ = {
    "bypass": dict(mode=1, layers=[20, 8]),
    "reset": dict(mode=2, layers=[20, 8]),
    "termall": dict(mode=4, layers=[20, 8]),
    "vsc": dict(mode=8),
    "pterm": dict(mode=16, layers=[12]),
    "segsym": dict(mode=32),
    "all_styles": dict(mode=63, layers=[30, 10, 1]),
    "all_styles_97": dict(mode=63, irreversible=True, layers=[20, 8]),
    "bypass_vsc_97": dict(mode=1 | 8, irreversible=True, layers=[10]),
    "roi": dict(roi=(0, 5)),
    "roi_97": dict(roi=(1, 9), irreversible=True, layers=[20, 5]),
    "poc": dict(layers=[20, 10], numres=3, pocs=[
        (0, 0, 2, 2, 3, "RPCL"), (0, 0, 2, 3, 3, "LRCP")]),
    "poc_three": dict(layers=[20, 10, 5], pocs=[
        (0, 0, 2, 5, 2, "CPRL"), (0, 2, 3, 5, 3, "RLCP"),
        (0, 0, 3, 5, 3, "PCRL")]),
    "tile_parts_r": dict(tile=(16, 16), tile_parts="R", layers=[20, 8]),
    "tile_parts_l": dict(tile=(16, 16), tile_parts="L", layers=[20, 8]),
    "tile_parts_c": dict(tile=(16, 16), tile_parts="C"),
    "tlm": dict(tile=(16, 16), extra=["TLM=YES"]),
    "plt": dict(extra=["PLT=YES"], layers=[20, 8]),
    "sop_eph": dict(csty=2 | 4, layers=[20, 8], prog="PCRL"),
    "cblk_4x64_vsc": dict(cblk=(4, 64), mode=8),
    "cblk_64x16_precincts": dict(cblk=(64, 16), precincts=[
        (32, 32), (16, 16), (8, 8)]),
    "mct_off": dict(mct=0),
}


@pytest.mark.parametrize("kind", list(_OPJ))
def test_openjpeg_encoder_kinds_match_cv2(cv2, tmp_path, kind):
    img = _image(53, 71, seed=5)
    data = fx.openjpeg_encode([img[..., k] for k in range(3)], **_OPJ[kind])
    assert _same_as_cv2(cv2, tmp_path / "v.j2k", data)


_PACKED = {"one_tile": dict(csty=6, layers=[20, 8]),
           "tiles": dict(csty=6, tile=(16, 16), layers=[20, 8]),
           "tile_parts": dict(csty=6, tile=(32, 32), tile_parts="R",
                              layers=[20, 8]),
           "rpcl_97": dict(csty=6, irreversible=True, layers=[30, 10],
                           prog="RPCL")}


@pytest.mark.parametrize("where", ["ppt", "ppm"])
@pytest.mark.parametrize("kind", list(_PACKED))
def test_packed_packet_headers_match_cv2(cv2, tmp_path, kind, where):
    # the packet headers of a SOP/EPH codestream moved into PPT or PPM
    # markers, whole and cut into many markers (Zppt / Zppm in order)
    img = _image(53, 71, seed=5)
    cs = fx.openjpeg_encode([img[..., k] for k in range(3)], **_PACKED[kind])
    for chunk in (65000, 61):
        assert _same_as_cv2(cv2, tmp_path / f"{chunk}.j2k",
                            fx.packed_headers(cs, where, chunk))
    np.testing.assert_array_equal(read_image(str(tmp_path / "61.j2k")),
                                  cv2.imread(str(tmp_path / "61.j2k"))[
                                      ..., ::-1])


@pytest.mark.parametrize("prec", range(1, 17))
def test_precisions_match_cv2(cv2, tmp_path, prec):
    # under 8 bits cv2 refuses; past 8 it keeps the top 8 (of the largest
    # precision, for every component); gray JP2 and sYCC alike
    rng = np.random.default_rng(prec)
    planes = [rng.integers(0, 1 << prec, (9, 11)) for _ in range(3)]
    for numcomps, colr in ((3, 16), (1, 17), (3, 18)):
        cs = fx.openjpeg_encode(planes[:numcomps], prec=prec, numres=2)
        read = _same_as_cv2(cv2, tmp_path / f"p{colr}.jp2",
                            fx.jp2_file(cs, numcomps, 9, 11, colr=colr))
        assert read == (prec >= 8)


def test_mixed_precisions_match_cv2(cv2, tmp_path):
    rng = np.random.default_rng(8)
    for precs in ((8, 12, 8), (12, 8, 8), (16, 9, 10), (7, 8, 8)):
        planes = [rng.integers(0, 1 << p, (9, 11)) for p in precs]
        cs = fx.openjpeg_encode(planes, prec=list(precs), numres=2)
        _same_as_cv2(cv2, tmp_path / "p.jp2",
                     fx.jp2_file(cs, 3, 9, 11, bpc=255))


# ---------------------------------------------------------------- JP2 boxes


def _boxes():
    """name -> a JP2 file: palettes, channel definitions, colour spaces,
    box placement."""
    rng = np.random.default_rng(9)
    h, w = 9, 11
    p3 = [rng.integers(0, 256, (h, w)) for _ in range(4)]
    cs3, cs4 = fx.openjpeg_encode(p3[:3], numres=2), \
        fx.openjpeg_encode(p3, numres=2)
    idx = rng.integers(0, 20, (h, w))
    ci = fx.openjpeg_encode([idx], numres=2)
    ci2 = fx.openjpeg_encode([idx, p3[0]], numres=2)
    ent = rng.integers(0, 256, (20, 3))
    ent16 = rng.integers(0, 65536, (20, 3))
    cmap3 = fx.jp2_cmap([(0, 1, k) for k in range(3)])
    jf, box = fx.jp2_file, fx.jp2_box
    out = {
        "pclr": jf(ci, 1, h, w, extra=fx.jp2_pclr(ent, [8] * 3) + cmap3),
        "pclr_gray": jf(ci, 1, h, w, colr=17,
                        extra=fx.jp2_pclr(ent, [8] * 3) + cmap3),
        "pclr_no_cmap": jf(ci, 1, h, w, extra=fx.jp2_pclr(ent, [8] * 3)),
        "pclr_short_table": jf(ci, 1, h, w, extra=fx.jp2_pclr(
            ent[:10], [8] * 3) + cmap3),
        "pclr_16_bit": jf(ci, 1, h, w, extra=fx.jp2_pclr(ent16, [16] * 3)
                          + cmap3),
        "pclr_12_bit": jf(ci, 1, h, w, extra=fx.jp2_pclr(ent16 % 4096,
                                                         [12] * 3) + cmap3),
        "pclr_direct_first": jf(ci, 1, h, w, extra=fx.jp2_pclr(
            ent, [8] * 3) + fx.jp2_cmap([(0, 0, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_bad_cmap": jf(ci, 1, h, w, extra=fx.jp2_pclr(ent, [8] * 3)
                            + fx.jp2_cmap([(0, 1, 1), (0, 1, 1), (0, 1, 2)])),
        "pclr_cmap_past_comps": jf(ci, 1, h, w, extra=fx.jp2_pclr(
            ent, [8] * 3) + fx.jp2_cmap([(1, 1, 0), (0, 1, 1), (0, 1, 2)])),
        "pclr_two_comps": jf(ci2, 2, h, w, extra=fx.jp2_pclr(
            np.concatenate([ent, ent[:, :1]], 1), [8] * 4) + fx.jp2_cmap(
            [(0, 1, 0), (0, 1, 1), (0, 1, 2), (1, 0, 0)])),
        "pclr_index_4_bit": jf(fx.openjpeg_encode([idx % 16], numres=2,
                                                  prec=4), 1, h, w,
                               extra=fx.jp2_pclr(ent, [8] * 3) + cmap3),
        "cdef_alpha_last": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)])),
        "cdef_alpha_first": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)])),
        "cdef_swap": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)])),
        "cdef_rgb_order": jf(cs3, 3, h, w, extra=fx.jp2_cdef(
            [(0, 0, 2), (1, 0, 3), (2, 0, 1)])),
        "cdef_incomplete": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3)])),
        "cdef_past_comps": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3), (4, 1, 0)])),
        "cdef_premultiplied": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)])),
        "cdef_unassociated": jf(cs4, 4, h, w, extra=fx.jp2_cdef(
            [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 65535, 65535)])),
        "no_jp2h": box(b"jP  ", b"\r\n\x87\n") + box(
            b"ftyp", b"jp2 \0\0\0\0jp2 ") + box(b"jp2c", cs3),
        "ihdr_size_differs": jf(cs3, 3, h + 1, w),
        "ihdr_comps_differ": jf(cs3, 4, h, w),
        "colr_after_jp2h": jf(cs3, 3, h, w, colr=None, after=box(
            b"colr", b"\x01\0\0\0\0\0\x11")),
        "colr_before_jp2h": jf(cs3, 3, h, w, colr=None, before=box(
            b"colr", b"\x01\0\0\0\0\0\x11")),
        "unknown_boxes": jf(cs3, 3, h, w, before=box(b"xml ", b"<a/>"),
                            after=box(b"uuid", bytes(20))),
        "two_colr": jf(cs3, 3, h, w, extra=box(b"colr",
                                               b"\x01\0\0\0\0\0\x11")),
        "icc": jf(cs3, 3, h, w, colr=None, extra=box(b"colr",
                                                     b"\x02\0\0ICCPROF")),
        "colr_meth_3": jf(cs3, 3, h, w, colr=None, extra=box(
            b"colr", b"\x03\0\0\0\0\0\x11")),
        "bpcc": jf(cs3, 3, h, w, bpc=255, extra=box(b"bpcc", b"\x07" * 3)),
        "bpcc_short": jf(cs3, 3, h, w, bpc=255, extra=box(b"bpcc",
                                                          b"\x07" * 2)),
        "res_box": jf(cs3, 3, h, w, extra=box(b"res ", box(b"resc",
                                                           bytes(10)))),
        "ftyp_odd": jf(cs3, 3, h, w, ftyp=b"jp2 \0\0\0\0jp2"),
        "box_after_codestream": jf(cs3, 3, h, w) + box(b"free", b"xx"),
        "bytes_after_codestream": jf(cs3, 3, h, w) + b"abc",
    }
    for colr in (16, 17, 18, 12, 24, 0, 14, 3):
        for n in (1, 2, 3, 4):
            cs = cs3 if n == 3 else (cs4 if n == 4 else
                                     fx.openjpeg_encode(p3[:n], numres=2))
            out[f"colr_{colr}_{n}_comps"] = jf(cs, n, h, w, colr=colr)
    out["no_colr"] = jf(cs3, 3, h, w, colr=None)
    return out


# the keys of _boxes()
_BOXES = ["box_after_codestream", "bpcc", "bpcc_short",
    "bytes_after_codestream", "cdef_alpha_first", "cdef_alpha_last",
    "cdef_incomplete", "cdef_past_comps", "cdef_premultiplied",
    "cdef_rgb_order", "cdef_swap", "cdef_unassociated", "colr_0_1_comps",
    "colr_0_2_comps", "colr_0_3_comps", "colr_0_4_comps", "colr_12_1_comps",
    "colr_12_2_comps", "colr_12_3_comps", "colr_12_4_comps",
    "colr_14_1_comps", "colr_14_2_comps", "colr_14_3_comps",
    "colr_14_4_comps", "colr_16_1_comps", "colr_16_2_comps",
    "colr_16_3_comps", "colr_16_4_comps", "colr_17_1_comps",
    "colr_17_2_comps", "colr_17_3_comps", "colr_17_4_comps",
    "colr_18_1_comps", "colr_18_2_comps", "colr_18_3_comps",
    "colr_18_4_comps", "colr_24_1_comps", "colr_24_2_comps",
    "colr_24_3_comps", "colr_24_4_comps", "colr_3_1_comps", "colr_3_2_comps",
    "colr_3_3_comps", "colr_3_4_comps", "colr_after_jp2h", "colr_before_jp2h",
    "colr_meth_3", "ftyp_odd", "icc", "ihdr_comps_differ",
    "ihdr_size_differs", "no_colr", "no_jp2h", "pclr", "pclr_12_bit",
    "pclr_16_bit", "pclr_bad_cmap", "pclr_cmap_past_comps",
    "pclr_direct_first", "pclr_gray", "pclr_index_4_bit", "pclr_no_cmap",
    "pclr_short_table", "pclr_two_comps", "res_box", "two_colr",
    "unknown_boxes"]


@pytest.fixture(scope="module")
def boxes():
    return _boxes()


@pytest.mark.parametrize("kind", _BOXES)
def test_jp2_boxes_match_cv2(cv2, tmp_path, boxes, kind):
    _same_as_cv2(cv2, tmp_path / "v.jp2", boxes[kind])


# ------------------------------------------------------ what cv2 refuses


def _refused():
    img = _image(seed=11)
    planes = [img[..., k] for k in range(3)]
    jp2 = fx.pil_jpeg2000(img)
    j2k = fx.pil_jpeg2000(img, no_jp2=True)
    out = {
        "raw_gray": fx.openjpeg_encode(planes[:1]),
        "signed": fx.openjpeg_encode([v.astype(int) - 128 for v in planes],
                                     sgnd=1),
        "one_signed": fx.openjpeg_encode(
            [planes[0], planes[1].astype(int) - 128, planes[2]],
            sgnd=[0, 1, 0]),
        "offset": fx.openjpeg_encode(planes, offset=(3, 5)),
        "offset_y": fx.pil_jpeg2000(img, offset=(0, 2), tile_size=(38, 31)),
        "five_comps": fx.openjpeg_encode(planes + planes[:2]),
        "subsampled": fx.openjpeg_encode(
            [planes[0], planes[1][::2, ::2], planes[2][::2, ::2]],
            dx=[1, 2, 2], dy=[1, 2, 2]),
        "prec_4": fx.openjpeg_encode([v >> 4 for v in planes], prec=4),
        "no_eoc": jp2[:-2],
        "cut_in_eoc": jp2[:-1],
    }
    for pct in (10, 30, 60, 90):
        out[f"jp2_cut_{pct}"] = jp2[:len(jp2) * pct // 100]
    for pct in (50, 90):
        out[f"j2k_cut_{pct}"] = j2k[:len(j2k) * pct // 100]
    return out


# the keys of _refused()
_REFUSED = ["cut_in_eoc", "five_comps", "j2k_cut_50", "j2k_cut_90",
    "jp2_cut_10", "jp2_cut_30", "jp2_cut_60", "jp2_cut_90", "no_eoc",
    "offset", "offset_y", "one_signed", "prec_4", "raw_gray", "signed",
    "subsampled"]


@pytest.fixture(scope="module")
def refused():
    return _refused()


@pytest.mark.parametrize("kind", _REFUSED)
def test_refused_files_raise_naming_the_file(cv2, tmp_path, refused, kind):
    assert not _same_as_cv2(cv2, tmp_path / f"{kind}.jp2", refused[kind])


# ---------------------------------------------- byte flips and cuts


def _fuzz_bases():
    import cv2 as cv

    img = _image(40, 52, seed=12)
    bgr = np.ascontiguousarray(img[..., ::-1])
    planes = [img[..., k] for k in range(3)]
    x1000 = cv.IMWRITE_JPEG2000_COMPRESSION_X1000
    return [
        cv.imencode(".jp2", bgr, [x1000, 1000])[1].tobytes(),
        cv.imencode(".jp2", bgr, [x1000, 80])[1].tobytes(),
        fx.pil_jpeg2000(img, irreversible=True, quality_layers=[30, 10],
                        progression="RPCL", tile_size=(24, 24),
                        precinct_size=(16, 16), plt=True,
                        codeblock_size=(8, 8)),
        fx.pil_jpeg2000(img, no_jp2=True, progression="CPRL",
                        num_resolutions=3, mct=1),
        fx.openjpeg_encode(planes, mode=63, layers=[20, 5], numres=3,
                           csty=6, tile=(32, 32), tile_parts="R"),
        fx.openjpeg_encode(planes, layers=[20, 10], numres=3,
                           extra=["TLM=YES"], roi=(0, 4), pocs=[
                               (0, 0, 2, 3, 3, "RPCL"),
                               (0, 0, 2, 6, 3, "LRCP")]),
        # HT code-blocks (tests/torch_j2k_ht.py): the cleanup pass with
        # SigProp and MagRef, 5/3 and layers; a JPH file of tiles; 9/7
        ht.ht_codestream(planes, numres=3, passes=3, plane=1, layers=2,
                         layer_of=lambda *k: sum(k) % 2, fallback=False),
        ht.jph_file(ht.ht_codestream(planes, numres=2, cblk=(3, 4),
                                     tiles=(24, 24), passes=2, plane=2,
                                     fallback=False), 3, 40, 52),
        ht.ht_codestream(coeffs=[[(np.asarray(p, np.int64) - 128) * 5
                                  for p in planes]], size=(40, 52),
                         numres=1, reversible=False, expn=12, passes=3,
                         plane=2)]


@pytest.mark.parametrize("chunk", range(4))
def test_byte_flips_and_cuts_match_cv2(cv2, tmp_path, chunk):
    # 4 x 80 seeded mutations (1-3 random bytes, one flipped bit, a cut)
    # of nine files, three of HT code-blocks: equal, or both refuse (a
    # byte that makes a code-block HT is read as cv2 reads it).  Bytes are
    # not flipped in SIZ's image and tile sizes,
    # where a flip asks for a canvas of gigabytes (both then refuse or
    # decode zeros, slowly)
    bases = _fuzz_bases()
    rng = np.random.default_rng(100 + chunk)
    for i in range(80):
        data = bytearray(bases[int(rng.integers(len(bases)))])
        siz = data.find(b"\xff\x51")
        sizes = range(siz + 6, siz + 38)
        kind = int(rng.integers(3))
        if kind == 2:
            data = data[:int(rng.integers(1, len(data)))]
        else:
            for _ in range(int(rng.integers(1, 4)) if kind == 0 else 1):
                pos = int(rng.integers(len(data)))
                while pos in sizes:
                    pos = int(rng.integers(len(data)))
                if kind == 0:
                    data[pos] = int(rng.integers(256))
                else:
                    data[pos] ^= 1 << int(rng.integers(8))
        _same_as_cv2(cv2, tmp_path / f"f{i}.jp2", bytes(data))


# ------------------------------------------------------------ the writer


@pytest.mark.parametrize("size", [(32, 32), (33, 47), (45, 61), (64, 64),
                                  (129, 40), (97, 1297)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_writer_matches_cv2_bytes(cv2, tmp_path, size):
    img = _image(*size, seed=13)
    noisy = np.random.default_rng(size[1]).integers(0, 256, img.shape,
                                                    np.uint8)
    for name, src in (("smooth", img), ("noise", noisy)):
        cv_path, port_path = tmp_path / f"cv2_{name}.jp2", \
            tmp_path / f"port_{name}.jp2"
        assert cv2.imwrite(str(cv_path), np.ascontiguousarray(src[..., ::-1]),
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
        write_jpeg2000(str(port_path), src)
        assert port_path.read_bytes() == cv_path.read_bytes(), name
        np.testing.assert_array_equal(read_image(str(port_path)), src)


@pytest.mark.parametrize("size", [(31, 40), (40, 31), (1, 1)])
def test_writer_refuses_what_cv2_does_not_write(cv2, tmp_path, size):
    # OpenJPEG refuses 6 resolutions on a side under 32: imwrite fails
    img = _image(*size, seed=14)
    assert not cv2.imwrite(str(tmp_path / "cv2.jp2"), img,
                           [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000])
    with pytest.raises(ValueError, match="port.jp2"):
        write_jpeg2000(str(tmp_path / "port.jp2"), img)


def _garden(h, w):
    """A crop of the committed 1297x840 garden view (natural content)."""
    view = read_image(os.path.join(fx.FOLDER, fx.TIMING))
    return np.ascontiguousarray(view[300:300 + h, 500:500 + w])


_RATE_SIZES = [(32, 32), (33, 47), (45, 61), (97, 130)]
_RATE_IMAGES = {
    "noise": lambda h, w: np.random.default_rng(h * w).integers(
        0, 256, (h, w, 3), np.uint8),
    "smooth": lambda h, w: _image(h, w, seed=18),
    "garden": _garden,
}


@pytest.mark.parametrize("size", _RATE_SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(_RATE_IMAGES))
@pytest.mark.parametrize("x1000", [None, 250, 100, 500])
def test_writer_matches_cv2_bytes_at_rates(cv2, tmp_path, x1000, kind, size):
    # OpenJPEG 2.5.3's rate allocation (one layer at rate 1000 / x1000;
    # None: imwrite with no parameters, which is 250), byte for byte, and
    # each file read back as cv2 reads it
    img = _RATE_IMAGES[kind](*size)
    bgr = np.ascontiguousarray(img[..., ::-1])
    params = [] if x1000 is None else \
        [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000]
    cv_path, port_path = tmp_path / "cv2.jp2", tmp_path / "port.jp2"
    assert cv2.imwrite(str(cv_path), bgr, params)
    write_jpeg2000(str(port_path), img, 250 if x1000 is None else x1000)
    data = port_path.read_bytes()
    assert data == cv_path.read_bytes()
    np.testing.assert_array_equal(read_image(str(port_path)),
                                  cv2.imread(str(cv_path))[..., ::-1])
    if kind == "noise":
        # the budget binds: passes were cut, the file is shorter than the
        # lossless one
        write_jpeg2000(str(tmp_path / "lossless.jp2"), img)
        assert len(data) < (tmp_path / "lossless.jp2").stat().st_size


@pytest.mark.parametrize("case", [(51, 66, 11, 100), (62, 82, 22, 500),
                                  (73, 98, 33, 500)],
                         ids=lambda c: f"{c[0]}x{c[1]}_x{c[3]}")
def test_writer_follows_openjpeg_253_where_250_differs(cv2, tmp_path, case):
    # OpenJPEG 2.5.3 (cv2's) stops bisecting the threshold once it moves by
    # no more than 5e-6 of itself; 2.5.0 (the system library) bisects on
    # and keeps more passes on these images.  The port is 2.5.3.
    h, w, seed, x1000 = case
    img = _image(h, w, seed=seed)
    assert cv2.imwrite(str(tmp_path / "cv2.jp2"),
                       np.ascontiguousarray(img[..., ::-1]),
                       [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    write_jpeg2000(str(tmp_path / "port.jp2"), img, x1000)
    cv_data = (tmp_path / "cv2.jp2").read_bytes()
    assert (tmp_path / "port.jp2").read_bytes() == cv_data
    old = fx.openjpeg_encode([img[..., k] for k in range(3)], jp2=True,
                             layers=[1000 / x1000])
    assert len(old) > len(cv_data)


@pytest.mark.parametrize("x1000", [1, 0, -5, 1001, 5000])
def test_writer_clamps_the_rate_as_cv2_does(cv2, tmp_path, x1000):
    # cv2 clamps IMWRITE_JPEG2000_COMPRESSION_X1000 to 1-1000
    img = _image(40, 52, seed=19)
    assert cv2.imwrite(str(tmp_path / "cv2.jp2"),
                       np.ascontiguousarray(img[..., ::-1]),
                       [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000])
    write_jpeg2000(str(tmp_path / "port.jp2"), img, x1000)
    assert (tmp_path / "port.jp2").read_bytes() == \
        (tmp_path / "cv2.jp2").read_bytes()


def test_writer_writes_the_empty_packets_openjpeg_writes(cv2, tmp_path):
    # a flat image: every code-block of a resolution is all zeros, and
    # OpenJPEG still writes each packet's first bit as 1
    for value in (128, 0, 37):
        img = np.full((64, 64, 3), value, np.uint8)
        for x1000 in (1000, 250):
            assert cv2.imwrite(str(tmp_path / "cv2.jp2"), img,
                               [cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                x1000])
            write_jpeg2000(str(tmp_path / "port.jp2"), img, x1000)
            assert (tmp_path / "port.jp2").read_bytes() == \
                (tmp_path / "cv2.jp2").read_bytes(), (value, x1000)
            np.testing.assert_array_equal(
                read_image(str(tmp_path / "port.jp2")), img)


# -------------------------------------------------- dispatch, downsample


def test_read_image_goes_by_signature(tmp_path):
    img = _image(40, 41, seed=15)
    write_jpeg2000(str(tmp_path / "named.png"), img)
    np.testing.assert_array_equal(read_image(str(tmp_path / "named.png")),
                                  img)
    data = (tmp_path / "named.png").read_bytes()
    assert data[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n"
    # the raw codestream (FF 4F FF 51) under another name: sRGB assumed
    (tmp_path / "raw.jpg").write_bytes(data[data.find(b"jp2c") + 4:])
    np.testing.assert_array_equal(read_image(str(tmp_path / "raw.jpg")), img)


def test_downsample_writes_jp2_as_cv2_writes_it(tmp_path):
    # cv2.imwrite's default for a .jp2 name is rate 4 (X1000 250); a JP2
    # under 32 pixels a side is not written (imwrite returns False), and
    # the run carries on
    from gsplat_tpu_torch.downsample import downsample_area
    from gsplat_tpu_torch.utils.image_io import write_png

    src, dst = tmp_path / "src", tmp_path / "dst"
    src.mkdir()
    img = _image(70, 90, seed=16)
    write_jpeg2000(str(src / "a.jp2"), img)
    write_png(str(src / "b.jp2"), _image(40, 48, seed=17))
    write_png(str(src / "c.png"), img)
    proc = subprocess.run([sys.executable, "-m", "gsplat_tpu_torch.downsample",
                           "--src", str(src), "--dst", str(dst), "--factor",
                           "2"], cwd=REPO, capture_output=True, text=True,
                          check=True)
    assert sorted(os.listdir(dst)) == ["a.jp2", "c.png"]
    assert proc.stdout.split() == ["a.jp2", "c.png"]
    assert "not written b.jp2" in proc.stderr
    write_jpeg2000(str(tmp_path / "want.jp2"), downsample_area(img, 2), 250)
    assert (dst / "a.jp2").read_bytes() == (tmp_path / "want.jp2").read_bytes()


# ------------------------------------------ OpenJPEG 2.5.3's stream rules


def _rules():
    """name -> a codestream that exercises one of OpenJPEG 2.5.3's rules
    (ROADMAP §3) beside the file it was made from."""
    img = _image(40, 52, seed=17)
    planes = [img[..., k] for k in range(3)]
    sop_eph = fx.openjpeg_encode(planes, csty=6, layers=[20, 8], numres=3)
    tlm = fx.openjpeg_encode(planes, tile=(16, 16), extra=["TLM=YES"])
    tiles = fx.openjpeg_encode(planes, tile=(24, 24), layers=[20, 8])
    poc = fx.openjpeg_encode(planes, layers=[20, 10], numres=3, pocs=[
        (0, 0, 2, 2, 3, "RPCL"), (0, 0, 2, 3, 3, "LRCP")])
    plain = fx.openjpeg_encode(planes, layers=[20, 8], numres=3)

    def edit(data, pos, value):
        out = bytearray(data)
        out[pos] = value
        return bytes(out)
    sop = sop_eph.index(b"\xff\x91")
    eph = sop_eph.index(b"\xff\x92")
    t = tlm.index(b"\xff\x55")
    cod_poc, cod = poc.index(b"\xff\x52"), plain.index(b"\xff\x52")
    sots = [i for i in range(len(tiles) - 1) if tiles[i:i + 2] == b"\xff\x90"]
    return {
        "wrong_eph": edit(sop_eph, eph + 1, 0x93),
        "wrong_sop": edit(sop_eph, sop + 1, 0x90),
        "tlm_st3": edit(tlm, t + 5, 0x70),
        "unknown_progression": edit(plain, cod + 5, 5),
        "unknown_progression_poc": edit(poc, cod_poc + 5, 5),
        "eoc_garbled": plain[:-2] + b"\x12\x34",
        "no_eoc": plain[:-2],
        "cut_after_sot_marker": tiles[:sots[2] + 2],
        "missing_tiles_then_eoc": tiles[:sots[2]] + b"\xff\xd9",
        "tile_index_changed": edit(tiles, sots[1] + 5, 3),
    }


# the keys of _rules()
_RULES = ["cut_after_sot_marker", "eoc_garbled", "missing_tiles_then_eoc",
          "no_eoc", "tile_index_changed", "tlm_st3", "unknown_progression",
          "unknown_progression_poc", "wrong_eph", "wrong_sop"]


@pytest.fixture(scope="module")
def rules():
    return _rules()


@pytest.mark.parametrize("kind", _RULES)
def test_openjpeg_stream_rules_match_cv2(cv2, tmp_path, rules, kind):
    _same_as_cv2(cv2, tmp_path / f"{kind}.j2k", rules[kind])
