"""The port's TIFF reader on YCbCr (photometric 6, not JPEG-compressed) and
CIELab (photometric 8) against cv2 5.0.0 (libtiff 4.7.1's RGBA interface,
through which OpenCV reads 8-bit TIFF) bit for bit, or both refuse.

Pillow writes both kinds uncompressed, LZW, Deflate and PackBits, YCbCr
with subsampling 1, 1 (and ReferenceBlackWhite uncompressed); the
subsampled YCbCr strips libtiff reads (2, 1 up to 4, 4) are written here
(``torch_make_image_fixtures.ycbcr_subsampled_tiff``).  Each stage is also
held to libtiff's own functions by symbol in the system ``libtiff.so.6``:
``TIFFYCbCrToRGBInit``'s tables and ``TIFFYCbCrtoRGB`` for YCbCr,
``TIFFCIELabToRGBInit``, ``TIFFCIELabToXYZ`` and ``TIFFXYZToRGB`` for
CIELab.
"""

import ctypes
import io

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_image

import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def pil():
    return pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module")
def libtiff():
    try:
        return ctypes.CDLL("libtiff.so.6")
    except OSError:
        pytest.skip("no system libtiff.so.6")


def _same_as_cv2(cv2, path, data):
    """The port equals cv2 bit for bit, or both refuse (the port raising
    naming the file).  → whether cv2 read it."""
    path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises((ValueError, RuntimeError), match=path.name):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


def _pillow_tiff(pil, rgb, mode, **opts) -> bytes:
    buf = io.BytesIO()
    pil.fromarray(rgb).convert(mode).save(buf, "TIFF", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("comp", list(fx.TIFF_COMPRESSIONS))
@pytest.mark.parametrize("mode", ["YCbCr", "LAB"])
def test_pillow_files_read_as_cv2(cv2, pil, tmp_path, mode, comp):
    rgb = fx.fixture_image(61, 83, seed=41)
    data = _pillow_tiff(pil, rgb, mode,
                        compression=fx.TIFF_COMPRESSIONS[comp])
    assert _same_as_cv2(cv2, tmp_path / f"{mode}_{comp}.tif", data)


@pytest.mark.parametrize("mode", ["YCbCr", "LAB"])
def test_every_sample_reads_as_cv2(cv2, pil, tmp_path, mode):
    # a million random samples (of the 2^24 triples: a run of all of them,
    # four 2048x2048 files each, matched cv2 too) through Pillow's raw
    # bytes
    rng = np.random.default_rng(42)
    px = rng.integers(0, 256, (1024, 1024, 3)).astype(np.uint8)
    buf = io.BytesIO()
    pil.frombytes(mode, (1024, 1024), px.tobytes()).save(
        buf, "TIFF", compression="tiff_lzw")
    assert _same_as_cv2(cv2, tmp_path / f"all_{mode}.tif", buf.getvalue())


@pytest.mark.parametrize("tags", [
    {532: ((15, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1))},
    {532: ((0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (128, 1))},
    {529: ((2126, 10000), (7152, 10000), (722, 10000))},
    {529: ((299, 1000), (587, 1000), (114, 1000)),
     532: ((1, 3), (254, 1), (127, 2), (250, 1), (129, 1), (251, 1))}],
    ids=["studio_range", "flat_cr", "bt709_coefficients", "fractions"])
def test_ycbcr_coefficients_and_reference_match_cv2(cv2, pil, tmp_path,
                                                    tags):
    # YCbCrCoefficients and ReferenceBlackWhite other than the defaults
    # (Pillow writes the tags it is given)
    from PIL import TiffImagePlugin

    info = TiffImagePlugin.ImageFileDirectory_v2()
    for tag, values in tags.items():
        info[tag] = tuple(TiffImagePlugin.IFDRational(*v) for v in values)
        info.tagtype[tag] = 5
    rgb = fx.fixture_image(33, 47, seed=43)
    data = _pillow_tiff(pil, rgb, "YCbCr", tiffinfo=info)
    assert _same_as_cv2(cv2, tmp_path / "coeffs.tif", data)


@pytest.mark.parametrize("sub", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                 (4, 2), (4, 4), (1, 4), (2, 4)])
@pytest.mark.parametrize("size", [(16, 24), (37, 45)])
def test_subsampled_ycbcr_strips_match_cv2(cv2, tmp_path, sub, size):
    # the data units libtiff's putcontig8bitYCbCrXYtile routines read
    # (each block's chroma over its pixels); 1x4 and 2x4 it refuses
    rng = np.random.default_rng(44)
    px = rng.integers(0, 256, size + (3,)).astype(np.uint8)
    for rps, comp in ((size[0], 1), (8, 8)):
        read = _same_as_cv2(cv2, tmp_path / "sub.tif",
                            fx.ycbcr_subsampled_tiff(px, *sub, rps, comp))
        assert read == (sub not in ((1, 4), (2, 4)))


@pytest.mark.parametrize("sub", [(1, 1), (2, 2)])
def test_planar_ycbcr_matches_cv2(cv2, tmp_path, sub):
    # separate planes: libtiff reads them unsubsampled and refuses them
    # subsampled
    px = np.random.default_rng(45).integers(0, 256, (21, 30, 3)).astype(
        np.uint8)
    for rps in (21, 4):
        data = fx.ycbcr_subsampled_tiff(px, *sub, rps, planar=True)
        assert _same_as_cv2(cv2, tmp_path / "planar.tif", data) == (
            sub == (1, 1))


def test_missing_subsampling_tag_matches_cv2(cv2, pil, tmp_path):
    # without tag 530 the subsampling is 2, 2: Pillow's unsubsampled data
    # is then read as data units, as libtiff reads it
    data = _pillow_tiff(pil, fx.fixture_image(20, 30, seed=45), "YCbCr")
    i = data.find(b"\x12\x02\x03\x00")              # tag 530, SHORT
    assert data[:2] == b"II" and i > 0
    _same_as_cv2(cv2, tmp_path / "no530.tif",
                 data[:i] + b"\x13\x02" + data[i + 2:])  # tag 531 instead


# ------------------------------------------------ stages by symbol


class _Display(ctypes.Structure):
    _fields_ = [("d_mat", ctypes.c_float * 9),
                ("d_YCR", ctypes.c_float), ("d_YCG", ctypes.c_float),
                ("d_YCB", ctypes.c_float),
                ("d_Vrwr", ctypes.c_uint32), ("d_Vrwg", ctypes.c_uint32),
                ("d_Vrwb", ctypes.c_uint32),
                ("d_Y0R", ctypes.c_float), ("d_Y0G", ctypes.c_float),
                ("d_Y0B", ctypes.c_float),
                ("d_gammaR", ctypes.c_float), ("d_gammaG", ctypes.c_float),
                ("d_gammaB", ctypes.c_float)]


@pytest.mark.parametrize("ref", [None, (15, 235, 128, 240, 128, 240),
                                 (1 / 3, 254, 63.5, 250, 129, 251)])
@pytest.mark.parametrize("luma", [None, (0.2126, 0.7152, 0.0722)])
def test_ycbcr_tables_match_libtiff(libtiff, ref, luma):
    # TIFFYCbCrToRGBInit's five tables, read out of its struct, and
    # TIFFYCbCrtoRGB on a grid of samples, against the port's
    f32 = ctypes.c_float
    lum = (f32 * 3)(*(luma or (0.299, 0.587, 0.114)))
    rbw = (f32 * 6)(*(ref or (0, 255, 128, 255, 128, 255)))
    buf = ctypes.create_string_buffer(64 + 4 * 256 + 5 * 4 * 256)
    libtiff.TIFFYCbCrToRGBInit.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(f32),
                                           ctypes.POINTER(f32)]
    assert libtiff.TIFFYCbCrToRGBInit(buf, lum, rbw) == 0
    ptrs = np.frombuffer(buf.raw[:48], np.uint64)
    got = image_io.tiff_ycbcr_tables(
        None if luma is None else [np.float32(v) for v in lum],
        None if ref is None else [np.float32(v) for v in rbw])
    for k, name in enumerate(("Cr_r_tab", "Cb_b_tab", "Cr_g_tab",
                              "Cb_g_tab", "Y_tab"), start=1):
        want = np.frombuffer(ctypes.string_at(int(ptrs[k]), 1024), np.int32)
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    u32 = ctypes.c_uint32
    libtiff.TIFFYCbCrtoRGB.argtypes = [ctypes.c_void_p, u32, ctypes.c_int32,
                                       ctypes.c_int32] + \
        [ctypes.POINTER(u32)] * 3
    grid = np.arange(0, 256, 5)
    px = np.stack(np.meshgrid(grid, grid, grid, indexing="ij"), -1).reshape(
        -1, 3).astype(np.uint8)
    rgb = image_io.tiff_ycbcr_to_rgb(px[None], None if luma is None else [
        np.float32(v) for v in lum], None if ref is None else [
        np.float32(v) for v in rbw])[0]
    r, g, b = u32(), u32(), u32()
    for (y, cb, cr), want in zip(px[::7], rgb[::7]):
        libtiff.TIFFYCbCrtoRGB(buf, int(y), int(cb), int(cr), r, g, b)
        assert (r.value, g.value, b.value) == tuple(want), (y, cb, cr)


def test_cielab_matches_libtiff(libtiff):
    # TIFFCIELabToRGBInit with libtiff's display_sRGB and the D50 white of
    # its default WhitePoint, then TIFFCIELabToXYZ and TIFFXYZToRGB, on
    # every L with a grid of a and b, against the port's
    f32, u32 = ctypes.c_float, ctypes.c_uint32
    disp = _Display((f32 * 9)(*[v for row in image_io._SRGB_MATRIX
                                for v in row]), 100, 100, 100, 255, 255, 255,
                    1, 1, 1, 2.4, 2.4, 2.4)
    x0, y0, z0 = np.float32(96.4250), np.float32(100.0), np.float32(82.4680)
    wx, wy = x0 / (x0 + y0 + z0), y0 / (x0 + y0 + z0)
    white = (f32 * 3)(wx / wy * np.float32(100), 100,
                      (np.float32(1) - wx - wy) / wy * np.float32(100))
    lab = ctypes.create_string_buffer(1 << 16)
    assert libtiff.TIFFCIELabToRGBInit(lab, ctypes.byref(disp), white) == 0
    libtiff.TIFFCIELabToXYZ.argtypes = [ctypes.c_void_p, u32,
                                        ctypes.c_int32, ctypes.c_int32] + \
        [ctypes.POINTER(f32)] * 3
    libtiff.TIFFXYZToRGB.argtypes = [ctypes.c_void_p, f32, f32, f32] + \
        [ctypes.POINTER(u32)] * 3
    ab = np.arange(-128, 128, 9)
    L, A, B = np.meshgrid(np.arange(256), ab, ab[::2], indexing="ij")
    px = np.stack([L, A & 255, B & 255], -1).reshape(-1, 3).astype(np.uint8)
    got = image_io.tiff_cielab_to_rgb(px[None])[0]
    X, Y, Z = f32(), f32(), f32()
    r, g, b = u32(), u32(), u32()
    for (lv, av, bv), want in zip(px, got):
        libtiff.TIFFCIELabToXYZ(lab, int(lv), int(np.int8(av)),
                                int(np.int8(bv)), X, Y, Z)
        libtiff.TIFFXYZToRGB(lab, X, Y, Z, r, g, b)
        assert (r.value, g.value, b.value) == tuple(want), (lv, av, bv)
