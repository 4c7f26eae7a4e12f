"""The port's image readers and writers beyond plain PNG and JPEG
(``utils/image_io``: interlaced PNG, TIFF through ``csrc/tiff_codec.cpp``,
BMP, PNM) against cv2, the JAX package's reader and writer: decodes bit for
bit, encodes byte for byte; the committed fixtures of ``tests/torch_images/``
(``tests/torch_make_image_fixtures.py``, WebP's, GIF's, HDR's, PFM's,
PAM's, Sun raster's and BigTIFF's too) where cv2 is absent; scenes of each
format (WebP lossless and lossy, GIF, HDR, PFM, PAM, Sun raster and BigTIFF
too) loaded by JAX's ``Splatter`` (cv2) and the port's (cv2 made
unimportable); the port's pyramid against JAX's ``downsample.py``.  WebP's
own tests are in ``tests/test_torch_webp.py``; GIF's, HDR's, PFM's, PAM's,
Sun raster's and BigTIFF's in ``tests/test_torch_raster_formats.py``.

The cv2 tests take cv2 with ``pytest.importorskip`` inside a fixture (PIL
where it writes the file); the fixture tests need neither.
"""

import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_bmp, read_image, \
    read_png, read_pnm, read_tiff, write_bmp, write_pnm, write_tiff

import torch_make_image_fixtures as fx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _noise(shape, hi=256, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape)


def _same_as_cv2(cv2, path, reader=read_image):
    """The port's decode of ``path`` against cv2's: equal bit for bit, or
    cv2 gives None and the port raises naming the file."""
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises((ValueError, RuntimeError),
                           match=os.path.basename(str(path))):
            reader(str(path))
        return False
    got = reader(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


# ------------------------------------------------------ committed fixtures


@pytest.fixture(scope="module")
def fixture_results(tmp_path_factory):
    return fx.check(scratch=str(tmp_path_factory.mktemp("fx")))


@pytest.mark.parametrize("name", fx.CASES + fx.REFUSED + fx.GARBLED
                         + fx.ENCODED + fx.ENCODED_J2K
                         + list(fx.ENCODED_J2K_RATE) + list(fx.RESIZED)
                         + list(fx.TIMING_CV2) + fx.ROUND_TRIP
                         + fx.AVIF_UNPORTED + list(fx.TIMING_AVIF))
def test_committed_fixture(fixture_results, name):
    # no cv2 here: each file against cv2's recorded decode (REFUSED, and
    # GARBLED, which cv2 reads only in part: the port raises naming the
    # file; ENCODED, ENCODED_J2K, ENCODED_J2K_RATE: the writer's bytes are
    # cv2's; RESIZED: downsample_area's pixels are cv2.resize's;
    # TIMING_CV2: the full-size bytes and pixels hash as cv2's;
    # ROUND_TRIP: the writer's file reads back as its source;
    # AVIF_UNPORTED: the port raises naming the file and the kind it does
    # not read yet; TIMING_AVIF: the full-size decodes hash as cv2's)
    assert fixture_results[name] is True


def test_committed_timing_view_matches_cv2(cv2):
    _same_as_cv2(cv2, os.path.join(fx.FOLDER, fx.TIMING))


@pytest.mark.parametrize("name", list(fx.TIMING_J2K))
def test_committed_jpeg2000_timing_views(name):
    # no cv2 here: the decode's SHA-256 is the one recorded from cv2's
    import hashlib

    got = read_image(os.path.join(fx.FOLDER, name))
    assert got.shape == (840, 1297, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == fx.TIMING_J2K[name]


# ----------------------------------------------------------- Adam7 PNG


_PNG_KINDS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + \
    [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("ctype,depth", _PNG_KINDS,
                         ids=[f"type{c}_{d}bit" for c, d in _PNG_KINDS])
def test_interlaced_png_matches_cv2(cv2, tmp_path, ctype, depth):
    # interlaced equals cv2 and the same samples written non-interlaced
    # (write_adam7_png's filters, each row a random type)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    for h, w in [(1, 1), (3, 2), (9, 13), (17, 23)]:
        hi = min(1 << depth, 7) if ctype == 3 else 1 << depth
        samples = _noise((h, w, ch), hi, seed=h * w)
        pal = _noise((7, 3), seed=1) if ctype == 3 else None
        path = tmp_path / f"i{h}x{w}.png"
        fx.write_adam7_png(str(path), samples, depth, ctype, pal, seed=h)
        _same_as_cv2(cv2, path, read_png)
        flat = cv2.imread(str(path))
        assert flat is not None
        np.testing.assert_array_equal(read_png(str(path)), flat[..., ::-1])


# ----------------------------------------------------------------- TIFF


_TIFF_KINDS = {
    "rgb8": dict(samples=(3, 8)), "rgb16": dict(samples=(3, 16)),
    "gray8": dict(samples=(1, 8)), "gray16": dict(samples=(1, 16)),
    "white8": dict(samples=(1, 8), photometric=0),
    "white16": dict(samples=(1, 16), photometric=0),
    "rgba8_assoc": dict(samples=(4, 8), extra_samples=[1]),
    "rgba8_unassoc": dict(samples=(4, 8), extra_samples=[2]),
    "rgba16_unassoc": dict(samples=(4, 16), extra_samples=[2]),
    "bilevel": dict(samples=(1, 1)),
    "bilevel_white": dict(samples=(1, 1), photometric=0),
    "palette1": dict(samples=(1, 1), photometric=3),
    "palette4": dict(samples=(1, 4), photometric=3),
    "palette8": dict(samples=(1, 8), photometric=3),
    "cmyk8": dict(samples=(4, 8), photometric=5),
}
_TIFF_LAYOUTS = {
    "none_strip": dict(compression=1),
    "lzw_strips_pred": dict(compression=5, predictor=2, rows_per_strip=3),
    "deflate_tiles_pred": dict(compression=8, predictor=2, tile=(16, 16)),
    "lzw_planar": dict(compression=5, planar=2, rows_per_strip=4),
    "none_planar_tiles_mm": dict(compression=1, planar=2, tile=(16, 16),
                                 endian=">"),
    "deflate_mm_pred": dict(compression=8, predictor=2, endian=">"),
}


@pytest.mark.parametrize("layout", list(_TIFF_LAYOUTS))
@pytest.mark.parametrize("kind", list(_TIFF_KINDS))
def test_tiff_matches_cv2(cv2, tmp_path, kind, layout):
    spec = dict(_TIFF_KINDS[kind])
    spp, bps = spec.pop("samples")
    opts = {**_TIFF_LAYOUTS[layout], **spec}
    if opts.get("predictor") == 2 and bps not in (8, 16):
        opts.pop("predictor")
    if kind in ("gray16", "white16") and "tile" in opts:
        # cv2 garbles tiled 16-bit gray (ROADMAP §3, faults of the
        # reference): the port decodes it as it decodes the strips
        h, w = 20, 37
        v = _noise((h, w), 1 << 16, seed=3)
        fx.write_tiff_file(str(tmp_path / "t.tif"), v, bps=16, **opts)
        fx.write_tiff_file(str(tmp_path / "s.tif"), v, bps=16,
                           photometric=opts.get("photometric", 1))
        np.testing.assert_array_equal(read_tiff(str(tmp_path / "t.tif")),
                                      read_tiff(str(tmp_path / "s.tif")))
        assert _same_as_cv2(cv2, tmp_path / "s.tif")
        return
    for h, w in [(1, 1), (7, 9), (20, 37)]:
        v = _noise((h, w, spp), 1 << bps, seed=h)
        if opts.get("photometric") == 3:
            opts["colormap"] = _noise((1 << bps, 3), 1 << 16, seed=w)
        path = tmp_path / f"{kind}_{h}x{w}.tif"
        fx.write_tiff_file(str(path), v, bps=bps, **opts)
        assert _same_as_cv2(cv2, path), "cv2 reads every one of these"


_CV2_TIFF = {"none": 1, "lzw": 5, "deflate": 8, "adobe_deflate": 32946,
             "packbits": 32773, "jpeg": 7}


@pytest.mark.parametrize("comp", list(_CV2_TIFF))
def test_tiff_written_by_cv2_and_pil(cv2, tmp_path, comp):
    # cv2.imwrite's compressions at 8 and 16 bits, color and gray; PIL's
    # (libtiff) for the same compressions in its modes
    Image = pytest.importorskip("PIL.Image")
    flag = [cv2.IMWRITE_TIFF_COMPRESSION, _CV2_TIFF[comp]]
    # (libtiff's JPEG strips need a multiple of 8 rows: one strip here)
    for h, w in [(40, 50), (24, 64) if comp == "jpeg" else (17, 200)]:
        img = fx.fixture_image(h, w, seed=h)
        arrays = [img[..., ::-1], img[..., 0]]
        if comp != "jpeg":
            arrays += [_noise((h, w, 3), 1 << 16, h).astype(np.uint16),
                       _noise((h, w), 1 << 16, w).astype(np.uint16)]
        for i, arr in enumerate(arrays):
            path = tmp_path / f"cv2_{i}_{h}x{w}.tif"
            assert cv2.imwrite(str(path), arr, flag)
            assert _same_as_cv2(cv2, path)
        pil = {"none": "raw", "lzw": "tiff_lzw", "deflate": "tiff_deflate",
               "adobe_deflate": "tiff_adobe_deflate", "packbits": "packbits",
               "jpeg": "jpeg"}[comp]
        for mode in ("RGB", "L") if comp == "jpeg" else \
                ("RGB", "L", "P", "1", "RGBA", "CMYK"):
            path = tmp_path / f"pil_{mode}_{h}x{w}.tif"
            Image.fromarray(img).convert(mode).save(str(path),
                                                    compression=pil)
            assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("factor", ["420", "422", "444"])
def test_tiff_ycbcr_jpeg_matches_cv2(cv2, tmp_path, factor):
    # photometric 6 with JPEG strips: libtiff asks libjpeg for YCbCr -> RGB
    sub = {"420": (2, 2), "422": (2, 1), "444": (1, 1)}[factor]
    flag = [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")]
    for h, w in [(32, 48), (45, 61)]:
        jpeg = cv2.imencode(".jpg", fx.fixture_image(h, w, seed=2), flag)[1]
        path = tmp_path / f"ycc{h}x{w}.tif"
        fx.write_jpeg_tiff(str(path), jpeg.tobytes(), h, w, sub)
        assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_matches_cv2(cv2, tmp_path, orientation):
    # cv2 applies tag 274; on a non-square image it fails at 5-8 (None),
    # and the port raises there
    for h, w in [(24, 24), (20, 31)]:
        path = tmp_path / f"o{h}x{w}.tif"
        fx.write_tiff_file(str(path), fx.fixture_image(h, w, orientation),
                           compression=5)
        _retag(path, 274, orientation)
        read = _same_as_cv2(cv2, path)
        assert read == (orientation <= 4 or h == w), (h, w)


def _retag(path, tag, value):
    """Append a SHORT tag to the first IFD of a little-endian TIFF (the IFD
    moved to the end of the file)."""
    import struct

    data = bytearray(path.read_bytes())
    ifd = struct.unpack_from("<I", data, 4)[0]
    n = struct.unpack_from("<H", data, ifd)[0]
    entries = [bytes(data[ifd + 2 + 12 * i:ifd + 14 + 12 * i])
               for i in range(n)]
    entries.append(struct.pack("<HHIHH", tag, 3, 1, value, 0))
    entries.sort(key=lambda e: struct.unpack_from("<H", e)[0])
    new = len(data) + len(data) % 2
    data += b"\x00" * (len(data) % 2)
    data += struct.pack("<H", len(entries)) + b"".join(entries) + bytes(4)
    struct.pack_into("<I", data, 4, new)
    path.write_bytes(bytes(data))


_TIFF_REFUSED = {
    "gray2": dict(v=(1, 2)), "gray4": dict(v=(1, 4)),
    "palette2": dict(v=(1, 2), photometric=3),
    "gray_alpha": dict(v=(2, 8), extra_samples=[2]),
    "palette16": dict(v=(1, 16), photometric=3),
}


@pytest.mark.parametrize("kind", list(_TIFF_REFUSED))
def test_tiff_kinds_cv2_refuses_raise(cv2, tmp_path, kind):
    spec = dict(_TIFF_REFUSED[kind])
    spp, bps = spec.pop("v")
    if spec.get("photometric") == 3:
        spec["colormap"] = _noise((1 << bps, 3), 1 << 16)
    path = tmp_path / f"refused_{kind}.tif"
    fx.write_tiff_file(str(path), _noise((6, 9, spp), 1 << bps), bps=bps,
                       **spec)
    assert cv2.imread(str(path)) is None
    with pytest.raises(ValueError, match=f"refused_{kind}.tif.*TIFF"):
        read_tiff(str(path))


@pytest.mark.parametrize("size", [(1, 1), (7, 9), (45, 61), (97, 1297),
                                  (300, 200)])
def test_tiff_writer_matches_cv2_bytes(cv2, tmp_path, size):
    h, w = size
    img = fx.fixture_image(h, w, seed=w) if h > 40 else \
        _noise((h, w, 3), seed=h).astype(np.uint8)
    write_tiff(str(tmp_path / "port.tif"), img)
    cv2.imwrite(str(tmp_path / "cv2.tif"), img[..., ::-1])
    assert (tmp_path / "port.tif").read_bytes() == \
        (tmp_path / "cv2.tif").read_bytes()
    np.testing.assert_array_equal(read_tiff(str(tmp_path / "cv2.tif")), img)


def test_tiff_lzw_past_the_table_and_ratio_resets(cv2, tmp_path):
    # a strip long enough to fill the LZW table (CLEAR at 4094) and to
    # trip libtiff's ratio check: noise, then flat rows, then noise
    rng = np.random.default_rng(4)
    img = np.concatenate([rng.integers(0, 256, (40, 2700, 3)),
                          np.full((40, 2700, 3), 77),
                          rng.integers(0, 4, (40, 2700, 3))]).astype(np.uint8)
    write_tiff(str(tmp_path / "port.tif"), img)
    cv2.imwrite(str(tmp_path / "cv2.tif"), img[..., ::-1])
    assert (tmp_path / "port.tif").read_bytes() == \
        (tmp_path / "cv2.tif").read_bytes()
    np.testing.assert_array_equal(read_tiff(str(tmp_path / "port.tif")), img)


# ------------------------------------------------------------------ BMP


def _bmp_cases():
    rng = np.random.default_rng(5)
    h, w = 13, 30
    smooth = (np.arange(w)[None] // 3 + np.arange(h)[:, None] // 2) % 256
    smooth[::3, ::4] = rng.integers(0, 256, smooth[::3, ::4].shape)
    pal = {b: rng.integers(0, 256, (1 << b, 3)) for b in (1, 4, 8)}
    idx = {b: rng.integers(0, 1 << b, (h, w)) for b in (1, 4, 8)}
    v16 = rng.integers(0, 1 << 16, (h, w))
    rgb = rng.integers(0, 256, (h, w, 3))
    return {
        "pal1": (idx[1], 1, pal[1], {}), "pal4": (idx[4], 4, pal[4], {}),
        "pal8": (idx[8], 8, pal[8], {}),
        "pal8_top_down": (idx[8], 8, pal[8], dict(top_down=True)),
        "rle8": (smooth, 8, pal[8], dict(comp=1)),
        "rle4": (smooth % 16, 4, pal[4], dict(comp=2)),
        "rle4_noise": (idx[4], 4, pal[4], dict(comp=2)),
        "555": (v16, 16, None, {}),
        "565": (v16, 16, None, dict(comp=3, masks=(0xF800, 0x7E0, 0x1F))),
        "555_bitfields": (v16, 16, None,
                          dict(comp=3, masks=(0x7C00, 0x3E0, 0x1F))),
        "444_bitfields": (v16, 16, None,
                          dict(comp=3, masks=(0xF00, 0xF0, 0xF))),
        "24": (rgb, 24, None, {}),
        "24_top_down": (rgb, 24, None, dict(top_down=True)),
        "32": (rng.integers(0, 256, (h, w, 4)), 32, None, {}),
        "32_bitfields": (rng.integers(0, 256, (h, w, 4)), 32, None,
                         dict(comp=3, masks=(0xFF0000, 0xFF00, 0xFF))),
    }


_BMP = _bmp_cases()


@pytest.mark.parametrize("kind", list(_BMP))
def test_bmp_matches_cv2(cv2, tmp_path, kind):
    px, bits, pal, opts = _BMP[kind]
    path = tmp_path / f"{kind}.bmp"
    fx.write_bmp_file(str(path), px, bits, pal, **opts)
    read = _same_as_cv2(cv2, path, read_bmp)
    assert read == (kind != "444_bitfields")


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_written_by_pil_matches_cv2(cv2, tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    for h, w in [(1, 1), (5, 7), (16, 33)]:
        path = tmp_path / f"{mode}_{h}x{w}.bmp"
        Image.fromarray(fx.fixture_image(h, w, seed=h)).convert(mode).save(
            str(path))
        assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("ext", [".bmp", ".dib"])
def test_bmp_writer_matches_cv2_bytes(cv2, tmp_path, ext):
    for h, w in [(1, 1), (5, 7), (13, 30), (840, 1297)]:
        img = _noise((h, w, 3), seed=w).astype(np.uint8)
        write_bmp(str(tmp_path / f"port{ext}"), img)
        cv2.imwrite(str(tmp_path / f"cv2{ext}"), img[..., ::-1])
        assert (tmp_path / f"port{ext}").read_bytes() == \
            (tmp_path / f"cv2{ext}").read_bytes()


# ------------------------------------------------------------------ PNM


_PNM = [("P1", 1), ("P4", 1)] + [(k, m) for k in ("P2", "P3", "P5", "P6")
                                 for m in (1, 7, 255, 256, 1000, 65535)]


@pytest.mark.parametrize("kind,maxval", _PNM,
                         ids=[f"{k}_{m}" for k, m in _PNM])
def test_pnm_matches_cv2(cv2, tmp_path, kind, maxval):
    # binary samples as they are below maxval 256, their high byte above;
    # text samples scaled by 255 / maxval below 256 (cut to maxval first)
    ch = 3 if kind in ("P3", "P6") else 1
    for h, w in [(1, 1), (5, 7), (9, 13)]:
        vals = _noise((h, w, ch) if ch == 3 else (h, w), maxval + 1, seed=h)
        path = tmp_path / f"{kind}_{h}x{w}.pnm"
        fx.write_pnm_file(str(path), kind, vals, maxval)
        assert _same_as_cv2(cv2, path, read_pnm)


def test_pnm_text_values_past_maxval_and_comments(cv2, tmp_path):
    path = tmp_path / "over.pgm"
    path.write_bytes(b"P2\n# c1\n4 1 # c2\n7\n0 3\n# mid\n9 7\n")
    assert _same_as_cv2(cv2, path, read_pnm)
    np.testing.assert_array_equal(read_pnm(str(path))[0, :, 0],
                                  [0, 109, 255, 255])
    path.write_bytes(b"P5\n4 1\n1000\n" + np.array(
        [0, 500, 999, 1000], ">u2").tobytes())
    assert _same_as_cv2(cv2, path, read_pnm)
    np.testing.assert_array_equal(read_pnm(str(path))[0, :, 0], [0, 1, 3, 3])


@pytest.mark.parametrize("ext", [".ppm", ".pnm", ".pgm", ".pbm"])
def test_pnm_writer_matches_cv2_bytes(cv2, tmp_path, ext):
    img = _noise((9, 13, 3), seed=2).astype(np.uint8)
    ok = cv2.imwrite(str(tmp_path / f"cv2{ext}"), img[..., ::-1])
    if ext in (".pgm", ".pbm"):        # cv2 writes no color .pgm / .pbm
        assert not ok
        with pytest.raises(ValueError, match=f"port{ext}"):
            write_pnm(str(tmp_path / f"port{ext}"), img)
        return
    write_pnm(str(tmp_path / f"port{ext}"), img)
    assert (tmp_path / f"port{ext}").read_bytes() == \
        (tmp_path / f"cv2{ext}").read_bytes()


# ----------------------------------------------------- unported formats


# kinds of a format cv2 reads that the port does not yet: extension ->
# (the kind as the port names it, Pillow's save options that make it: an
# EXIF orientation, which Pillow's AVIF writer turns into an irot)
_UNPORTED = {"avif": (r"a rotation \(irot\)", dict(exif={0x0112: 6}))}


@pytest.mark.parametrize("ext", list(_UNPORTED))
def test_unported_formats_raise_naming_the_format(cv2, tmp_path, ext):
    # a file Pillow writes and cv2 reads: the port says it does not read
    # the kind yet (AVIF itself is read since the port's AV1 decoder)
    pytest.importorskip("PIL.AvifImagePlugin")
    from PIL import Image

    kind, opts = _UNPORTED[ext]
    path = tmp_path / f"view.{ext}"
    img = fx.fixture_image(12, 16, seed=1)
    if "exif" in opts:
        exif = Image.Exif()
        exif.update(opts["exif"])
        opts = dict(opts, exif=exif)
    Image.fromarray(img).save(str(path), **opts)
    assert cv2.imread(str(path)) is not None
    with pytest.raises(RuntimeError,
                       match=f"view.{ext}: an {ext.upper()} (image|file) "
                             f"with {kind}.*not read yet"):
        read_image(str(path))


def test_not_an_image_raises_naming_the_file(tmp_path):
    path = tmp_path / "notes.txt"
    path.write_text("not an image")
    with pytest.raises(RuntimeError, match="notes.txt: not an image"):
        read_image(str(path))


# ------------------------------------------------------ scenes, pyramid


_SCENE_FORMATS = {"tiff": ".tif", "bmp": ".bmp", "pnm": ".ppm",
                  "webp": ".webp", "webp_lossy": ".webp", "gif": ".gif",
                  "hdr": ".hdr", "pfm": ".pfm", "pam": ".pam", "ras": ".ras",
                  "bigtiff": ".tif", "jp2": ".jp2", "jp2_lossless": ".jp2",
                  "avif": ".avif", "avif_lossless": ".avif"}
# cv2.imwrite's parameters where a scene is not written with its defaults
# (jp2: cv2's default, rate 4; jp2_lossless: its lossless setting; avif:
# cv2's default, quality 50)
_SCENE_PARAMS = {"webp_lossy": ("IMWRITE_WEBP_QUALITY", 90),
                 "jp2_lossless": ("IMWRITE_JPEG2000_COMPRESSION_X1000", 1000),
                 "avif_lossless": ("IMWRITE_AVIF_QUALITY", 100)}


@pytest.fixture(scope="module")
def capture_scene(tmp_path_factory):
    """The JPG scene of ``fixtures.make_real_capture_scene``."""
    pytest.importorskip("cv2")
    from fixtures import make_real_capture_scene

    root = tmp_path_factory.mktemp("capture")
    make_real_capture_scene(str(root))
    return root


def _convert_scene(cv2, root, dst, fmt):
    """A copy of the JPG scene whose views cv2 rewrote as format ``fmt``
    (``_SCENE_FORMATS``)."""
    ext = _SCENE_FORMATS[fmt]
    params = []
    if fmt in _SCENE_PARAMS:
        name, value = _SCENE_PARAMS[fmt]
        params = [getattr(cv2, name), value]
    shutil.copytree(root / "sparse", dst / "sparse")
    images = dst / "images_1"
    images.mkdir()
    for name in sorted(os.listdir(root / "images_1")):
        img = cv2.imread(str(root / "images_1" / name))
        out = images / (name[:-4] + ext)
        assert cv2.imwrite(str(out), img, params)
        if fmt == "bigtiff":          # cv2's TIFF in the BigTIFF layout
            out.write_bytes(fx.to_bigtiff(out.read_bytes()))
    path = dst / "sparse" / "0" / "images.bin"
    path.write_bytes(path.read_bytes().replace(b".jpg\x00",
                                               ext.encode() + b"\x00"))
    return str(dst / "sparse" / "0"), str(images)


@pytest.mark.parametrize("fmt", list(_SCENE_FORMATS))
def test_scene_loads_as_jax_loads_it(cv2, capture_scene, tmp_path, fmt):
    from gsplat_tpu.config import SplatConfig as JCfg
    from gsplat_tpu.models.splatter import Splatter as JSplatter

    from gsplat_tpu_torch.config import SplatConfig as TCfg
    from gsplat_tpu_torch.models.splatter import Splatter as TSplatter

    paths = _convert_scene(cv2, capture_scene, tmp_path, fmt)
    jsplat = JSplatter(*paths, JCfg(plane_mode="dense", use_pallas=False,
                                    capacity_round=256, render_downsample=1))
    with mock.patch.dict(sys.modules, {"cv2": None}):
        tsplat = TSplatter(*paths, TCfg(capacity_round=256,
                                        render_downsample=1), device="cpu")
    assert len(tsplat.camera_groups) == len(jsplat.camera_groups) == 2
    for jg, tg in zip(jsplat.camera_groups, tsplat.camera_groups):
        assert (tg.grid.width, tg.grid.height, tg.n_cameras) == \
            (jg.grid.width, jg.grid.height, jg.n_cameras)
        assert (tg.grid.focal_x, tg.grid.focal_y) == \
            (jg.grid.focal_x, jg.grid.focal_y)
        assert tg.names == list(jg.names)
        assert all(n.endswith(_SCENE_FORMATS[fmt]) for n in tg.names)
        np.testing.assert_array_equal(tg.images.numpy(),
                                      np.asarray(jg.images))


def _pyramids(cv2, capture_scene, tmp_path, fmt, factor):
    """The JAX root downsample.py (cv2) and the port's module over a folder
    of one format at ``factor`` → the file names both wrote."""
    _, src = _convert_scene(cv2, capture_scene, tmp_path / "scene", fmt)
    for script, dst in ((["downsample.py"], "jax"),
                        (["-m", "gsplat_tpu_torch.downsample"], "port")):
        subprocess.run([sys.executable, *script, "--src", src, "--dst",
                        str(tmp_path / dst), "--factor", str(factor)],
                       cwd=REPO, capture_output=True, text=True, check=True)
    names = sorted(os.listdir(tmp_path / "port"))
    stubs = sorted(set(os.listdir(tmp_path / "jax")) - set(names))
    assert set(names) <= set(os.listdir(tmp_path / "jax"))
    for name in stubs:
        # where cv2's JP2 writer fails (a side under 32) it returns False
        # but leaves the 77 bytes of JP2 boxes it wrote before the
        # codestream, a file cv2 itself does not read; the port writes
        # no file there
        stub = tmp_path / "jax" / name
        assert name.endswith(".jp2") and stub.stat().st_size == 77
        assert cv2.imread(str(stub)) is None
    return names


@pytest.mark.parametrize("fmt", ["tiff", "bmp", "webp", "gif", "hdr", "pfm",
                                 "pam", "ras", "jp2"])
def test_downsample_matches_jax_script(cv2, capture_scene, tmp_path, fmt):
    # the JAX root downsample.py (cv2) and the port's module over a folder
    # of one format: the same files, byte for byte (WebP: the same pixels,
    # as cv2 and the port decode them, since libwebp's lossless encoder
    # chooses its bytes by searching; the Sun raster views are an even
    # number of pixels wide, so no row has the pad byte cv2 copies from
    # past its image; JP2: cv2's default, rate 4, and the 24x32 halves of
    # the 48x64 views are not written, under 32 pixels a side: _pyramids)
    names = _pyramids(cv2, capture_scene, tmp_path, fmt, 2)
    assert len(names) == (4 if fmt == "jp2" else 7)
    for name in names:
        jax_file, port_file = tmp_path / "jax" / name, tmp_path / "port" / name
        if fmt != "webp":
            assert jax_file.read_bytes() == port_file.read_bytes(), name
            continue
        assert port_file.read_bytes()[12:16] == b"VP8L", name
        want = cv2.imread(str(jax_file))[..., ::-1]
        for got in (cv2.imread(str(port_file))[..., ::-1],
                    read_image(str(port_file)), read_image(str(jax_file))):
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_downsample_skips_avif_names(cv2, capture_scene, tmp_path):
    # the port reads AVIF but writes none (no AV1 encoder): each .avif
    # name is skipped and named on stderr, where the JAX script writes
    # cv2's AVIFs
    _, src = _convert_scene(cv2, capture_scene, tmp_path / "scene", "avif")
    run = subprocess.run([sys.executable, "-m", "gsplat_tpu_torch.downsample",
                          "--src", src, "--dst", str(tmp_path / "port"),
                          "--factor", "2"], cwd=REPO, capture_output=True,
                         text=True, check=True)
    names = sorted(os.listdir(src))
    assert len(names) == 7 and all(n.endswith(".avif") for n in names)
    assert not os.listdir(tmp_path / "port")
    for name in names:
        assert f"skipped {os.path.join(src, name)}: not a name of an " \
               f"extension the port writes" in run.stderr, name


@pytest.mark.parametrize("fmt,factor", [("tiff", 1.5), ("tiff", 2.25),
                                        ("tiff", 0.5), ("tiff", 0.75),
                                        ("jp2", 1.5), ("jp2", 0.5)])
def test_downsample_fractional_matches_jax_script(cv2, capture_scene,
                                                  tmp_path, fmt, factor):
    # factors that are not whole (cv2's resizeArea_) and enlargements (its
    # linear resize with INTER_AREA's weights): the same files, byte for
    # byte (JP2: cv2's default rate-4 writer; at 1.5 the 32x43 thirds of
    # the 48x64 views are written)
    names = _pyramids(cv2, capture_scene, tmp_path, fmt, factor)
    assert len(names) == 7
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
