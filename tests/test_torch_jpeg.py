"""The port's JPEG codec (``csrc/jpeg_codec.cpp`` through
``utils/image_io.read_jpeg`` / ``write_jpeg``) against cv2, the JAX
package's reader and writer: decodes bit for bit, encodes byte for byte;
baseline, progressive, cut-short, arithmetic-coded, CMYK / YCCK and
lossless files, and the kinds cv2 refuses.

The cv2 tests take cv2 with ``pytest.importorskip`` (PIL for EXIF and
CMYK; the files libjpeg writes and cv2 cannot, through the C writer of
``tests/torch_make_image_fixtures.py``, skipped where it does not build);
``test_committed_fixtures`` holds the codec to the files of
``tests/torch_jpeg/`` (``tests/torch_make_jpeg_fixtures.py``) and needs
neither.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from gsplat_tpu_torch.utils.image_io import read_image, read_jpeg, \
    write_jpeg, write_png

import torch_make_image_fixtures as ifx
import torch_make_jpeg_fixtures as fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _image(h, w, kind="noise", seed=0):
    if kind == "noise":
        rng = np.random.default_rng(seed)
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return fixtures.fixture_image(h, w, seed)


# (id, (height, width), content, cv2 imwrite flags by name, grayscale)
_DECODE = [
    ("420", (45, 61), "noise", {}, False),
    ("422", (45, 61), "noise", {"SAMPLING_FACTOR": "422"}, False),
    ("440", (45, 61), "noise", {"SAMPLING_FACTOR": "440"}, False),
    ("444", (45, 61), "noise", {"SAMPLING_FACTOR": "444"}, False),
    ("411", (45, 61), "noise", {"SAMPLING_FACTOR": "411"}, False),
    ("gray", (45, 61), "noise", {}, True),
    ("q50", (45, 61), "smooth", {"QUALITY": 50}, False),
    ("q75", (45, 61), "smooth", {"QUALITY": 75}, False),
    ("q95", (45, 61), "smooth", {"QUALITY": 95}, False),
    ("q100", (45, 61), "noise", {"QUALITY": 100}, False),
    ("progressive_420", (45, 61), "noise", {"PROGRESSIVE": 1}, False),
    ("progressive_444", (45, 61), "smooth",
     {"PROGRESSIVE": 1, "SAMPLING_FACTOR": "444"}, False),
    ("progressive_gray", (45, 61), "noise", {"PROGRESSIVE": 1}, True),
    ("restart_1", (45, 61), "noise", {"RST_INTERVAL": 1}, False),
    ("restart_3_422", (45, 61), "smooth",
     {"RST_INTERVAL": 3, "SAMPLING_FACTOR": "422"}, False),
    ("progressive_restart", (45, 61), "noise",
     {"PROGRESSIVE": 1, "RST_INTERVAL": 2}, False),
    ("1x1", (1, 1), "noise", {}, False),
    ("1x1_444", (1, 1), "noise", {"SAMPLING_FACTOR": "444"}, False),
    ("17x9", (9, 17), "noise", {}, False),
    ("9x17_422", (17, 9), "noise", {"SAMPLING_FACTOR": "422"}, False),
    ("17x9_progressive", (9, 17), "smooth", {"PROGRESSIVE": 1}, False),
    ("61x45_440", (45, 61), "smooth", {"SAMPLING_FACTOR": "440"}, False),
    ("1297x840", (840, 1297), "smooth", {}, False),
]


@pytest.mark.parametrize("case", _DECODE, ids=[c[0] for c in _DECODE])
def test_decoder_matches_cv2(cv2, tmp_path, case):
    name, (h, w), kind, params, gray = case
    img = _image(h, w, kind, seed=len(name))
    flags = []
    for k, v in params.items():
        if k == "SAMPLING_FACTOR":
            v = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{v}")
        flags += [getattr(cv2, f"IMWRITE_JPEG_{k}"), v]
    path = str(tmp_path / f"{name}.JPG")
    assert cv2.imwrite(path, img[..., 0] if gray else img[..., ::-1], flags)
    want = cv2.imread(path)[..., ::-1]
    got = read_jpeg(path)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(cv2, tmp_path, orientation):
    Image = pytest.importorskip("PIL.Image")
    img = _image(40, 60, "smooth", seed=orientation)
    exif = Image.Exif()
    exif[0x0112] = orientation
    path = str(tmp_path / "o.jpg")
    Image.fromarray(img).save(path, exif=exif.tobytes(), quality=90)
    want = cv2.imread(path)[..., ::-1]
    assert want.shape[:2] == ((60, 40) if orientation > 4 else (40, 60))
    np.testing.assert_array_equal(read_jpeg(path), want)


_ENCODE = [((1, 1), "noise"), ((9, 17), "noise"), ((17, 9), "smooth"),
           ((45, 61), "noise"), ((45, 61), "smooth"), ((37, 53), "smooth"),
           ((840, 1297), "smooth")]


@pytest.mark.parametrize("case", list(ifx.exif_edge_cases()))
def test_exif_reader_edge_cases_match_cv2(cv2, tmp_path, case):
    # OpenCV's ExifReader: big-endian unless "II", the TIFF mark 42, the
    # first orientation entry, reads bounded by the segment
    payload, orientation = ifx.exif_edge_cases()[case]
    img = ifx.fixture_image(20, 30, seed=2)
    data = cv2.imencode(".jpg", img[..., ::-1])[1].tobytes()
    body = b"Exif\x00\x00" + payload
    path = tmp_path / "exif.jpg"
    path.write_bytes(data[:2] + b"\xff\xe1" + (len(body) + 2).to_bytes(
        2, "big") + body + data[2:])
    got = read_jpeg(str(path))
    np.testing.assert_array_equal(got, cv2.imread(str(path))[..., ::-1])
    assert got.shape[:2] == ((30, 20) if orientation > 4 else (20, 30))


@pytest.mark.parametrize("size,kind", _ENCODE,
                         ids=[f"{w}x{h}_{k}" for (h, w), k in _ENCODE])
def test_encoder_matches_cv2_bytes(cv2, tmp_path, size, kind):
    img = _image(*size, kind, seed=size[0])
    cv2.imwrite(str(tmp_path / "cv2.jpg"), img[..., ::-1])
    write_jpeg(str(tmp_path / "port.jpg"), img)
    assert (tmp_path / "port.jpg").read_bytes() == \
        (tmp_path / "cv2.jpg").read_bytes()


def test_downsample_matches_jax_script(cv2, tmp_path):
    # the JAX root downsample.py (cv2 only) and the port's module over one
    # folder: the same JPEG bytes, the same PNG pixels, other files skipped
    src = tmp_path / "src"
    src.mkdir()
    for i, (h, w) in enumerate([(84, 130), (45, 61), (17, 9)]):
        img = _image(h, w, "smooth", seed=i)
        cv2.imwrite(str(src / f"v{i}.JPG"), img[..., ::-1])
        cv2.imwrite(str(src / f"p{i}.png"), img[..., ::-1])
    (src / "notes.txt").write_text("not an image")
    (src / "bad.jpg").write_bytes(b"\xff\xd8\xff\xd9")
    for script, dst in ((["downsample.py"], "jax"),
                        (["-m", "gsplat_tpu_torch.downsample"], "port")):
        proc = subprocess.run(
            [sys.executable, *script, "--src", str(src), "--dst",
             str(tmp_path / dst), "--factor", "2"],
            cwd=REPO, capture_output=True, text=True, check=True)
    assert "notes.txt" in proc.stderr and "bad.jpg" in proc.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 6
    for name in names:
        a, b = tmp_path / "jax" / name, tmp_path / "port" / name
        if name.endswith(".JPG"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            np.testing.assert_array_equal(cv2.imread(str(a)),
                                          cv2.imread(str(b)), err_msg=name)


def _corrupt(data: bytes, kind: str) -> bytes:
    sof = data.index(b"\xff\xc0")
    if kind == "truncated":
        return data[:len(data) // 2]
    if kind == "arithmetic":
        return data[:sof] + b"\xff\xc9" + data[sof + 2:]
    if kind == "lossless":
        return data[:sof] + b"\xff\xc3" + data[sof + 2:]
    if kind == "12-bit":
        return data[:sof + 4] + b"\x0c" + data[sof + 5:]
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["truncated", "arithmetic", "lossless",
                                  "12-bit", "cmyk", "progressive_cut",
                                  "not_jpeg"])
def test_unsupported_or_broken_files_raise_with_the_name(cv2, tmp_path,
                                                          kind):
    # each file as cv2 reads it: where cv2 gives None the codec raises
    # naming the file; where cv2 decodes (a cut-short file, an arithmetic
    # SOF over Huffman data, CMYK) the codec equals it bit for bit, and a
    # file whose data ends early warns naming the file
    img = _image(45, 61, "noise")
    path = tmp_path / f"broken_{kind}.jpg"
    if kind == "cmyk":
        Image = pytest.importorskip("PIL.Image")
        Image.fromarray(img).convert("CMYK").save(str(path))
    elif kind == "progressive_cut":
        cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        data = path.read_bytes()
        scans = [i for i in range(len(data) - 1)
                 if data[i:i + 2] == b"\xff\xda"]
        path.write_bytes(data[:scans[3]] + b"\xff\xd9")   # 3 of its scans
    elif kind == "not_jpeg":
        path.write_bytes(b"GIF89a")
    else:
        cv2.imwrite(str(path), img)
        path.write_bytes(_corrupt(path.read_bytes(), kind))
    want = cv2.imread(str(path))
    if want is None:
        match = {"lossless": "lossless", "12-bit": "12-bit",
                 "not_jpeg": "not a JPEG"}[kind]
        with pytest.raises(ValueError, match=f"broken_{kind}.jpg.*{match}"):
            read_jpeg(str(path))
        return
    assert kind in ("truncated", "arithmetic", "cmyk", "progressive_cut")
    if kind == "truncated":
        with pytest.warns(RuntimeWarning, match=f"broken_{kind}.jpg"):
            got = read_jpeg(str(path))
    else:
        got = read_jpeg(str(path))
    np.testing.assert_array_equal(got, want[..., ::-1])


def test_committed_fixtures(tmp_path):
    # no cv2 here: the codec against cv2's recorded decodes and encoding
    assert fixtures.check(scratch=str(tmp_path)) == {
        name: True for name in [*fixtures.CASES, "enc_src"]}


def test_read_image_goes_by_signature(tmp_path):
    img = _image(9, 17, "noise")
    write_png(str(tmp_path / "png_named.jpg"), img)
    write_jpeg(str(tmp_path / "jpeg_named.png"), img)
    np.testing.assert_array_equal(read_image(str(tmp_path / "png_named.jpg")),
                                  img)
    np.testing.assert_array_equal(
        read_image(str(tmp_path / "jpeg_named.png")),
        read_jpeg(str(tmp_path / "jpeg_named.png")))
    (tmp_path / "photo.tif").write_bytes(b"GIF89a")
    with pytest.raises(RuntimeError, match="photo.tif.*GIF.*not read yet"):
        read_image(str(tmp_path / "photo.tif"))


# ------------------------------------------ the JPEG kinds beyond baseline
# (cut-short, arithmetic-coded, CMYK / YCCK and lossless files, and those
# cv2 refuses), written by tests/torch_make_image_fixtures.py's C writer
# over the system libjpeg-turbo and over Pillow's bundled libjpeg-turbo 3


@pytest.fixture(scope="module")
def jpeg_tools(tmp_path_factory):
    pytest.importorskip("PIL")
    try:
        return ifx._jpeg_tools(str(tmp_path_factory.mktemp("jpegw")))
    except (OSError, IndexError, subprocess.CalledProcessError) as err:
        pytest.skip(f"no C writer over libjpeg: {err}")


def _as_cv2(cv2, path):
    """read_jpeg against cv2.imread: equal, or both refuse (the port naming
    the file).  → True where cv2 decoded."""
    import warnings

    want = cv2.imread(str(path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        if want is None:
            with pytest.raises(ValueError, match=os.path.basename(str(path))):
                read_jpeg(str(path))
            return False
        got = read_jpeg(str(path))
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


_CUT = {
    "baseline_420": ("cv2", {}), "baseline_gray": ("cv2_gray", {}),
    "baseline_restart": ("cv2", {"RST_INTERVAL": 2}),
    "progressive_420": ("cv2", {"PROGRESSIVE": 1}),
    "progressive_444": ("cv2", {"PROGRESSIVE": 1,
                                "SAMPLING_FACTOR": "444"}),
    "progressive_gray": ("cv2_gray", {"PROGRESSIVE": 1}),
    "progressive_restart": ("cv2", {"PROGRESSIVE": 1, "RST_INTERVAL": 3}),
    "progressive_422_tool": ("tool", ("-prog", "-q", "70")),
    "progressive_cmyk_tool": ("tool", ("-prog", "-space", "cmyk")),
}


@pytest.mark.parametrize("kind", list(_CUT))
def test_cut_short_files_match_cv2(cv2, jpeg_tools, tmp_path, kind):
    # every cut from a fifth of the file on: libjpeg's insufficient_data
    # (zero bits to the end of the MCU, the rest of the scan untouched),
    # the 5x5 block smoothing of an incomplete progressive image, the fake
    # EOI read by a marker segment cut short; a cut in a segment cv2
    # refuses raises; every decode past the cut warns naming the file
    how, params = _CUT[kind]
    img = fixtures.fixture_image(61, 83, seed=len(kind))
    path = tmp_path / "whole.jpg"
    if how == "tool":
        src = img if "cmyk" not in kind else np.concatenate(
            [img, img[..., 1:2] // 2], axis=2)
        jpeg_tools[0](str(path), src, *params)
    else:
        flags = []
        for k, v in params.items():
            if k == "SAMPLING_FACTOR":
                v = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{v}")
            flags += [getattr(cv2, f"IMWRITE_JPEG_{k}"), v]
        cv2.imwrite(str(path), img[..., 0] if how == "cv2_gray"
                    else img[..., ::-1], flags)
    data = path.read_bytes()
    cut = tmp_path / f"cut_{kind}.jpg"
    decoded = 0
    for n in range(len(data) // 5, len(data), max(1, len(data) // 90)):
        cut.write_bytes(data[:n])
        if _as_cv2(cv2, cut):
            decoded += 1
            with pytest.warns(RuntimeWarning, match=f"cut_{kind}.jpg"):
                read_jpeg(str(cut))
    assert decoded > 10


_ARITH = {
    "sequential": ("-arith",), "sequential_restart": ("-arith", "-restart",
                                                      "3"),
    "sequential_dac": ("-arith", "-dac", "2", "5", "12", "-restart", "7"),
    "progressive": ("-arith", "-prog"),
    "progressive_restart": ("-arith", "-prog", "-restart", "2"),
    "progressive_dac": ("-arith", "-prog", "-dac", "0", "0", "1"),
    "gray": ("-arith", "-q", "75"), "gray_progressive": ("-arith", "-prog"),
    "cmyk": ("-arith", "-space", "cmyk"),
}


@pytest.mark.parametrize("kind", list(_ARITH))
def test_arithmetic_coded_files_match_cv2(cv2, jpeg_tools, tmp_path, kind):
    # SOF9 / SOF10: jdarith.c's QM decoder, DAC conditioning, statistics
    # reset at each restart, progressive refinement scans
    for h, w in [(1, 1), (17, 9), (45, 61), (64, 100)]:
        img = fixtures.fixture_image(h, w, seed=h)
        src = img[..., 0] if kind.startswith("gray") else img
        if kind == "cmyk":
            src = np.concatenate([img, img[..., :1]], axis=2)
        path = tmp_path / f"{kind}_{h}x{w}.jpg"
        jpeg_tools[0](str(path), src, *_ARITH[kind])
        assert _as_cv2(cv2, path)


_FOUR = {"pil_cmyk_q75": 75, "pil_cmyk_q95": 95, "pil_cmyk_progressive": 90,
         "ycck": ("-space", "ycck"), "ycck_progressive": ("-space", "ycck",
                                                          "-prog"),
         "cmyk_tool": ("-space", "cmyk", "-q", "60")}


@pytest.mark.parametrize("kind", list(_FOUR))
def test_cmyk_and_ycck_match_cv2(cv2, jpeg_tools, tmp_path, kind):
    # 4 components: CMYK, YCCK (jdcolor.c ycck_cmyk_convert), then
    # OpenCV's CMYK -> BGR, k - ((255 - c) * k >> 8)
    Image = pytest.importorskip("PIL.Image")
    for h, w in [(1, 1), (17, 9), (45, 61)]:
        img = fixtures.fixture_image(h, w, seed=w)
        path = tmp_path / f"{kind}_{h}x{w}.jpg"
        if kind.startswith("pil"):
            Image.fromarray(img).convert("CMYK").save(
                str(path), quality=_FOUR[kind],
                progressive=kind.endswith("progressive"))
        else:
            jpeg_tools[0](str(path), np.concatenate(
                [img, 255 - img[..., 2:]], axis=2), *_FOUR[kind])
        assert _as_cv2(cv2, path)


_LOSSLESS = [(psv, pt) for psv in range(1, 8) for pt in (0, 3)]


@pytest.mark.parametrize("psv,pt", _LOSSLESS,
                         ids=[f"p{a}_pt{b}" for a, b in _LOSSLESS])
def test_lossless_files_match_cv2(cv2, jpeg_tools, tmp_path, psv, pt):
    # SOF3: predictors 1-7, the point transform, restarts every 4 rows
    for h, w in [(1, 1), (9, 17), (29, 38)]:
        img = fixtures.fixture_image(h, w, seed=psv)
        for opts, src in (((), img), (("-restart", str(4 * w)), img),
                          ((), np.concatenate([img, img[..., :1]], 2))):
            path = tmp_path / f"l{h}x{w}_{len(opts)}_{src.shape[2]}.jpg"
            jpeg_tools[1](str(path), src, "-lossless", str(psv), str(pt),
                          *opts)
            assert _as_cv2(cv2, path)


@pytest.mark.parametrize("kind", ["12-bit", "hierarchical", "2-component",
                                  "lossless_gray", "lossless_ycc"])
def test_kinds_cv2_refuses_raise_naming_the_file(cv2, jpeg_tools, tmp_path,
                                                 kind):
    img = fixtures.fixture_image(29, 38, seed=3)
    path = tmp_path / f"refused_{kind}.jpg"
    if kind == "12-bit":
        jpeg_tools[1](str(path), img.astype(np.uint16) * 16, "-prec", "12")
    elif kind == "hierarchical":
        cv2.imwrite(str(path), img)
        data = path.read_bytes()
        sof = data.index(b"\xff\xc0")
        path.write_bytes(data[:sof] + b"\xff\xc5" + data[sof + 2:])
    elif kind == "2-component":
        jpeg_tools[0](str(path), img[..., :2])
    elif kind == "lossless_gray":
        jpeg_tools[1](str(path), img[..., 0], "-lossless", "1", "0")
    else:           # an RGB lossless file relabelled YCbCr (Adobe transform 1)
        jpeg_tools[1](str(path), img, "-lossless", "1", "0")
        data = bytearray(path.read_bytes())
        at = data.index(b"Adobe")
        data[at + 11] = 1
        path.write_bytes(bytes(data))
    assert cv2.imread(str(path)) is None
    match = {"12-bit": "12-bit", "hierarchical": "hierarchical",
             "2-component": "2-component", "lossless_gray": "lossless",
             "lossless_ycc": "lossless"}[kind]
    with pytest.raises(ValueError, match=f"refused_{kind}.jpg.*{match}"):
        read_jpeg(str(path))


@pytest.mark.parametrize("case", [c for c in _DECODE if "progressive" in c[0]]
                         + [("progressive_q30", (45, 61), "smooth",
                             {"PROGRESSIVE": 1, "QUALITY": 30}, False)],
                         ids=lambda c: c[0])
def test_complete_progressive_decodes_as_before(cv2, tmp_path, case):
    # block smoothing runs only where a coefficient is incomplete: a whole
    # progressive file decodes as before, without a warning
    import warnings

    name, (h, w), kind, params, gray = case
    img = _image(h, w, kind, seed=len(name))
    flags = []
    for k, v in params.items():
        if k == "SAMPLING_FACTOR":
            v = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{v}")
        flags += [getattr(cv2, f"IMWRITE_JPEG_{k}"), v]
    path = str(tmp_path / f"{name}.jpg")
    cv2.imwrite(path, img[..., 0] if gray else img[..., ::-1], flags)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = read_jpeg(path)
    np.testing.assert_array_equal(got, cv2.imread(path)[..., ::-1])
