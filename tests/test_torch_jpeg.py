"""The port's JPEG codec (``csrc/jpeg_codec.cpp`` through
``utils/image_io.read_jpeg`` / ``write_jpeg``) against cv2, the JAX
package's reader and writer: decodes bit for bit, encodes byte for byte.

The cv2 tests take cv2 with ``pytest.importorskip`` (PIL for EXIF);
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
    img = _image(45, 61, "noise")
    path = tmp_path / f"broken_{kind}.jpg"
    if kind == "cmyk":
        Image = pytest.importorskip("PIL.Image")
        Image.fromarray(img).convert("CMYK").save(str(path))
        match = "CMYK"
    elif kind == "progressive_cut":
        cv2.imwrite(str(path), img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
        data = path.read_bytes()
        scans = [i for i in range(len(data) - 1)
                 if data[i:i + 2] == b"\xff\xda"]
        path.write_bytes(data[:scans[3]] + b"\xff\xd9")   # 3 of its scans
        match = "incomplete progressive"
    elif kind == "not_jpeg":
        path.write_bytes(b"GIF89a")
        match = "not a JPEG"
    else:
        cv2.imwrite(str(path), img)
        path.write_bytes(_corrupt(path.read_bytes(), kind))
        match = {"truncated": "truncated", "arithmetic": "arithmetic",
                 "lossless": "lossless", "12-bit": "12-bit"}[kind]
    with pytest.raises(ValueError, match=f"broken_{kind}.jpg.*{match}"):
        read_jpeg(str(path))


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
    (tmp_path / "photo.tif").write_bytes(b"II*\x00")
    with pytest.raises(RuntimeError, match="photo.tif.*not a PNG or JPEG"):
        read_image(str(tmp_path / "photo.tif"))
