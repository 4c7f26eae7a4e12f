"""The port's WebP codec (``utils/image_io.read_webp`` / ``write_webp`` over
``csrc/webp_codec.cpp``) against cv2, the JAX package's reader: lossless
files from cv2 and PIL (every method, palettes of 2-256 colours, alpha,
near-lossless), lossy files from a C writer over the system libwebp (every
partition count, segment count, filter type and sharpness, no filter, SNS,
sharp YUV, each alpha compression and filter), extended files (EXIF
orientations, ICC, XMP), animations (the first frame on its canvas), and
files cut short or corrupted: every decode equals ``cv2.imread``'s bit for
bit (and the alpha plane ``IMREAD_UNCHANGED``'s), and where cv2 returns
None the port raises ``RuntimeError`` naming the file.  The writer's files
read back as their input through cv2 and the port.

cv2 comes in through ``pytest.importorskip`` inside a fixture; the C writer
is ``tests/torch_make_image_fixtures._webp_tool`` (gcc, ``-lwebp``),
skipped where it does not build.  The committed fixtures are checked
without cv2 in ``test_torch_image_formats.py::test_committed_fixture`` and
here with cv2 and PIL made unimportable.
"""

import hashlib
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_image, read_webp, \
    write_webp

import torch_make_image_fixtures as fx

H, W = 21, 35                         # odd: partial macroblocks and pairs


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    mod = pytest.importorskip("cv2")
    mod.utils.logging.setLogLevel(mod.utils.logging.LOG_LEVEL_SILENT)
    return mod


@pytest.fixture(scope="module")
def webpw(tmp_path_factory):
    try:
        return fx._webp_tool(str(tmp_path_factory.mktemp("webpw")))
    except (OSError, subprocess.CalledProcessError) as err:
        pytest.skip(f"no C writer over libwebp: {err}")


def _images(h=H, w=W, seed=0):
    """A smooth view, noise, and RGBA versions of both (an alpha ramp, a
    fully transparent band)."""
    rng = np.random.default_rng(seed)
    smooth = fx.fixture_image(h, w, seed=seed)
    noise = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    alpha = rng.integers(0, 256, (h, w, 1)).astype(np.uint8)
    alpha[:h // 3] = 255
    alpha[h // 3:h // 2] = 0
    return smooth, noise, np.concatenate([smooth, alpha], 2), \
        np.concatenate([noise, alpha], 2)


def _same_as_cv2(cv2, path, check_alpha=True):
    """The port's decode against cv2's (and its alpha plane against
    ``IMREAD_UNCHANGED``'s, which ignores EXIF orientation: ``check_alpha``
    False where a file carries one): equal bit for bit → True; cv2 gives
    None and the port raises ``RuntimeError`` naming the file → False."""
    path = str(path)
    try:
        want = cv2.imread(path)
    except cv2.error:                 # a canvas past cv2's size limits
        want = None
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(path)):
            read_webp(path)
        return False
    got, alpha = image_io._decode_webp_file(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    np.testing.assert_array_equal(read_image(path), got)
    if check_alpha:
        full = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if full.ndim == 3 and full.shape[2] == 4:
            assert alpha is not None
            np.testing.assert_array_equal(alpha, full[..., 3])
    return True


# -------------------------------------------------------------- lossless


@pytest.mark.parametrize("method", range(7))
def test_lossless_methods_match_cv2(cv2, tmp_path, method):
    # PIL (libwebp 1.6) at several qualities, RGB and RGBA (exact and not)
    Image = pytest.importorskip("PIL.Image")
    for size in [(1, 1), (1, 19), (19, 1), (17, 33)]:
        smooth, noise, rgba, _ = _images(*size, seed=method)
        for q in (0, 60, 100):
            for i, arr in enumerate((smooth, noise)):
                path = tmp_path / f"m_q{q}_{i}_{size[0]}x{size[1]}.webp"
                Image.fromarray(arr).save(path, lossless=True, method=method,
                                          quality=q)
                assert _same_as_cv2(cv2, path)
            path = tmp_path / f"rgba_{q}.webp"
            Image.fromarray(rgba, "RGBA").save(path, lossless=True,
                                               method=method, quality=q,
                                               exact=bool(q % 2))
            assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("quality", [1, 50, 100])
def test_lossless_written_by_cv2(cv2, tmp_path, quality):
    # cv2.imwrite's default .webp is lossless; IMWRITE_WEBP_QUALITY 100 too
    for size in [(1, 1), (7, 300), (40, 51)]:
        for i, arr in enumerate(_images(*size, seed=quality)[:2]):
            path = tmp_path / f"cv2_{i}_{size[0]}x{size[1]}.webp"
            assert cv2.imwrite(str(path), arr[..., ::-1])
            assert _same_as_cv2(cv2, path)
            if quality == 100:
                assert cv2.imwrite(str(path), arr[..., ::-1],
                                   [cv2.IMWRITE_WEBP_QUALITY, 100])
                assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 256])
def test_lossless_palettes_match_cv2(cv2, tmp_path, webpw, colours):
    # the color-indexing transform, pixels bundled 8, 4 or 2 to a byte
    # below 17 colours
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4)).astype(np.uint8)
    for size in [(1, 1), (3, 29), (17, 33)]:
        idx = rng.integers(0, colours, size)
        for method in (0, 4, 6):
            path = tmp_path / f"pal_{method}_{size[0]}x{size[1]}.webp"
            webpw(path, pal[idx][..., :3], "lossless", 1, "method", method)
            assert _same_as_cv2(cv2, path)
        path = tmp_path / f"pal_rgba_{size[0]}x{size[1]}.webp"
        webpw(path, pal[idx], "lossless", 1, "exact", 1)
        assert _same_as_cv2(cv2, path)
        path = tmp_path / f"pal_pil_{size[0]}x{size[1]}.webp"
        Image.fromarray(pal[idx][..., :3]).save(path, lossless=True)
        assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("level", [0, 20, 60, 100])
def test_near_lossless_matches_cv2(cv2, tmp_path, webpw, level):
    for i, arr in enumerate(_images(seed=level)):
        path = tmp_path / f"near_{i}.webp"
        webpw(path, arr, "lossless", 1, "near_lossless", level, "exact",
              i % 2)
        assert _same_as_cv2(cv2, path)


# ----------------------------------------------------------------- lossy


_LOSSY = {
    "default": [],
    "partitions1": ["partitions", 1],
    "partitions2": ["partitions", 2, "segments", 2],
    "partitions3": ["partitions", 3, "segments", 3],
    "segments1": ["segments", 1],
    "segments4_sns100": ["segments", 4, "sns_strength", 100],
    "sns0": ["sns_strength", 0],
    "simple_filter": ["filter_type", 0, "filter_strength", 60],
    "strong_filter": ["filter_type", 1, "filter_strength", 100],
    "no_filter": ["filter_strength", 0],
    "autofilter": ["autofilter", 1],
    "sharp_yuv": ["use_sharp_yuv", 1],
    "method0": ["method", 0],
    "method6_pass4": ["method", 6, "pass", 4],
    "preprocessing": ["preprocessing", 2, "segments", 4],
    **{f"sharpness{s}": ["filter_sharpness", s, "filter_strength", 50,
                         "filter_type", s % 2] for s in range(8)},
}


@pytest.mark.parametrize("kind", list(_LOSSY))
def test_lossy_options_match_cv2(cv2, tmp_path, webpw, kind):
    for size in [(1, 1), (9, 1), (1, 23), (H, W), (48, 64), (37, 85)]:
        for i, arr in enumerate(_images(*size, seed=len(kind))[:2]):
            for q in (2, 50, 90, 100):
                path = tmp_path / f"{kind}_{i}_{q}_{size[0]}x{size[1]}.webp"
                webpw(path, arr, "quality", q, *_LOSSY[kind])
                assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("compression", [0, 1])
@pytest.mark.parametrize("filtering", [0, 1, 2])
def test_lossy_alpha_matches_cv2(cv2, tmp_path, webpw, compression,
                                 filtering):
    # an ALPH chunk, raw or VP8L-compressed, each filter libwebp picks;
    # cv2 drops the alpha without blending it in
    for size in [(1, 1), (H, W), (33, 47)]:
        for i, arr in enumerate(_images(*size, seed=filtering)[2:]):
            for aq in (100, 40):
                path = tmp_path / f"a_{i}_{aq}_{size[0]}x{size[1]}.webp"
                webpw(path, arr, "quality", 75, "alpha_compression",
                      compression, "alpha_filtering", filtering,
                      "alpha_quality", aq, "method", 3 + i)
                assert _same_as_cv2(cv2, path)


@pytest.mark.parametrize("filter_bits", range(4))
def test_alph_filters_by_hand_match_cv2(cv2, tmp_path, webpw, filter_bits):
    # a raw ALPH chunk under each filter (none, horizontal, vertical,
    # gradient), and a VP8L one of the same plane
    smooth, _, rgba, _ = _images(seed=filter_bits)
    webpw(tmp_path / "lossy.webp", smooth, "quality", 80)
    vp8 = fx.webp_chunks((tmp_path / "lossy.webp").read_bytes())[0][1]
    webpw(tmp_path / "ll.webp", np.repeat(rgba[..., 3:], 3, axis=2),
          "lossless", 1)
    vp8l = fx.webp_chunks((tmp_path / "ll.webp").read_bytes())[0][1]
    for name, alph in (("raw", bytes([filter_bits << 2])
                        + rgba[..., 3].tobytes()),
                       ("vp8l", bytes([1 | filter_bits << 2]) + vp8l[5:])):
        path = tmp_path / f"{name}.webp"
        path.write_bytes(fx.webp_riff(
            fx.webp_vp8x(0x10, W, H) + fx.webp_chunk(b"ALPH", alph)
            + fx.webp_chunk(b"VP8 ", vp8)))
        assert _same_as_cv2(cv2, path)


def test_lossy_written_by_cv2_and_pil(cv2, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    for size in [(1, 1), (16, 16), (31, 45)]:
        smooth, noise, rgba, _ = _images(*size)
        for q in (1, 50, 90, 100):
            path = tmp_path / f"cv2_{q}.webp"
            assert cv2.imwrite(str(path), smooth[..., ::-1],
                               [cv2.IMWRITE_WEBP_QUALITY, q])
            assert _same_as_cv2(cv2, path)
            path = tmp_path / f"pil_{q}.webp"
            Image.fromarray(rgba, "RGBA").save(path, quality=q)
            assert _same_as_cv2(cv2, path)


# -------------------------------------------------------------- extended


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_matches_cv2(cv2, tmp_path, webpw, orientation):
    # cv2 applies the first EXIF chunk's orientation, under the VP8X EXIF
    # flag, little- or big-endian, before or after the image
    smooth, _, rgba, _ = _images(20, 30, seed=orientation)
    webpw(tmp_path / "l.webp", smooth, "quality", 85)
    vp8 = fx.webp_chunks((tmp_path / "l.webp").read_bytes())[0][1]
    webpw(tmp_path / "ll.webp", rgba, "lossless", 1)
    vp8l = fx.webp_chunks((tmp_path / "ll.webp").read_bytes())[0][1]
    exif = fx.webp_chunk(b"EXIF", fx.webp_exif(orientation))
    exif_mm = fx.webp_chunk(b"EXIF", fx.webp_exif(orientation, ">"))
    image = fx.webp_chunk(b"VP8 ", vp8)
    files = {
        "after": fx.webp_vp8x(0x08, 30, 20) + image + exif,
        "before_mm": fx.webp_vp8x(0x08, 30, 20) + exif_mm + image,
        "lossless": fx.webp_vp8x(0x18, 30, 20)
        + fx.webp_chunk(b"VP8L", vp8l) + exif,
        "no_flag": fx.webp_vp8x(0x00, 30, 20) + image + exif,
        "with_icc_xmp": fx.webp_vp8x(0x2C, 30, 20)
        + fx.webp_chunk(b"ICCP", bytes(range(97))) + image + exif
        + fx.webp_chunk(b"XMP ", b"<x:xmpmeta/>"),
        "two_exif": fx.webp_vp8x(0x08, 30, 20) + image + exif
        + fx.webp_chunk(b"EXIF", fx.webp_exif(9 - orientation)),
        "exif_prefix": fx.webp_vp8x(0x08, 30, 20) + image
        + fx.webp_chunk(b"EXIF", b"Exif\x00\x00" + fx.webp_exif(orientation)),
    }
    for name, body in files.items():
        path = tmp_path / f"{name}.webp"
        path.write_bytes(fx.webp_riff(body))
        assert _same_as_cv2(cv2, path, check_alpha=False)
        rotated = read_webp(str(path)).shape[:2] == (30, 20)
        assert rotated == (orientation > 4 and name not in (
            "no_flag", "exif_prefix")), name


@pytest.mark.parametrize("case", list(fx.exif_edge_cases()))
def test_exif_reader_edge_cases_match_cv2(cv2, tmp_path, case):
    payload, orientation = fx.exif_edge_cases()[case]
    vp8 = fx.webp_chunks(open(os.path.join(fx.FOLDER, "webp_lossy.webp"),
                              "rb").read())[0][1]
    path = tmp_path / "exif.webp"
    path.write_bytes(fx.webp_riff(fx.webp_vp8x(0x08, fx.W, fx.H)
                                  + fx.webp_chunk(b"VP8 ", vp8)
                                  + fx.webp_chunk(b"EXIF", payload)))
    assert _same_as_cv2(cv2, path, check_alpha=False)
    assert read_webp(str(path)).shape[:2] == (
        (fx.W, fx.H) if orientation > 4 else (fx.H, fx.W))


def test_exif_ignored_where_the_demuxer_fails(cv2, tmp_path, webpw):
    # cv2 reads EXIF through WebPDemux, which refuses some files that
    # WebPDecode decodes (an ALPH before a VP8L chunk, a second image, a
    # chunk past the RIFF after the image): the image then keeps its
    # stored orientation
    smooth, _, rgba, _ = _images(20, 30)
    webpw(tmp_path / "l.webp", smooth, "quality", 85)
    vp8 = fx.webp_chunks((tmp_path / "l.webp").read_bytes())[0][1]
    webpw(tmp_path / "ll.webp", rgba, "lossless", 1)
    vp8l = fx.webp_chunks((tmp_path / "ll.webp").read_bytes())[0][1]
    exif = fx.webp_chunk(b"EXIF", fx.webp_exif(6))
    bodies = [
        fx.webp_vp8x(0x18, 30, 20) + fx.webp_chunk(b"ALPH", b"\x00" + bytes(
            600)) + fx.webp_chunk(b"VP8L", vp8l) + exif,
        fx.webp_vp8x(0x08, 30, 20) + fx.webp_chunk(b"VP8 ", vp8) + exif
        + fx.webp_chunk(b"VP8 ", vp8),
    ]
    for i, body in enumerate(bodies):
        path = tmp_path / f"f{i}.webp"
        path.write_bytes(fx.webp_riff(body))
        assert _same_as_cv2(cv2, path)
        assert read_webp(str(path)).shape[:2] == (20, 30)
    path = tmp_path / "junk.webp"
    path.write_bytes(fx.webp_riff(fx.webp_vp8x(0x08, 30, 20) + fx.webp_chunk(
        b"VP8 ", vp8) + exif + b"JUNK\xff\xff\xff\x00"))
    assert _same_as_cv2(cv2, path)


def test_animation_first_frame_matches_cv2(cv2, tmp_path, webpw):
    # WebPAnimDecoder's first frame: the frame decoded into a transparent
    # black canvas at its offset (no blending), alpha dropped; the ANMF
    # size field is not used, the bitstream's is; EXIF applies to the
    # canvas
    small, _, small_a, _ = _images(8, 12, seed=3)
    webpw(tmp_path / "s.webp", small, "quality", 90)
    webpw(tmp_path / "sa.webp", small_a, "quality", 90)
    webpw(tmp_path / "sl.webp", small_a, "lossless", 1)
    big = fx.fixture_image(20, 30, seed=4)
    webpw(tmp_path / "b.webp", big, "quality", 90)
    frame = {k: b"".join(fx.webp_chunk(t, v) for t, v in fx.webp_chunks(
        (tmp_path / f"{k}.webp").read_bytes()) if t != b"VP8X")
        for k in ("s", "sa", "sl", "b")}
    cases = {
        "offset": [fx.webp_anmf(6, 4, 12, 8, frame["s"]),
                   fx.webp_anmf(0, 0, 30, 20, frame["b"])],
        "alpha": [fx.webp_anmf(18, 12, 12, 8, frame["sa"], flags=3)],
        "lossless": [fx.webp_anmf(2, 2, 12, 8, frame["sl"])],
        "full": [fx.webp_anmf(0, 0, 30, 20, frame["b"]),
                 fx.webp_anmf(4, 4, 12, 8, frame["s"])],
        "header_size_ignored": [fx.webp_anmf(6, 4, 3, 3, frame["s"])],
        "outside": [fx.webp_anmf(20, 14, 12, 8, frame["s"])],
        "bad_second": [fx.webp_anmf(6, 4, 12, 8, frame["s"]),
                       fx.webp_anmf(0, 0, 30, 20, fx.webp_chunk(
                           b"VP8 ", bytes(20)))],
    }
    for name, frames in cases.items():
        for flags in (0x02, 0x12):
            path = tmp_path / f"{name}_{flags}.webp"
            path.write_bytes(fx.webp_anim(30, 20, frames, flags))
            read = _same_as_cv2(cv2, path)
            assert read == (name not in ("outside", "bad_second")), name
    path = tmp_path / "exif.webp"
    path.write_bytes(fx.webp_anim(30, 20, cases["offset"] + [fx.webp_chunk(
        b"EXIF", fx.webp_exif(8))], 0x0A))
    assert _same_as_cv2(cv2, path, check_alpha=False)
    assert read_webp(str(path)).shape[:2] == (30, 20)
    img = read_webp(str(tmp_path / "offset_2.webp"))
    assert not img[:4].any() and not img[:, :6].any()
    # an animation flag over a still image, ANMF without the flag, no ANIM
    for i, body in enumerate([
            fx.webp_vp8x(0x02, 30, 20) + frame["b"],
            fx.webp_vp8x(0x00, 30, 20) + fx.webp_chunk(b"ANIM", bytes(6))
            + cases["full"][0],
            fx.webp_vp8x(0x02, 30, 20) + cases["full"][0]]):
        path = tmp_path / f"refused_{i}.webp"
        path.write_bytes(fx.webp_riff(body))
        assert not _same_as_cv2(cv2, path)


# -------------------------------------------------------------- refusals


def _kinds(tmp_path, webpw):
    """One file of each kind: lossy, lossy noise (large coefficients: a
    corrupt token there can overflow 16 bits in the inverse DCT, which
    libwebp's SSE2 path wraps), lossless, lossy + ALPH (VP8L), extended
    with EXIF, animated."""
    smooth, _, rgba, _ = _images(seed=9)
    out = {}
    webpw(tmp_path / "lossy.webp", smooth, "quality", 80, "partitions", 2)
    webpw(tmp_path / "lossy_noise.webp", _images(64, 64, seed=9)[1],
          "quality", 50)
    webpw(tmp_path / "lossless.webp", rgba, "lossless", 1)
    webpw(tmp_path / "alpha.webp", rgba, "quality", 80, "alpha_compression",
          1)
    for k in ("lossy", "lossy_noise", "lossless", "alpha"):
        out[k] = (tmp_path / f"{k}.webp").read_bytes()
    vp8 = fx.webp_chunks(out["lossy"])[0][1]
    out["exif"] = fx.webp_riff(fx.webp_vp8x(0x08, W, H) + fx.webp_chunk(
        b"VP8 ", vp8) + fx.webp_chunk(b"EXIF", fx.webp_exif(6)))
    out["animated"] = fx.webp_anim(W + 4, H + 2, [fx.webp_anmf(
        2, 2, W, H, b"".join(fx.webp_chunk(t, v) for t, v in fx.webp_chunks(
            out["alpha"]) if t != b"VP8X"))], 0x12)
    return out


@pytest.mark.parametrize("kind", ["lossy", "lossless", "alpha", "exif",
                                  "animated"])
def test_cut_files_raise_where_cv2_fails(cv2, tmp_path, webpw, kind):
    # a file cut anywhere (its RIFF size then runs past the data), and each
    # bitstream chunk cut with the chunk and RIFF sizes made consistent
    data = _kinds(tmp_path, webpw)[kind]
    path = tmp_path / "cut.webp"
    for cut in list(range(0, len(data), max(1, len(data) // 40))) + [
            len(data) - 1]:
        path.write_bytes(data[:cut])
        assert not _same_as_cv2(cv2, path)
    chunks = fx.webp_chunks(data)
    for i, (tag, payload) in enumerate(chunks):
        if tag not in (b"VP8 ", b"VP8L", b"ALPH"):
            continue
        for frac in (0.05, 0.3, 0.6, 0.9, 0.99):
            m = int(len(payload) * frac)
            path.write_bytes(fx.webp_riff(b"".join(
                fx.webp_chunk(t, v[:m] if j == i else v)
                for j, (t, v) in enumerate(chunks))))
            _same_as_cv2(cv2, path)


@pytest.mark.parametrize("kind", ["lossy", "lossy_noise", "lossless",
                                  "alpha", "exif", "animated"])
def test_corrupt_files_match_cv2(cv2, tmp_path, webpw, kind):
    # bytes of each chunk flipped, chunk sizes and the RIFF size changed:
    # wherever cv2 decodes, the same pixels; wherever it fails, a
    # RuntimeError naming the file
    data = _kinds(tmp_path, webpw)[kind]
    rng = np.random.default_rng(len(kind))
    path = tmp_path / "bad.webp"
    decoded = 0
    for _ in range(120):
        bad = bytearray(data)
        pos = int(rng.integers(12, len(bad)))
        bad[pos] ^= int(rng.integers(1, 256))
        path.write_bytes(bytes(bad))
        decoded += _same_as_cv2(cv2, path)
    sizes = [4] + [i + 4 for tag in (b"VP8 ", b"VP8L", b"VP8X", b"ALPH",
                                     b"EXIF", b"ANIM", b"ANMF")
                   for i in range(len(data) - 8) if data[i:i + 4] == tag]
    for pos in sizes:                                   # the size fields
        for delta in (-9, -1, 1, 2, 1 << 20):
            bad = bytearray(data)
            bad[pos:pos + 4] = ((int.from_bytes(data[pos:pos + 4], "little")
                                 + delta) & 0xFFFFFFFF).to_bytes(4, "little")
            path.write_bytes(bytes(bad))
            _same_as_cv2(cv2, path)
    assert decoded > 0


def test_short_files_raise_as_cv2(cv2, tmp_path):
    # cv2 reads a 32-byte header first: a valid 28-byte file is refused,
    # the same file padded to 32 bytes decodes
    bits = [(0x2F, 8), (0, 14), (0, 14), (0, 1), (0, 3), (0, 1), (0, 1),
            (0, 1)] + [(1, 1), (0, 1), (0, 1), (0, 1)] * 5
    acc = n = 0
    for v, k in bits:
        acc |= v << n
        n += k
    data = fx.webp_riff(fx.webp_chunk(b"VP8L", acc.to_bytes((n + 7) // 8,
                                                            "little")))
    assert len(data) == 28
    path = tmp_path / "tiny.webp"
    path.write_bytes(data)
    assert not _same_as_cv2(cv2, path)
    path.write_bytes(data + bytes(4))
    assert _same_as_cv2(cv2, path)
    np.testing.assert_array_equal(read_webp(str(path)), np.zeros((1, 1, 3)))


# ---------------------------------------------------------------- writer


@pytest.mark.parametrize("size", [(1, 1), (1, 2), (2, 1), (1, 77), (77, 1),
                                  (17, 33), (64, 64), (120, 371)])
def test_writer_round_trips_through_cv2_and_the_port(cv2, tmp_path, size):
    # pixels, not bytes: cv2 (libwebp) and the port both read the input
    # back from a lossless VP8L file
    rng = np.random.default_rng(size[0] * 1000 + size[1])
    images = [*_images(*size, seed=size[1])[:2], np.full(size + (3,), 17),
              rng.integers(0, 3, size + (3,)) * 120,
              np.repeat(rng.integers(0, 256, size + (1,)), 3, axis=2)]
    for i, img in enumerate(images):
        img = img.astype(np.uint8)
        path = tmp_path / f"w{i}.webp"
        write_webp(str(path), img)
        data = path.read_bytes()
        assert data[12:16] == b"VP8L" and len(data) == 8 + int.from_bytes(
            data[4:8], "little")
        np.testing.assert_array_equal(cv2.imread(str(path))[..., ::-1], img)
        np.testing.assert_array_equal(read_webp(str(path)), img)
        np.testing.assert_array_equal(read_image(str(path)), img)


def test_writer_refuses_what_webp_cannot_hold(tmp_path):
    with pytest.raises(ValueError, match="write_webp"):
        write_webp(str(tmp_path / "a.webp"), np.zeros((4, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="16384"):
        write_webp(str(tmp_path / "b.webp"), np.zeros((1, 16385, 3),
                                                      np.uint8))


# ------------------------------------------------- fixtures, build, tables


def test_committed_webp_fixtures_without_cv2_or_pil(tmp_path):
    # the committed WebP files against cv2's recorded decodes (and the
    # refused ones raising), with cv2 and PIL unimportable
    with mock.patch.dict(sys.modules, {"cv2": None, "PIL": None,
                                       "PIL.Image": None}):
        got = fx.check(scratch=str(tmp_path))
    names = [n for n in fx.CASES + fx.REFUSED + fx.ROUND_TRIP
             if n.endswith(".webp")]
    assert len(names) == 24
    assert {n: got[n] for n in names} == dict.fromkeys(names, True)


def test_timing_view_matches_cv2_and_its_hash(cv2):
    path = os.path.join(fx.FOLDER, fx.TIMING_WEBP)
    assert _same_as_cv2(cv2, path)
    got = np.ascontiguousarray(read_webp(path))
    assert got.shape == (840, 1297, 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == fx.TIMING_WEBP_SHA256


def test_codec_links_no_libwebp():
    # the codec is the committed source alone: no libwebp among the
    # built library's dependencies
    from gsplat_tpu_torch.ops import cuda_build

    image_io._load_webp_codec()
    path = cuda_build.BUILD_INFO["webp_codec"]["path"]
    needed = subprocess.run(["readelf", "-d", path], capture_output=True,
                            text=True, check=True).stdout
    libs = [line.split("[")[1].split("]")[0] for line in needed.splitlines()
            if "(NEEDED)" in line]
    assert libs and not [lib for lib in libs if "webp" in lib], libs


def test_tables_are_the_system_libwebps():
    # the generated block of csrc/webp_codec.cpp is what
    # tests/torch_make_webp_tables.py reads out of libwebp.a today
    import torch_make_webp_tables as tables

    if not os.path.exists(tables.LIBWEBP):
        pytest.skip(f"no {tables.LIBWEBP}")
    with open(tables.CODEC) as f:
        src = f.read()
    assert tables.block(tables.read_tables()) in src
