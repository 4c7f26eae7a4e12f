"""The port's GIF, Radiance HDR, PFM, PAM, Sun raster and BigTIFF readers
and writers (``utils/image_io``, the LZW and run-length codecs of
``csrc/gif_hdr_codec.cpp``) against cv2 5.0.0, the JAX package's reader and
writer: every decode bit for bit ``cv2.imread(path)[..., ::-1]``, or both
refuse (cv2 returns None or raises; the port raises naming the file); every
encode byte for byte ``cv2.imwrite``'s default file.  The files come from
cv2, PIL and the byte-level writers of ``tests/torch_make_image_fixtures.py``
(every GIF table and code size, HDR scanline form, PAM tuple type and
maxval, Sun raster type and depth), cut short and corrupted.  The committed
fixtures are checked without cv2 in ``tests/test_torch_image_formats.py``.

The cv2 tests take cv2 with ``pytest.importorskip`` inside a fixture.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import gif_332, read_image, \
    write_gif, write_hdr, write_pam, write_pfm, write_sunras

import torch_make_image_fixtures as fx


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
        with pytest.raises((ValueError, RuntimeError),
                           match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


def _cuts_and_flips(cv2, path, data, seed, flips=40):
    """Every cut of ``data`` and ``flips`` random byte changes, each held to
    cv2 (equal, or both refuse)."""
    rng = np.random.default_rng(seed)
    for n in range(1, len(data)):
        _same_as_cv2(cv2, path, data[:n])
    for _ in range(flips):
        b = bytearray(data)
        for i in rng.integers(0, len(b), rng.integers(1, 4)):
            b[i] = rng.integers(0, 256)
        _same_as_cv2(cv2, path, bytes(b))


def _image(kind, h, w, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "gradient":
        y, x = np.mgrid[0:h, 0:w]
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) % 256], 2).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), (17, 200, 93), np.uint8)
    return fx.fixture_image(h, w, seed)              # "smooth"


# -------------------------------------------------------------------- GIF


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("bits", range(1, 9))
def test_gif_table_sizes_match_cv2(cv2, tmp_path, bits, interlace):
    rng = np.random.default_rng(bits)
    table = rng.integers(0, 256, (1 << bits, 3))
    idx = rng.integers(0, 1 << bits, (13, 19))
    idx[5:9] = idx[0, 0]
    data = fx.gif_file(19, 13, table, 0, fx.gif_frame(
        idx, interlace=interlace, mcs=max(bits, 2)))
    assert _same_as_cv2(cv2, tmp_path / "t.gif", data)


@pytest.mark.parametrize("mcs", range(1, 13))
def test_gif_code_sizes_match_cv2(cv2, tmp_path, mcs):
    # cv2 reads minimum code sizes 2-11 (literals past 255 aside)
    rng = np.random.default_rng(mcs)
    table = rng.integers(0, 256, (4, 3))
    idx = rng.integers(0, 4, (11, 17))
    data = fx.gif_file(17, 11, table, 2, fx.gif_frame(
        idx, codes=fx.gif_codes(idx, mcs), mcs=mcs))
    assert _same_as_cv2(cv2, tmp_path / "t.gif", data) == (2 <= mcs <= 11)


@pytest.mark.parametrize("disposal", range(4))
def test_gif_transparency_and_screen_match_cv2(cv2, tmp_path, disposal):
    # a frame inside the screen, its transparent index showing the screen's
    # background colour; a second frame cv2 does not read
    rng = np.random.default_rng(disposal)
    table = rng.integers(0, 256, (8, 3))
    idx = rng.integers(0, 8, (9, 12))
    body = fx.gif_gce(disposal, 3) + fx.gif_frame(idx, left=3, top=2, mcs=3) \
        + fx.gif_gce(0) + fx.gif_frame(idx[::-1], mcs=3)
    assert _same_as_cv2(cv2, tmp_path / "t.gif", fx.gif_file(
        17, 14, table, 5, body))
    got = read_image(str(tmp_path / "t.gif"))
    assert (got[0, 0] == table[5]).all()
    hole = np.argwhere(idx == 3)[0]
    assert (got[2 + hole[0], 3 + hole[1]] == table[5]).all()


def test_gif_pil_files_match_cv2(cv2, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    img = fx.fixture_image(21, 30, seed=3)
    Image.fromarray(img).convert("P").save(str(tmp_path / "a.gif"))
    Image.fromarray(img).convert("P").save(str(tmp_path / "b.gif"),
                                           interlace=True)
    frames = [Image.fromarray(np.roll(img, 7 * k, 0)).convert("P")
              for k in range(3)]
    frames[0].save(str(tmp_path / "c.gif"), save_all=True,
                   append_images=frames[1:], duration=50, loop=0,
                   disposal=2, transparency=0)
    for name in ("a.gif", "b.gif", "c.gif"):
        assert _same_as_cv2(cv2, tmp_path / name)


def test_gif_lzw_edge_cases_match_cv2(cv2, tmp_path):
    # a full table without a clear, the end code read as a clear, data
    # split into 1-byte blocks, a literal after the full frame in the
    # block's last byte, too few and too many indexes, a code past the table
    rng = np.random.default_rng(4)
    table = rng.integers(0, 256, (256, 3))
    noise = rng.integers(0, 256, (66, 68))
    cases = {
        "deferred": (fx.gif_codes(noise, 8, clear_when_full=False), True),
        "cleared": (fx.gif_codes(noise, 8), True),
        "no_end": (fx.gif_codes(noise, 8, end=False), True),
        "short": (fx.gif_codes(noise.reshape(-1)[:-1], 8), False),
        "long": (fx.gif_codes(np.concatenate([noise.reshape(-1), [1, 2]]),
                              8), False),
        "past_table": ([(256, 9), (1, 9), (300, 9)]
                       + fx.gif_codes(noise, 8)[1:], False),
    }
    for name, (codes, ok) in cases.items():
        for block in (255, 1):
            data = fx.gif_file(68, 66, table, 0, fx.gif_frame(
                noise, codes=codes, block=block))
            assert _same_as_cv2(cv2, tmp_path / f"{name}.gif", data) == ok, \
                name
    flat = noise.reshape(-1)
    first = fx.gif_codes(flat[:1000], 8)
    codes = first[:-1] + [(257, first[-1][1])] + fx.gif_codes(flat[1000:], 8)
    assert _same_as_cv2(cv2, tmp_path / "end.gif", fx.gif_file(
        68, 66, table, 0, fx.gif_frame(noise, codes=codes)))


def test_gif_cut_and_corrupted_files_match_cv2(cv2, tmp_path):
    rng = np.random.default_rng(5)
    table = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (7, 9))
    data = fx.gif_file(11, 9, table, 2, fx.gif_gce(1, 4) + b"\x21\xfe"
                       + fx.gif_sub_blocks(b"hi") + fx.gif_frame(
                           idx, left=1, top=1, mcs=4))
    _cuts_and_flips(cv2, tmp_path / "t.gif", data, seed=6, flips=120)


# ----------------------------------------------------------- Radiance HDR


@pytest.mark.parametrize("w", [1, 7, 8, 9, 130, 32767, 32768])
def test_hdr_cv2_files_match(cv2, tmp_path, w):
    img = _image("smooth" if w < 200 else "gradient", 3, w, seed=w)
    assert cv2.imwrite(str(tmp_path / "t.hdr"), img[..., ::-1])
    assert _same_as_cv2(cv2, tmp_path / "t.hdr")


def test_hdr_values_and_headers_match_cv2(cv2, tmp_path):
    # exponents 0 (black), past 255 and past 2^31 (cv2's conversion gives
    # 0 there), the #?RGBE magic with other header lines, a line over
    # 127 bytes, flat pixels at widths run-length coding allows, run-length
    # scanlines followed by flat ones
    rng = np.random.default_rng(7)
    rgbe = rng.integers(0, 256, (5, 12, 4)).astype(np.uint8)
    rgbe[:, :6] = rgbe[:, :1]
    rgbe[0, :4, 3] = (0, 137, 150, 250)
    head = b"#?RGBE\nGAMMA=1\n" + b"Y" * 300 + b"\nFORMAT=32-bit_rle_rgbe\n\n"
    files = [fx.hdr_file(rgbe), fx.hdr_file(rgbe, head),
             fx.hdr_file(rgbe, flat=True),
             fx.hdr_file(rgbe, size=b"-Y\t5 +X  12 more\n"),
             fx.hdr_file(rgbe[:2]).replace(b"-Y 2", b"-Y 5")
             + rgbe[2:].tobytes()]
    for i, data in enumerate(files):
        assert _same_as_cv2(cv2, tmp_path / f"{i}.hdr", data)
    refused = [fx.hdr_file(rgbe, size=b"+Y 5 +X 12\n"),
               fx.hdr_file(rgbe, size=b"-Y 5 -X 12\n"),
               fx.hdr_file(rgbe, b"#?RADIANCE\n\nFORMAT=32-bit_rle_rgbe\n\n"),
               fx.hdr_file(rgbe, b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\nX\n"),
               fx.hdr_file(rgbe, size=b"-Y 0 +X 12\n")]
    for i, data in enumerate(refused):
        assert not _same_as_cv2(cv2, tmp_path / f"r{i}.hdr", data)


def test_hdr_cut_and_corrupted_files_match_cv2(cv2, tmp_path):
    rng = np.random.default_rng(8)
    rgbe = rng.integers(0, 256, (3, 9, 4)).astype(np.uint8)
    rgbe[:, 2:8] = rgbe[:, 2:3]
    _cuts_and_flips(cv2, tmp_path / "t.hdr", fx.hdr_file(rgbe), seed=9,
                    flips=120)


# -------------------------------------------------------------------- PFM


@pytest.mark.parametrize("scale", ["-1", "1", "-2.5", "0.25", "-1e0", "0",
                                   "nan"])
def test_pfm_scales_and_byte_orders_match_cv2(cv2, tmp_path, scale):
    vals = np.array([0.5, 1.5, 2.5, -0.5, np.nan, np.inf, -np.inf, 254.5,
                     255.5, 1e10, 2.1e9, 127.5, 63.75], np.float32)
    px = np.stack([vals, vals[::-1], np.roll(vals, 5)], 1)[None]
    px = np.concatenate([px, px * 3], 0)
    order = ">f4" if scale[0] != "-" else "<f4"
    data = f"PF\n{px.shape[1]} 2\n{scale}\n".encode() + \
        px.astype(order).tobytes()
    assert _same_as_cv2(cv2, tmp_path / "t.pfm", data) == (scale not in (
        "0", "nan"))


def test_pfm_headers_match_cv2(cv2, tmp_path):
    px = np.arange(18, dtype="<f4").tobytes()
    heads = [b"PF\n3 2\n-1\n", b"PF\n3\t2\v-1\r", b"PF\n3x 2 -1\n",
             b"PF\n0x3 2 -1\n", b"PF\n 3 2 -1\n", b"PF\n3 2\n-1\n\n",
             b"Pf\n3 2\n-1\n", b"PF 3 2 -1\n", b"PF\r\n3 2\n-1\n",
             b"PF\n3 2\n-1.5e-0x\n", b"PF\n3 2\n\xe9\n"]
    read = [_same_as_cv2(cv2, tmp_path / f"{i}.pfm", h + px)
            for i, h in enumerate(heads)]
    assert read[0] and read[1] and not read[6]


def test_pfm_cut_and_corrupted_files_match_cv2(cv2, tmp_path):
    data = b"PF\n2 2\n-1\n" + np.linspace(-20, 300, 12).astype(
        "<f4").tobytes()
    _cuts_and_flips(cv2, tmp_path / "t.pfm", data, seed=10)


# -------------------------------------------------------------------- PAM


@pytest.mark.parametrize("tupltype,depth", [
    ("BLACKANDWHITE", 1), ("GRAYSCALE", 1), ("GRAYSCALE_ALPHA", 2),
    ("RGB", 3), ("RGB_ALPHA", 4), (None, 1), (None, 2), (None, 3),
    (None, 4)])
@pytest.mark.parametrize("maxval", [1, 100, 255, 256, 65535])
def test_pam_tuple_types_and_maxvals_match_cv2(cv2, tmp_path, tupltype,
                                                depth, maxval):
    rng = np.random.default_rng(depth * 7 + maxval)
    for width in (1, 9):
        samples = rng.integers(0, maxval + 1, (3, width, depth))
        path = tmp_path / f"t{width}.pam"
        path.write_bytes(fx.pam_file(width, 3, depth, maxval, samples,
                                     tupltype))
        want = _cv2_read(cv2, path)
        if want is not None and depth in (2, 4) and width > 1 and \
                maxval != 1:
            # cv2 fills only the first width / depth pixels of each row
            with pytest.raises(ValueError, match="t9.pam.*rest unset"):
                read_image(str(path))
            continue
        _same_as_cv2(cv2, path)


def test_pam_headers_match_cv2(cv2, tmp_path):
    px = bytes(range(18))
    heads = [b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
             b"P7\r#c\n\n\nMAXVAL\t255 \nDEPTH 3\nWIDTH 03\nHEIGHT 2\n"
             b"ENDHDR x\n",
             b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\r\n",
             b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE\n"
             b"ENDHDR\n",
             b"P7 WIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
             b"P7\nWIDTH +3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
             b"P7\nWIDTH 3 x\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
             b"P7\nWIDTH\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
             b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\n"
             b"TUPLTYPE GRAYSCALE\nENDHDR\n",
             b"P7\nWIDTHS 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 255\nENDHDR\n",
             b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 3\nMAXVAL 2147483647\nENDHDR\n",
             b"P7\nWIDTH 3\nHEIGHT 2\nDEPTH 5\nMAXVAL 255\nENDHDR\n",
             b"P7\nWIDTH 3\nHEIGHT 2\nMAXVAL 255\nENDHDR\n"]
    read = [_same_as_cv2(cv2, tmp_path / f"{i}.pam", h + px)
            for i, h in enumerate(heads)]
    assert read[:4] == [True] * 4 and not any(read[4:])


def test_pam_cut_and_corrupted_files_match_cv2(cv2, tmp_path):
    data = fx.pam_file(3, 2, 3, 1000, np.arange(18) * 50, "RGB")
    _cuts_and_flips(cv2, tmp_path / "t.pam", data, seed=11)


# ------------------------------------------------------------- Sun raster


@pytest.mark.parametrize("kind", range(6))
@pytest.mark.parametrize("depth", [1, 8, 24, 32])
def test_sunras_types_and_depths_match_cv2(cv2, tmp_path, kind, depth):
    # cv2 5.0.0 reads the old (0) and standard (1) types only
    rng = np.random.default_rng(kind * 40 + depth)
    w, h = 11, 4
    pitch = ((w * depth + 7) // 8 + 1) & ~1
    rows = rng.integers(0, 256, h * pitch).astype(np.uint8).tobytes()
    assert _same_as_cv2(cv2, tmp_path / "t.ras", fx.sunras_file(
        w, h, depth, rows, kind=kind)) == (kind in (0, 1))
    if depth <= 8:
        for maplen in (3, 3 << depth, (3 << depth) + 3, 10):
            cmap = rng.integers(0, 256, maplen).astype(np.uint8).tobytes()
            _same_as_cv2(cv2, tmp_path / f"m{maplen}.ras", fx.sunras_file(
                w, h, depth, rows, kind=kind, maptype=1, cmap=cmap))
        _same_as_cv2(cv2, tmp_path / "raw.ras", fx.sunras_file(
            w, h, depth, rows, kind=kind, maptype=2, cmap=bytes(6)))


def test_sunras_cut_and_corrupted_files_match_cv2(cv2, tmp_path):
    rows = bytes(range(40))
    data = fx.sunras_file(5, 2, 8, rows[:12], maptype=1,
                          cmap=bytes(range(0, 255, 9)))
    _cuts_and_flips(cv2, tmp_path / "t.ras", data, seed=12)


# ---------------------------------------------------------------- BigTIFF


_TIFFS = [n for n in fx.CASES + fx.REFUSED if n.startswith("tiff_")]


@pytest.mark.parametrize("name", _TIFFS)
@pytest.mark.parametrize("long8", [False, True])
def test_bigtiff_matches_cv2(cv2, tmp_path, name, long8):
    # each classic TIFF fixture in the BigTIFF layout: strips and tiles,
    # every compression the TIFF reader has, offsets as LONG or LONG8
    with open(os.path.join(fx.FOLDER, name), "rb") as f:
        data = fx.to_bigtiff(f.read(), long8)
    assert _same_as_cv2(cv2, tmp_path / "t.tif", data) == (
        name in fx.CASES)


def test_bigtiff_headers_match_cv2(cv2, tmp_path):
    Image = pytest.importorskip("PIL.Image")
    Image.fromarray(fx.fixture_image(12, 16)).save(str(tmp_path / "p.tif"),
                                                   big_tiff=True)
    assert (tmp_path / "p.tif").read_bytes()[:4] == b"II+\x00"
    assert _same_as_cv2(cv2, tmp_path / "p.tif")
    with open(os.path.join(fx.FOLDER, "tiff_lzw.tif"), "rb") as f:
        classic = f.read()
    for size in (4, 16):
        assert not _same_as_cv2(cv2, tmp_path / f"o{size}.tif",
                                fx.to_bigtiff(classic, offset_size=size))
    data = fx.to_bigtiff(classic)
    for n in (8, 16, len(data) // 2, len(data) - 3):
        _same_as_cv2(cv2, tmp_path / f"cut{n}.tif", data[:n])


# ---------------------------------------------------------------- writers


_WRITERS = {".gif": write_gif, ".hdr": write_hdr, ".pic": write_hdr,
            ".pfm": write_pfm, ".pam": write_pam, ".ras": write_sunras,
            ".sr": write_sunras}
_SHAPES = [("noise", 1, 1), ("noise", 5, 7), ("gradient", 17, 40),
           ("flat", 9, 33), ("smooth", 30, 47), ("noise", 2, 40000),
           ("gradient", 3, 32767)]


@pytest.mark.parametrize("ext", list(_WRITERS))
@pytest.mark.parametrize("kind,h,w", _SHAPES)
def test_writers_match_cv2_bytes(cv2, tmp_path, ext, kind, h, w):
    img = _image(kind, h, w, seed=h * w)
    # cv2 reads each Sun raster row's pad byte from past the row: give it
    # a zero after the image, the byte the port writes
    buf = np.zeros(img.size + 1, np.uint8)
    buf[:img.size] = img[..., ::-1].reshape(-1)
    assert cv2.imwrite(str(tmp_path / f"cv2{ext}"),
                       buf[:img.size].reshape(img.shape))
    _WRITERS[ext](str(tmp_path / f"port{ext}"), img)
    assert (tmp_path / f"port{ext}").read_bytes() == \
        (tmp_path / f"cv2{ext}").read_bytes()
    assert _same_as_cv2(cv2, tmp_path / f"port{ext}")


@pytest.mark.parametrize("kind,h,w,seed", [
    ("noise", 13, 29, 29), ("smooth", 45, 61, 61), ("gradient", 24, 256, 0),
    ("smooth", 840, 1297, 100)])
def test_gif_332_is_what_the_gif_reads_back(tmp_path, kind, h, w, seed):
    # the plain numpy map (anti-diagonals) against the codec's row scan; the
    # full-size view differs at 21,464 pixels where any share is summed in
    # float64 instead of float32
    img = _image(kind, h, w, seed=seed)
    write_gif(str(tmp_path / "t.gif"), img)
    np.testing.assert_array_equal(gif_332(img),
                                  read_image(str(tmp_path / "t.gif")))


def test_sunras_writer_pads_rows_as_cv2_does(tmp_path):
    # an odd row length: each pad byte is the next row's first byte (B of
    # its first pixel), the last row's 0
    img = _image("noise", 3, 5, seed=1)
    write_sunras(str(tmp_path / "t.ras"), img)
    data = (tmp_path / "t.ras").read_bytes()
    assert struct.unpack(">8I", data[:32])[1:] == (5, 3, 24, 48, 1, 0, 0)
    rows = np.frombuffer(data[32:], np.uint8).reshape(3, 16)
    np.testing.assert_array_equal(rows[:, 15], [img[1, 0, 2], img[2, 0, 2],
                                                0])
