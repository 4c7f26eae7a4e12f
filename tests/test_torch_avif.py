"""The port's AVIF reader (``utils/image_io.read_avif``: the HEIF boxes and
the colour conversion in Python, the AV1 intra decoder of
``csrc/avif_codec.cpp``) against cv2 5.0.0 (libavif 1.4.2, libaom 3.14.1,
libyuv 1924), the JAX package's reader: every decode bit for bit
``cv2.imread(path)[..., ::-1]``, or both refuse (cv2 returns None; the port
raises naming the file), or the port raises naming a kind it does not read
yet.  The files are cv2's own (every quality, 8, 10 and 12 bits, sizes from
1x1) and Pillow's through libaom's options (tiles, 128x128 superblocks,
4:4:4, CDEF, quantizer matrices).  Stage oracles, through ctypes on the
opencv-python wheel's libraries (``tests/torch_avif_oracles.py``): the
decoded planes against libavif's before any conversion, the conversion
alone from libavif's planes, and the 1D inverse transforms against
libaom's own functions.  The committed AVIF fixtures are checked without
cv2 in ``tests/test_torch_image_formats.py``.
"""

import ctypes
import os
import re
import struct
import subprocess

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.ops import cuda_build
from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif, read_image

import torch_avif_oracles as oracle

SIZES = [(1, 1), (1, 2), (2, 1), (3, 5), (17, 33), (65, 65), (64, 128),
         (130, 67)]
QUALITIES = [0, 10, 25, 50, 75, 90, 95, 100]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def pil():
    pytest.importorskip("PIL.AvifImagePlugin")


def _same_as_cv2(cv2, path, data=None):
    """The port's decode against cv2's: equal bit for bit, or cv2 refuses
    and the port raises naming the file.  → whether cv2 read it."""
    if data is not None:
        path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


def _tools(data: bytes):
    """The decoder's info on a file's primary item (``decode_av1``)."""
    heif = image_io._Heif(data, "file")
    heif.parse()
    obu, _ = heif.primary_item()
    return image_io.decode_av1(obu)


# --------------------------------------------------------- cv2's files


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_cv2_qualities_match_cv2(cv2, tmp_path, size, quality):
    # every content at this size and quality (100 is lossless)
    rng = np.random.default_rng(quality * 1000 + size[0] * 7 + size[1])
    for kind in oracle.KINDS:
        img = oracle.avif_image(kind, *size, rng)
        path = tmp_path / f"{kind}.avif"
        assert _same_as_cv2(cv2, path, oracle.cv2_avif(img, quality))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("depth", [10, 12])
def test_cv2_depths_match_cv2(cv2, tmp_path, size, depth):
    # cv2's 10 and 12-bit files (from uint16 input) at four qualities (100:
    # lossless, through libavif's identity path)
    rng = np.random.default_rng(depth * 100 + size[0] * 7 + size[1])
    for kind in oracle.KINDS:
        img = oracle.deepen(oracle.avif_image(kind, *size, rng), rng)
        for quality in (30, 60, 95, 100):
            data = oracle.cv2_avif(img, quality, depth)
            path = tmp_path / f"{kind}_{quality}.avif"
            assert _same_as_cv2(cv2, path, data)
            assert _tools(data)[1][2] == depth


@pytest.mark.parametrize("kind", ["default", "q90", "lossless", "depth10",
                                  "depth12"])
def test_full_view_matches_cv2(cv2, tmp_path, kind):
    # the committed 1297x840 view at cv2's default (quality 50: CDEF,
    # quantizer matrices and delta q on), at quality 90, lossless, and at
    # 10 and 12 bits
    img = cv2.imread(oracle.VIEW)
    if kind.startswith("depth"):
        data = oracle.cv2_avif(img.astype(np.uint16) * 257,
                               depth=int(kind[5:]))
    else:
        data = oracle.cv2_avif(img, {"default": None, "q90": 90,
                                     "lossless": 100}[kind])
    assert _same_as_cv2(cv2, tmp_path / "view.avif", data)
    info = _tools(data)[1]
    if kind == "default":
        assert info[13:17] == [1, 1, 0, 1]     # CDEF, qm, not lossless, dq
    if kind == "lossless":
        assert info[15] == 1 and info[3:5] == [0, 0]


# ------------------------------------------------------- Pillow's files


@pytest.mark.parametrize("option", list(oracle.PILLOW_OPTIONS))
def test_pillow_options_match_cv2(cv2, pil, tmp_path, option):
    # libaom's own options through Pillow, each tool shown in use
    rng = np.random.default_rng(len(option))
    opts = oracle.PILLOW_OPTIONS[option]
    for size in ((300, 512), (77, 131)):
        for kind in ("photo", "noise"):
            data = oracle.pillow_avif(oracle.avif_image(kind, *size, rng),
                                      **opts)
            assert _same_as_cv2(cv2, tmp_path / "p.avif", data)
            info = _tools(data)[1]
            if size == (300, 512):
                cols, rows = {"tiles_2x1": (2, 1), "tiles_1x2": (1, 2),
                              "tiles_4x2": (4, 2), "all": (2, 2)}.get(
                                  option, (1, 1))
                assert info[10:12] == [cols, rows]
            assert info[12] == (option in ("sb128", "all"))
            if option in ("cdef", "qm", "all"):
                assert info[13 if option == "cdef" else 14]
            if option in ("444", "all"):
                assert info[3:5] == [0, 0]


# ------------------------------------------------------- stage oracles


def _stage_files(rng):
    img = oracle.avif_image("photo", 130, 203, rng)
    files = {f"cv2_q{q}": oracle.cv2_avif(img, q) for q in (20, 50, 100)}
    for depth in (10, 12):
        files[f"cv2_d{depth}"] = oracle.cv2_avif(oracle.deepen(img, rng),
                                                 60, depth)
    return files


def test_planes_match_libavif(cv2):
    # the decoder alone: the Y, U and V planes against libavif's (with its
    # libaom) before any colour conversion
    rng = np.random.default_rng(5)
    files = _stage_files(rng)
    img = oracle.avif_image("photo", 300, 512, rng)
    try:
        for option in ("444", "tiles_4x2", "sb128", "all"):
            files[option] = oracle.pillow_avif(
                img, **oracle.PILLOW_OPTIONS[option])
    except ImportError:
        pass
    for name, data in files.items():
        want, depth, sub = oracle.libavif_planes(data)
        got, info = _tools(data)
        assert info[2] == depth and tuple(info[3:5]) == sub, name
        for p in range(3):
            np.testing.assert_array_equal(got[p], want[p], err_msg=name)


def test_colour_stage_matches_cv2(cv2, tmp_path):
    # the conversion alone: libavif's own planes through the port's
    # libavif/libyuv arithmetic equal cv2's image
    rng = np.random.default_rng(6)
    for name, data in _stage_files(rng).items():
        planes, depth, (sx, sy) = oracle.libavif_planes(data)
        path = tmp_path / f"{name}.avif"
        path.write_bytes(data)
        heif = image_io._Heif(data, str(path))
        heif.parse()
        matrix, full = image_io._avif_nclx(heif.primary_item()[1])
        got = image_io.avif_planes_to_rgb(planes, depth, sx, sy, matrix,
                                          full)
        np.testing.assert_array_equal(got, cv2.imread(str(path))[..., ::-1],
                                      err_msg=name)


def test_upsampling_edges_follow_libyuv():
    # odd and even sizes against a plain per-sample reading of libyuv's
    # ScaleRowUp2_Linear_Any / ScaleRowUp2_Bilinear_Any
    rng = np.random.default_rng(7)

    def linear(row, w):
        out = [int(row[0])]
        for x in range(((w - 1) & ~1) // 2):
            out += [(3 * int(row[x]) + int(row[x + 1]) + 2) >> 2,
                    (int(row[x]) + 3 * int(row[x + 1]) + 2) >> 2]
        out = (out + [0] * w)[:w]
        out[w - 1] = int(row[(w - 1) // 2])
        return out

    def plain(c, w, h):
        rows = [linear(c[0], w)]
        r = 0
        while len(rows) < h - 1 or (h % 2 and len(rows) < h):
            if r + 1 >= c.shape[0]:
                break
            a, b = linear(c[r], w), linear(c[r + 1], w)
            s, t = c[r], c[r + 1]
            d = [(3 * x + y + 2) >> 2 for x, y in zip(a, b)]
            e = [(x + 3 * y + 2) >> 2 for x, y in zip(a, b)]
            n = ((w - 1) & ~1) // 2
            for x in range(n):
                p, q = int(s[x]), int(s[x + 1])
                u, v = int(t[x]), int(t[x + 1])
                d[1 + 2 * x] = (9 * p + 3 * q + 3 * u + v + 8) >> 4
                d[2 + 2 * x] = (3 * p + 9 * q + u + 3 * v + 8) >> 4
                e[1 + 2 * x] = (3 * p + q + 9 * u + 3 * v + 8) >> 4
                e[2 + 2 * x] = (p + 3 * q + 3 * u + 9 * v + 8) >> 4
            k = (w - 1) // 2
            d[w - 1] = (3 * int(s[k]) + int(t[k]) + 2) >> 2
            e[w - 1] = (int(s[k]) + 3 * int(t[k]) + 2) >> 2
            rows += [d, e]
            r += 1
        if h % 2 == 0 and h > 1:
            rows = rows[:h - 1] + [linear(c[r], w)]
        return np.array(rows[:h])

    for h in range(1, 9):
        for w in range(1, 9):
            c = rng.integers(0, 1024, ((h + 1) // 2, (w + 1) // 2))
            np.testing.assert_array_equal(image_io.upsample_420(c, w, h),
                                          plain(c, w, h), err_msg=f"{h}x{w}")


_TRANSFORMS = {"av1_idct4": (0, 2), "av1_idct8": (0, 3),
               "av1_idct16": (0, 4), "av1_idct32": (0, 5),
               "av1_idct64": (0, 6), "av1_iadst4": (1, 2),
               "av1_iadst8": (1, 3), "av1_iadst16": (1, 4),
               "av1_iidentity4_c": (2, 2), "av1_iidentity8_c": (2, 3),
               "av1_iidentity16_c": (2, 4), "av1_iidentity32_c": (2, 5)}


@pytest.mark.parametrize("name", list(_TRANSFORMS))
def test_inverse_transforms_match_libaom(cv2, name):
    # each 1D inverse transform against libaom's own function (found by
    # its ELF symbol in the wheel's libaom), dense and sparse inputs
    lib = image_io._load_avif_codec()
    lib.av1_tx1d.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    vp = ctypes.c_void_p
    theirs = oracle.libaom_function(name, None, vp, vp, ctypes.c_int8, vp)
    ranges = (ctypes.c_int8 * 12)(*([20] * 12))
    kind, n = _TRANSFORMS[name]
    rng = np.random.default_rng(n + 10 * kind)
    for trial in range(300):
        x = rng.integers(-[100, 3000, 60000][trial % 3],
                         [100, 3000, 60000][trial % 3], 1 << n,
                         dtype=np.int32)
        if trial % 5 == 0:
            x[rng.random(1 << n) < 0.7] = 0
        want = np.zeros(1 << n, np.int32)
        theirs(x.ctypes.data, want.ctypes.data, 12, ctypes.addressof(ranges))
        got = x.copy()
        lib.av1_tx1d(kind, n, 20, got.ctypes.data)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------- containers and OBUs


_VARIANTS = {
    "iloc_v1": dict(iloc_version=1), "iloc_v2": dict(iloc_version=2),
    "iloc_8_byte_fields": dict(offset_size=8, length_size=8),
    "iloc_base_offset": dict(base_size=4),
    "iloc_base_only": dict(base_size=8, offset_size=0),
    "three_extents": dict(iloc_version=1, extents=3),
    "idat": dict(iloc_version=1, idat=True),
    "idat_two_extents": dict(iloc_version=2, idat=True, extents=2),
    "ipma_v1": dict(ipma_version=1), "ipma_15_bit": dict(ipma_wide=True),
    "infe_v3": dict(infe_version=3), "pitm_v1": dict(pitm_version=1),
    "mdat_64_bit_size": dict(large_mdat=True),
    "no_colr": dict(drop=b"colr"), "no_pixi": dict(drop=b"pixi"),
    "extent_length_0": dict(length_size=0),
}


@pytest.mark.parametrize("variant", list(_VARIANTS))
def test_container_variants_match_cv2(cv2, tmp_path, variant):
    # the boxes written here in each variant libavif parses (or refuses:
    # an extent of length 0), around the OBUs of a cv2 file
    img = oracle.avif_image("photo", 40, 56, np.random.default_rng(12))
    obu, props = oracle.item_parts(oracle.cv2_avif(img))
    kw = dict(_VARIANTS[variant])
    drop = kw.pop("drop", None)
    props = {k: v for k, v in props.items() if k != drop}
    data = oracle.build_avif(obu, props, **kw)
    read = _same_as_cv2(cv2, tmp_path / f"{variant}.avif", data)
    assert read == (variant != "extent_length_0")


def _split_frame(stream: bytes, props):
    """The item's frame OBU as a frame header OBU and a tile group OBU: the
    header's end (its trailing one bit) found as the split libavif decodes
    to the frame OBU's planes."""
    want = oracle.libavif_planes(oracle.build_avif(stream, props))[0]
    parts = oracle.obus(stream)
    frame = [p for k, _, p in parts if k == 6][0]
    seq = b"".join(oracle.obu(k, p) for k, _, p in parts if k == 1)
    for k in range(1, len(frame)):
        for b in range(8 * (k - 1), 8 * k + 1):
            head = bytearray(frame[:k]) + (b"\x80" if b == 8 * k else b"")
            if b < 8 * k:
                head[b >> 3] |= 0x80 >> (b & 7)
            split = seq + oracle.obu(3, bytes(head)) + oracle.obu(4, frame[k:])
            try:
                got = oracle.libavif_planes(oracle.build_avif(split, props))[0]
            except ValueError:
                continue
            if all((a == c).all() for a, c in zip(got, want)):
                return split
    raise AssertionError("no split of the frame OBU decodes")


# OBUs put before the frame OBU: (type, payload); libaom checks each
# padding and metadata OBU's trailing bits (0x80, then zeros)
_EXTRA_OBUS = {
    "padding": (15, bytes(range(1, 9)) + b"\x80\x00"),
    "padding_empty": (15, b""),
    "padding_no_trailing_bits": (15, bytes(range(1, 9))),
    "metadata_hdr_cll": (5, b"\x01\x03\xe8\x01\xf4\x80"),
    "metadata_hdr_cll_short": (5, b"\x01\x03\xe8\x80"),
    "metadata_t35": (5, b"\x04\xb5\x00\x3c\x01\x80"),
    "metadata_t35_no_trailing_bits": (5, b"\x04\xb5\x00\x3c\x01\x08"),
    "metadata_timecode": (5, b"\x05\x04\x00\x00\x00\x01"),
    "metadata_private": (5, b"\x08\x11\x22\x80"),
}


@pytest.mark.parametrize("layout", ["frame_header_and_tile_group",
                                    *_EXTRA_OBUS, "extension_headers",
                                    "last_without_size"])
@pytest.mark.parametrize("tiles", [1, 8])
def test_obu_layouts_match_cv2(cv2, pil, tmp_path, layout, tiles):
    # the OBU framing a reader meets beside the one frame OBU of cv2's and
    # Pillow's files: a frame header OBU and a tile group OBU (one tile, or
    # 4x2 tiles), padding and metadata OBUs (libaom refuses those without
    # trailing bits), extension headers; and a last OBU without its size
    # field, which libaom refuses
    img = oracle.avif_image("photo", 300, 512, np.random.default_rng(13))
    data = (oracle.cv2_avif(img[:40, :56]) if tiles == 1 else
            oracle.pillow_avif(img, **oracle.PILLOW_OPTIONS["tiles_4x2"]))
    stream, props = oracle.item_parts(data)
    parts = oracle.obus(stream)
    if layout == "frame_header_and_tile_group":
        stream = _split_frame(stream, props)
    elif layout in _EXTRA_OBUS:
        extra = oracle.obu(*_EXTRA_OBUS[layout])
        stream = b"".join(oracle.obu(k, p) if k != 6 else extra +
                          oracle.obu(k, p) for k, _, p in parts)
    elif layout == "extension_headers":
        stream = b"".join(bytes([(k << 3) | 6, 0x28]) + oracle.obu(k, p)[1:]
                          for k, _, p in parts)
    else:
        last = parts[-1]
        stream = b"".join(oracle.obu(k, p) for k, _, p in parts[:-1]) + \
            bytes([last[0] << 3]) + last[2]
    read = _same_as_cv2(cv2, tmp_path / f"{layout}.avif",
                        oracle.build_avif(stream, props))
    assert read == (layout not in ("last_without_size",
                                   "padding_no_trailing_bits",
                                   "metadata_hdr_cll_short",
                                   "metadata_t35_no_trailing_bits"))


# ----------------------------------------------------------- refusals


def _orientation(value: int):
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = value
    return exif


def _second_frame(img):
    from PIL import Image
    return [Image.fromarray(np.ascontiguousarray(img[::-1, :, ::-1]))]


# kinds cv2 reads that the port does not yet: Pillow writes an EXIF
# orientation as an essential irot, two frames as an image sequence
_REFUSED = {
    "irot": (lambda img: dict(exif=_orientation(6)), r"rotation \(irot\)"),
    "avis": (lambda img: dict(save_all=True, duration=100,
                              append_images=_second_frame(img)),
             r"image sequence \(avis\)"),
}


@pytest.mark.parametrize("kind", list(_REFUSED))
def test_unported_tools_raise_naming_the_feature(cv2, pil, tmp_path, kind):
    # files cv2 reads with a tool the port does not decode yet
    opts, feature = _REFUSED[kind]
    img = oracle.avif_image("photo", 96, 128, np.random.default_rng(8))
    path = tmp_path / f"{kind}.avif"
    path.write_bytes(oracle.pillow_avif(img, **opts(img)))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(RuntimeError) as err:
        read_avif(str(path))
    assert f"{kind}.avif" in str(err.value)
    assert "not read yet" in str(err.value)
    assert re.search(feature, str(err.value)), str(err.value)


_READ_SINCE = {
    "422": dict(subsampling="4:2:2"),
    "400": dict(subsampling="4:0:0"),
    "screen": dict(advanced={"tune-content": "screen"}),
    "alpha": dict(),
    "grain": dict(advanced={"film-grain-test": "1"}),
    # libaom's denoiser writes its noise model as film grain parameters
    "denoise": dict(advanced={"denoise-noise-level": "25"}),
}


@pytest.mark.parametrize("kind", list(_READ_SINCE))
def test_pillow_kinds_read_as_cv2(cv2, pil, tmp_path, kind):
    # kinds the reader once refused (4:2:2, 4:0:0, screen content, an
    # alpha item, film grain from libaom's test vectors and its denoiser)
    # read as cv2 reads them
    img = oracle.avif_image("photo", 96, 128, np.random.default_rng(8))
    if kind == "alpha":
        img = np.dstack([img, np.full(img.shape[:2], 128, np.uint8)])
    path = tmp_path / f"{kind}.avif"
    path.write_bytes(oracle.pillow_avif(img, **_READ_SINCE[kind]))
    want = cv2.imread(str(path))
    assert want is not None
    np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])


def _edits(data):
    """Hand-edited containers: (name, bytes, whether cv2 reads them)."""
    ilen = bytearray(data)
    struct.pack_into(">I", ilen, oracle.iloc_length_at(data), 100000)
    i = data.find(b"ispe")
    return {
        "no_ispe": data[:i] + b"xspe" + data[i + 4:],
        "iloc_past_end": bytes(ilen),
        "essential_unknown": oracle.insert_property(
            data, struct.pack(">I4s", 8, b"zzzz"), True),
        "unknown": oracle.insert_property(
            data, struct.pack(">I4s", 8, b"zzzz"), False),
        "irot_not_essential": oracle.insert_property(
            data, struct.pack(">I4sB", 9, b"irot", 1), False),
        "irot": oracle.insert_property(
            data, struct.pack(">I4sB", 9, b"irot", 1), True),
        "imir": oracle.insert_property(
            data, struct.pack(">I4sB", 9, b"imir", 0), True),
    }


@pytest.mark.parametrize("edit", ["no_ispe", "iloc_past_end",
                                  "essential_unknown", "unknown",
                                  "irot_not_essential", "irot", "imir"])
def test_hand_edited_containers(cv2, tmp_path, edit):
    # libavif's container rules: where cv2 returns None the port raises
    # naming the file; a rotation or mirror cv2 reads (it ignores it) the
    # port refuses as not read yet
    img = oracle.avif_image("photo", 48, 64, np.random.default_rng(9))
    data = _edits(oracle.cv2_avif(img))[edit]
    path = tmp_path / f"{edit}.avif"
    path.write_bytes(data)
    if edit in ("irot", "imir"):
        assert cv2.imread(str(path)) is not None
        with pytest.raises(RuntimeError, match=f"{edit}.avif: .*{edit}.*not "
                                               f"read yet"):
            read_image(str(path))
        return
    assert _same_as_cv2(cv2, path) == (edit == "unknown")


@pytest.mark.parametrize("cut", [8, 40, 120, 250, -40, -1])
def test_cut_files_raise_where_cv2_fails(cv2, tmp_path, cut):
    img = oracle.avif_image("photo", 40, 56, np.random.default_rng(10))
    data = oracle.cv2_avif(img)
    assert not _same_as_cv2(cv2, tmp_path / "cut.avif", data[:cut])


@pytest.mark.parametrize("group", range(4))
def test_byte_flips_match_cv2(cv2, tmp_path, group):
    # one flipped bit in the item's OBUs (the headers or the tile data):
    # both refuse (libaom's checks: its tile exit process, alignment and
    # trailing bits, levels, Golomb lengths), or both read the same image;
    # where a flip makes the frame's size disagree with ispe, libavif pads
    # the frame to ispe's size, which the port does not yet
    rng = np.random.default_rng(100 + group)
    counts = {"same": 0, "both refuse": 0, "not yet": 0}
    for trial in range(60):
        img = oracle.avif_image(oracle.KINDS[trial % 4],
                                int(rng.integers(8, 90)),
                                int(rng.integers(8, 90)), rng)
        data = bytearray(oracle.cv2_avif(img, int(rng.integers(0, 101))))
        obu, _ = oracle.item_parts(bytes(data))
        start = len(data) - len(obu)
        end = start + 40 if trial % 2 else len(data)
        data[int(rng.integers(start, min(end, len(data))))] ^= \
            1 << int(rng.integers(0, 8))
        path = tmp_path / f"flip{trial}.avif"
        path.write_bytes(bytes(data))
        want = cv2.imread(str(path))
        try:
            got = read_image(str(path))
        except RuntimeError as err:
            assert path.name in str(err)
            if want is None:
                counts["both refuse"] += 1
                continue
            assert "ispe differs" in str(err), str(err)
            counts["not yet"] += 1
            continue
        assert want is not None, path.name
        np.testing.assert_array_equal(got, want[..., ::-1])
        counts["same"] += 1
    assert counts["same"] and counts["both refuse"], counts


def _field_edits(data):
    """Single-field edits of cv2's boxes: name -> bytes."""
    out = {}

    def put(name, off, value=None, xor=None):
        e = bytearray(data)
        e[off] = e[off] ^ xor if xor is not None else value
        out[name] = bytes(e)
    box = {k: oracle.find_box(data, k)[0] for k in (
        (b"meta",), (b"meta", b"hdlr"), (b"meta", b"pitm"),
        (b"meta", b"iinf"), (b"meta", b"iloc"), (b"meta", b"iprp", b"ipma"))}
    put("meta_version_1", box[(b"meta",)] + 8, 1)
    put("meta_flags", box[(b"meta",)] + 11, 1)
    hdlr = box[(b"meta", b"hdlr")]
    put("hdlr_version_1", hdlr + 8, 1)
    put("hdlr_pre_defined", hdlr + 15, 1)
    put("hdlr_reserved", hdlr + 23, 1)
    put("hdlr_name_unterminated", hdlr + 32, 0x41)
    put("pitm_version_2", box[(b"meta", b"pitm")] + 8, 2)
    iinf = box[(b"meta", b"iinf")]
    put("iinf_version_2", iinf + 8, 2)
    put("iinf_count_2", iinf + 13, 2)
    put("infe_version_4", iinf + 14 + 8, 4)
    put("infe_name_unterminated", data.index(b"Color\0") + 5, 0x41)
    put("iloc_flags", box[(b"meta", b"iloc")] + 11, 1)
    put("ipma_version_2", box[(b"meta", b"iprp", b"ipma")] + 8, 2)
    s, e = oracle.find_box(data, (b"meta", b"iprp", b"ipco"))
    for kind, _, bs, _ in oracle.boxes(data, s + 8, e):
        if kind == b"ispe":
            put("ispe_version_1", bs + 8, 1)
            put("ispe_height", bs + 19, xor=1)
        elif kind == b"pixi":
            put("pixi_version_1", bs + 8, 1)
            put("pixi_channels_4", bs + 12, 4)
            put("pixi_depth_10", bs + 14, 10)
        elif kind == b"av1C":
            put("av1C_version_2", bs + 8, 0x82)
            put("av1C_high_bitdepth", bs + 10, xor=0x40)
            put("av1C_monochrome", bs + 10, xor=0x10)
            put("av1C_level", bs + 9, xor=0x01)
        elif kind == b"colr":
            put("colr_reserved_bit", bs + 18, xor=0x01)
            put("colr_limited_range", bs + 18, xor=0x80)
            put("colr_matrix_7", bs + 17, xor=0x01)
            put("colr_matrix_14", bs + 17, xor=0x08)
            put("colr_primaries", bs + 13, xor=0x02)
    put("meta_size_past_end", box[(b"meta",)] + 2, xor=0x10)
    put("mdat_size_past_end", len(data) - len(oracle.item_parts(data)[0]) -
        6, xor=0x10)
    return out


@pytest.mark.parametrize("edit", [
    "meta_version_1", "meta_flags", "hdlr_version_1", "hdlr_pre_defined",
    "hdlr_reserved", "hdlr_name_unterminated", "pitm_version_2",
    "iinf_version_2", "iinf_count_2", "infe_version_4",
    "infe_name_unterminated", "iloc_flags", "ipma_version_2",
    "ispe_version_1", "ispe_height", "pixi_version_1", "pixi_channels_4",
    "pixi_depth_10", "av1C_version_2", "av1C_high_bitdepth",
    "av1C_monochrome", "av1C_level", "colr_reserved_bit",
    "colr_limited_range", "colr_matrix_7", "colr_matrix_14",
    "colr_primaries", "meta_size_past_end", "mdat_size_past_end"])
def test_field_edits_match_cv2(cv2, tmp_path, edit):
    # libavif's rules for each field, held through cv2: where it refuses,
    # the port raises naming the file; where it reads, the port gives its
    # image, or raises naming a kind it does not read yet (a matrix or
    # range it does not convert, a frame whose size is not ispe's)
    img = oracle.avif_image("photo", 40, 56, np.random.default_rng(14))
    data = _field_edits(oracle.cv2_avif(img))[edit]
    path = tmp_path / f"{edit}.avif"
    path.write_bytes(data)
    want = cv2.imread(str(path))
    try:
        got = read_image(str(path))
    except RuntimeError as err:
        assert path.name in str(err)
        assert want is None or "not read yet" in str(err), str(err)
        return
    assert want is not None
    np.testing.assert_array_equal(got, want[..., ::-1])


def test_signature_brands(cv2, tmp_path):
    # cv2 takes a file as AVIF by the avif or avis brand, major or
    # compatible, in a whole ftyp box; the port dispatches alike
    img = oracle.avif_image("photo", 24, 32, np.random.default_rng(11))
    data = oracle.cv2_avif(img)
    assert data[8:12] == b"avif"
    mif1 = data[:8] + b"mif1" + data[12:]
    assert image_io.is_avif(mif1)          # avif stays among compatible
    assert _same_as_cv2(cv2, tmp_path / "mif1.avif", mif1)
    none = data[:8] + b"mif1" + data[12:].replace(b"avif", b"abcd", 2)
    assert not image_io.is_avif(none)
    assert not _same_as_cv2(cv2, tmp_path / "none.avif", none)


def test_failed_build_raises(cv2, tmp_path, monkeypatch):
    # no fallback to any other reader when the codec does not build
    path = tmp_path / "view.avif"
    path.write_bytes(oracle.cv2_avif(np.zeros((2, 2, 3), np.uint8)))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.delitem(cuda_build._LIBS, "avif_codec", raising=False)
    monkeypatch.setattr(cuda_build, "find_cxx", lambda: "false")
    with pytest.raises(RuntimeError, match="avif_codec.cpp"):
        read_avif(str(path))


def test_codec_links_no_av1_library():
    # the codec is the committed source alone: no libaom, dav1d, libavif
    # or libyuv among the built library's dependencies
    image_io._load_avif_codec()
    path = cuda_build.BUILD_INFO["avif_codec"]["path"]
    needed = subprocess.run(["readelf", "-d", path], capture_output=True,
                            text=True, check=True).stdout
    libs = [line.split("[")[1].split("]")[0] for line in needed.splitlines()
            if "(NEEDED)" in line]
    assert libs and not [lib for lib in libs if any(
        k in lib for k in ("aom", "dav1d", "avif", "yuv", "gav1"))], libs


def test_tables_are_libaoms(cv2):
    # the generated block of csrc/avif_codec.cpp is what
    # tests/torch_make_av1_tables.py reads out of the wheel's libaom today
    import torch_make_av1_tables as tables

    elf = tables.Elf(tables.find_libaom())
    got, nz = tables.collect(elf)
    with open(tables.CODEC) as f:
        src = f.read()
    for name, (ctype, arr) in got.items():
        assert tables.emit(name, ctype, arr) in src, name
    assert len(nz) >= 12
