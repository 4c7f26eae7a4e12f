"""The TIFF kinds cv2 5.0.0 (libtiff 4.7.1, through its RGBA interface)
reads that the port's reader took last: 16-bit CIELab, subsampled YCbCr
under Predictor 2 and old-style LZW, each against cv2 bit for bit; and the
kinds cv2 refuses too (16-bit YCbCr, YCbCr or CIELab with an extra sample,
CIELab in separate planes, ICCLab and ITULab, old-style JPEG), where the
port raises naming the file.  The files are written here by hand
(``torch_make_image_fixtures.tiff_bytes`` and its encoders:
``rgb_to_cielab16``, ``ycbcr_units``, ``lzw_old_style``); the committed
ones (``KINDS_CASES``) are held with the counters ``read_tiff`` reports
for the kind each is there for.
"""

import inspect
import itertools
import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_png, read_tiff

import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _noise(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape)


def _same_as_cv2(cv2, path, data):
    """The port equals cv2 bit for bit, or both refuse (the port raising
    naming the file).  → read_tiff's counters, or None where both refuse."""
    path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(ValueError, match=path.name) as err:
            read_tiff(str(path))
        assert "not read yet" not in str(err.value)
        return None
    info = {}
    got = read_tiff(str(path), info)
    np.testing.assert_array_equal(got, want[..., ::-1], err_msg=path.name)
    return info


# ---------------------------------------------------------- 16-bit CIELab


_LAB_LAYOUTS = {
    "none": {},
    "lzw_pred": dict(compression=5, predictor=2, rows_per_strip=3),
    "deflate_pred": dict(compression=8, predictor=2, rows_per_strip=5),
    "adobe_deflate": dict(compression=32946, rows_per_strip=4),
    "packbits": dict(compression=32773, rows_per_strip=6),
    "lzw_tiles_pred": dict(compression=5, predictor=2, tile=(16, 16)),
    "deflate_tiles_mm": dict(compression=8, tile=(32, 16), endian=">"),
    "lzw_mm_pred": dict(compression=5, predictor=2, endian=">"),
    "packbits_mm_fill2": dict(compression=32773, endian=">",
                              fill_order=2),
}


@pytest.mark.parametrize("layout", list(_LAB_LAYOUTS))
def test_cielab16_matches_cv2(cv2, tmp_path, layout):
    # putcontig8bitCIELab16: TIFFCIELab16ToXYZ on L, a and b as they are
    # (a and b signed), then TIFFXYZToRGB; every compression the port reads
    for h, w in [(1, 1), (7, 9), (37, 45)]:
        px = _noise((h, w, 3), 1 << 16, seed=h * w)
        px[0, 0] = (65535, 0x8000, 0x7FFF)          # the ends of each
        info = _same_as_cv2(cv2, tmp_path / f"lab_{h}x{w}.tif",
                            fx.tiff_bytes(px, bps=16, photometric=8,
                                          **_LAB_LAYOUTS[layout]))
        assert info["cielab16"] == 1


def test_cielab16_ends_match_cv2(cv2, tmp_path):
    # L at its ends and in the dark segment (L < 8.856, Y linear), a and b
    # at -32768, -32767, -1, 0, 1, 32767 and in between
    L = np.array([0, 1, 5000, 5803, 5804, 30000, 65534, 65535])
    ab = np.array([-32768, -32767, -20000, -1, 0, 1, 20000, 32767])
    grid = np.stack(np.meshgrid(L, ab, ab, indexing="ij"), -1).reshape(
        32, 16, 3)
    info = _same_as_cv2(cv2, tmp_path / "ends.tif", fx.tiff_bytes(
        grid.astype(np.int64).astype(np.uint16), bps=16, photometric=8))
    assert info["cielab16"] == 1


@pytest.mark.parametrize("orientation", range(1, 9))
def test_cielab16_orientations_match_cv2(cv2, tmp_path, orientation):
    # strips at every orientation (5-8 of a non-square image: both
    # refuse); tiles where cv2 reads them as strips (ROADMAP §3: cv2
    # mirrors each tile of orientations 2, 3, 6 and 7)
    for (h, w), tile in itertools.product([(24, 24), (20, 31)],
                                          [None, (16, 16)]):
        if tile and orientation in (2, 3, 6, 7):
            continue
        px = fx.rgb_to_cielab16(fx.fixture_image(h, w, seed=orientation))
        info = _same_as_cv2(cv2, tmp_path / f"o{h}x{w}.tif", fx.tiff_bytes(
            px, bps=16, photometric=8, compression=5, predictor=2,
            tile=tile, orientation=orientation))
        assert (info is not None) == (orientation <= 4 or h == w)


@pytest.mark.parametrize("white", [(3457, 10000, 3585, 10000),
                                   (31271, 100000, 32902, 100000),
                                   (1, 3, 1, 3)],
                         ids=["d50", "d65", "equal_energy"])
def test_cielab16_white_points_match_cv2(cv2, tmp_path, white):
    px = _noise((20, 30, 3), 1 << 16, seed=7)
    info = _same_as_cv2(cv2, tmp_path / "white.tif", fx.tiff_bytes(
        px, bps=16, photometric=8, tags={318: (5, list(white))}))
    assert info["cielab16"] == 1


def test_cielab16_from_rgb_round_trips(cv2, tmp_path):
    # the writer's inverse of libtiff's display_sRGB (chip_smoke's mid
    # views are written so): every 8-bit RGB triple on a grid back within
    # 12 levels (libtiff's 1500-step light table is coarse in the dark),
    # 0.45 on average
    v = np.arange(256)
    rgb = np.stack(np.meshgrid(v, v[::3], v[::5], indexing="ij"),
                   -1).reshape(256, -1, 3).astype(np.uint8)
    _same_as_cv2(cv2, tmp_path / "rgb.tif", fx.tiff_bytes(
        fx.rgb_to_cielab16(rgb), bps=16, photometric=8, compression=8))
    d = np.abs(read_tiff(str(tmp_path / "rgb.tif")).astype(int) - rgb)
    assert d.max() <= 12 and d.mean() < 0.5


@pytest.mark.parametrize("photometric,planar", [(8, 2), (9, 1), (10, 1)],
                         ids=["cielab_planar", "icclab", "itulab"])
@pytest.mark.parametrize("bps", [8, 16])
def test_other_lab_kinds_are_refused_as_cv2_refuses(cv2, tmp_path,
                                                    photometric, planar,
                                                    bps):
    # CIELab in separate planes (no routine in TIFFRGBAImageBegin), ICCLab
    # and ITULab (TIFFRGBAImageOK)
    px = _noise((8, 12, 3), 1 << bps, seed=bps)
    assert _same_as_cv2(cv2, tmp_path / "lab.tif", fx.tiff_bytes(
        px, bps=bps, photometric=photometric, planar=planar)) is None


# ------------------------------------- subsampled YCbCr under Predictor 2


_SUBSAMPLINGS = [(1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4)]
_YCC_LAYOUTS = [dict(rows_per_strip=None), dict(rows_per_strip=8),
                dict(rows_per_strip=5), dict(tile=(16, 16)),
                dict(tile=(32, 48))]


@pytest.mark.parametrize("comp", [5, 8], ids=["lzw", "deflate"])
@pytest.mark.parametrize("sub", _SUBSAMPLINGS,
                         ids=[f"{a}x{b}" for a, b in _SUBSAMPLINGS])
def test_subsampled_ycbcr_under_predictor_matches_cv2(cv2, tmp_path, sub,
                                                      comp):
    # horAcc8, 3 bytes back, over rows of TIFFScanlineSize in a strip (a
    # row of sample blocks over the vertical subsampling, cut short) and
    # of the tile's width times 3 in a tile, where they are whole rows of
    # whole pixels; the differences as libtiff writes them and unit by
    # unit (what no reader undoes); widths and heights off the blocks
    for (h, w), layout, rows in itertools.product(
            [(16, 24), (37, 45), (19, 22), (33, 50)], _YCC_LAYOUTS,
            ["libtiff", "pixels"]):
        px = _noise((h, w, 3), 256, seed=h + w).astype(np.uint8)
        layout = dict(layout)
        layout["rows_per_strip"] = layout.get("rows_per_strip") or h \
            if "tile" not in layout else None
        info = _same_as_cv2(cv2, tmp_path / "ycc.tif", fx.tiff_bytes(
            px, photometric=6, subsampling=sub, compression=comp,
            predictor=2, ycbcr_rows=rows, **layout))
        tiles = "tile" in layout
        n = -(-h // layout["tile"][1]) * -(-w // layout["tile"][0]) \
            if tiles else -(-h // layout["rows_per_strip"])
        assert info["ycbcr_predictor_chunks"] + \
            info["ycbcr_predictor_skipped"] == n


@pytest.mark.parametrize("sub,size,tile,undone", [
    ((2, 1), (16, 45), None, False),   # TIFFScanlineSize 92: not pixels
    ((2, 1), (16, 42), None, True),    # 84
    ((4, 4), (16, 50), None, False),   # 13 blocks: 58, and decoded short
    ((4, 4), (16, 48), None, True),    # 12 blocks: 54
    ((1, 2), (16, 44), None, False),   # 88
    ((4, 2), (32, 32), (16, 16), False),  # a tile of 320 bytes, rows of 48
    ((4, 2), (48, 48), (48, 48), True),   # 2880 bytes, rows of 144
    ((2, 1), (16, 16), (16, 16), False),  # 512, rows of 48
])
def test_where_libtiff_undoes_the_predictor(cv2, tmp_path, sub, size, tile,
                                            undone):
    # the counters say which chunks libtiff undoes; written unit by unit,
    # a chunk it undoes reads garbled and one it leaves reads as written
    h, w = size
    px = fx.rgb_to_ycbcr(fx.fixture_image(h, w, seed=9))
    data = fx.tiff_bytes(px, photometric=6, subsampling=sub, compression=5,
                         predictor=2, tile=tile, ycbcr_rows="pixels",
                         rows_per_strip=None if tile else h)
    info = _same_as_cv2(cv2, tmp_path / "rows.tif", data)
    assert bool(info["ycbcr_predictor_chunks"]) == undone
    assert bool(info["ycbcr_predictor_skipped"]) == (not undone)


@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (48, 32)])
def test_4x4_tiles_at_the_edge_match_cv2(cv2, tmp_path, tile):
    # a tile the image's edge cuts: putcontig8bitYCbCr44tile skips the
    # blocks past the edge at 10 bytes a block, not 18 (the port read them
    # at 18 before; ROADMAP §3)
    for h, w in [(37, 45), (16, 24), (40, 52)]:
        px = _noise((h, w, 3), 256, seed=w).astype(np.uint8)
        for comp in (1, 8):
            _same_as_cv2(cv2, tmp_path / "edge.tif", fx.tiff_bytes(
                px, photometric=6, subsampling=(4, 4), tile=tile,
                compression=comp))


# ------------------------------------------------------- old-style LZW


_OLD_KINDS = {
    "gray8": dict(v=(1, 8)), "gray16": dict(v=(1, 16)),
    "rgb8": dict(v=(3, 8)), "rgb16": dict(v=(3, 16)),
    "palette8": dict(v=(1, 8), photometric=3),
    "rgba8_unassoc": dict(v=(4, 8), extra_samples=[2]),
    "cmyk8": dict(v=(4, 8), photometric=5),
    "ycbcr_sub22": dict(v=(3, 8), photometric=6, subsampling=(2, 2)),
    "cielab16": dict(v=(3, 16), photometric=8),
}
_OLD_LAYOUTS = {
    "strips_pred": dict(predictor=2, rows_per_strip=5),
    "tiles": dict(tile=(16, 16)),
    "planar": dict(planar=2, rows_per_strip=7),
    "mm_pred": dict(predictor=2, endian=">"),
    "fill2": dict(fill_order=2, rows_per_strip=9),
}


@pytest.mark.parametrize("layout", list(_OLD_LAYOUTS))
@pytest.mark.parametrize("kind", list(_OLD_KINDS))
def test_old_style_lzw_matches_cv2(cv2, tmp_path, kind, layout):
    # LZWDecodeCompat: LSB-first codes, the width one code later
    spec = dict(_OLD_KINDS[kind])
    spp, bps = spec.pop("v")
    opts = {**_OLD_LAYOUTS[layout], **spec}
    if kind in ("ycbcr_sub22", "cielab16"):
        opts.pop("planar", None)     # libtiff reads neither in planes
    if kind == "gray16" and "tile" in opts:
        opts.pop("tile")         # cv2 garbles tiled 16-bit gray (§3)
    for h, w in [(1, 1), (20, 37)]:
        px = _noise((h, w, spp), 1 << bps, seed=h)
        if spec.get("photometric") == 3:
            opts["colormap"] = _noise((256, 3), 1 << 16, seed=w)
        info = _same_as_cv2(cv2, tmp_path / f"{kind}.tif", fx.tiff_bytes(
            px, bps=bps, compression=5, old_lzw=True, **opts))
        assert info["old_lzw_chunks"] > 0


@pytest.mark.parametrize("n", [300, 900, 2200, 20000])
def test_old_style_lzw_code_widths_match_cv2(cv2, tmp_path, n):
    # one strip of noise long enough for 10-, 11- and 12-bit codes and,
    # past 4094 entries, CLEARs; and of runs (long strings)
    for seed, runs in ((n, False), (n + 1, True)):
        raw = _noise(n, 256, seed).astype(np.uint8)
        if runs:
            raw = np.repeat(raw[::7], 7)[:n]
        stats = {}
        fx.lzw_old_style(raw.tobytes(), stats=stats)
        want_bits = 9 + (n >= 300) + (n >= 900) + (n >= 2200)
        if not runs:
            assert stats["max_bits"] == min(want_bits, 12)
            assert (stats["clears"] > 0) == (n >= 20000)
        px = raw.reshape(1, n, 1)
        info = _same_as_cv2(cv2, tmp_path / "long.tif", fx.tiff_bytes(
            px, compression=5, old_lzw=True))
        assert info["old_lzw_chunks"] == 1


def test_lzw_style_is_the_first_strips(cv2, tmp_path):
    # libtiff's LZWPreDecode sets the codec's style at the first strip it
    # decodes, for the whole file: strips of the other style read as
    # garbage in cv2 (what it decoded of them), and the port raises naming
    # the file (its decoder finds the codes corrupt)
    v = _noise((20, 30, 3), 256, seed=11).astype(np.uint8)
    for first_old in (True, False):
        data = bytearray(fx.tiff_bytes(v, compression=5, rows_per_strip=5,
                                       old_lzw=first_old))
        new = fx.tiff_bytes(v, compression=5, rows_per_strip=5,
                            old_lzw=not first_old)
        # the same layout with the other style's strips after the first
        path = tmp_path / "mixed.tif"
        path.write_bytes(_restrip(bytes(data), new))
        want = cv2.imread(str(path))
        assert want is not None
        assert (want[:5, :, ::-1] == v[:5]).all()
        assert not (want[5:, :, ::-1] == v[5:]).all()
        with pytest.raises(ValueError, match="mixed.tif: corrupt LZW"):
            read_tiff(str(path))


def _restrip(first: bytes, other: bytes) -> bytes:
    """A little-endian strip TIFF whose first strip is ``first``'s and
    whose other strips are ``other``'s (the same layout)."""
    import struct

    def strips(data):
        _, tags = image_io._tiff_directory(data, "x")
        return [data[o:o + n] for o, n in zip(tags[273], tags[279])], tags
    a, tags = strips(first)
    b, _ = strips(other)
    chunks = [a[0]] + b[1:]
    body = bytearray(b"II*\x00" + bytes(4))
    offsets = []
    for c in chunks:
        offsets.append(len(body))
        body += c + b"\x00" * (len(c) % 2)
    fields = {t: (3 if t in (258, 259, 262, 277, 284, 317) else 4, list(v))
              for t, v in tags.items()}
    fields[273], fields[279] = (4, offsets), (4, [len(c) for c in chunks])
    entries = []
    for t in sorted(fields):
        typ, vals = fields[t]
        raw = struct.pack("<" + ("H" if typ == 3 else "I") * len(vals),
                          *vals)
        if len(raw) > 4:
            entries.append(struct.pack("<HHII", t, typ, len(vals),
                                       len(body)))
            body += raw
        else:
            entries.append(struct.pack("<HHI", t, typ, len(vals))
                           + raw.ljust(4, b"\x00"))
    ifd = len(body)
    body += struct.pack("<H", len(entries)) + b"".join(entries) + bytes(4)
    body[4:8] = struct.pack("<I", ifd)
    return bytes(body)


# ------------------------------------------- the kinds cv2 refuses too


_REFUSED_TIFF = [n for n in fx.KINDS_REFUSED if n.endswith(".tif")]


@pytest.mark.parametrize("name", _REFUSED_TIFF)
def test_kinds_cv2_refuses_raise_naming_the_file(cv2, tmp_path, name):
    # 16-bit YCbCr (TIFFRGBAImageBegin has no routine), YCbCr with an
    # extra sample (TIFFVStripSize64), CIELab with one (TIFFRGBAImageOK),
    # old-style JPEG (no OJPEG codec in cv2's libtiff): not supported
    path = tmp_path / name
    path.write_bytes(fx.kinds_files()[name])
    assert cv2.imread(str(path)) is None
    with pytest.raises(ValueError, match=f"{name}: .*TIFF .*is not "
                                         f"supported \\(nor by cv2"):
        read_tiff(str(path))


@pytest.mark.parametrize("spp,bps,planar", [(4, 8, 1), (4, 16, 1),
                                            (4, 8, 2), (2, 8, 1),
                                            (3, 16, 1), (3, 16, 2)])
@pytest.mark.parametrize("photometric", [6, 8])
def test_ycbcr_and_cielab_sample_counts_cv2_refuses(cv2, tmp_path, spp, bps,
                                                    planar, photometric):
    px = _noise((6, 8, spp), 1 << bps, seed=spp * bps)
    extra = [0] * (spp - 3) if spp > 3 else None
    data = fx.tiff_bytes(px, bps=bps, photometric=photometric,
                         planar=planar, extra_samples=extra)
    read = _same_as_cv2(cv2, tmp_path / "count.tif", data)
    assert (read is not None) == (photometric == 8 and spp == 3
                                  and planar == 1)


def test_no_tiff_kind_is_left_not_read_yet():
    assert "not read yet" not in inspect.getsource(image_io.read_tiff)


# ------------------------------------------------- the committed files


@pytest.mark.parametrize("name", [n for n in fx.KINDS_CASES
                                  if n.endswith(".tif")])
def test_committed_tiff_kinds_use_their_kind(name):
    # no cv2 here: the decode is cv2's recorded one, and the counters show
    # the kind the file is there for
    info = {}
    got = read_tiff(os.path.join(fx.FOLDER, name), info)
    want = read_png(os.path.join(fx.FOLDER, name[:-4] + ".want.png"))
    np.testing.assert_array_equal(got, want)
    uses = fx.TIFF_KINDS_USES[name]
    if uses is not None:
        assert info[uses] > 0, info


def test_committed_files_are_the_writers():
    # kinds_files writes the committed files byte for byte (numpy and the
    # standard library alone: the card's host can write them too)
    made = fx.kinds_files()
    for name in fx.KINDS_CASES + fx.KINDS_REFUSED:
        with open(os.path.join(fx.FOLDER, name), "rb") as f:
            assert f.read() == made[name], name


@pytest.mark.parametrize("k", range(3))
def test_mid_view_writer_takes_each_kind(tmp_path, k):
    # tiff_mid_file's three kinds, on a small noisy view: the read takes
    # the kind TIFF_MID_KINDS names for it, near the view (the 4:2:0
    # chroma of a noisy view the farthest), old-style LZW exactly
    rgb = fx.fixture_image(24, 40, seed=12)
    path = tmp_path / f"v{k}.tif"
    path.write_bytes(fx.tiff_mid_file(rgb, k))
    info = {}
    got = read_tiff(str(path), info)
    assert info[fx.TIFF_MID_KINDS[k]] > 0, info
    assert np.abs(got.astype(int) - rgb).mean() <= (0.5, 6.0, 0.0)[k]


# ------------------------------------- kinds the TIFF sweep found besides


@pytest.mark.parametrize("planar", [1, 2])
@pytest.mark.parametrize("bps", [8, 16])
@pytest.mark.parametrize("photometric", [0, 1, 3], ids=["white", "black",
                                                        "palette"])
def test_gray_and_palette_with_extra_samples_match_cv2(
        cv2, tmp_path, photometric, bps, planar):
    # gray: chunky through putgreytile / putagreytile / put16bitbwtile
    # (the first sample); in planes as RGB of three equal planes, its
    # second plane the alpha (neither inverted nor cut to the high byte);
    # palette: chunky 8-bit alone (put8bitcmaptile).  Tiles whose columns
    # the image's edge does not cut (ROADMAP §3)
    for spp, extra, tile in itertools.product(
            (2, 3, 4), (0, 1, 2), (None, (16, 16))):
        px = _noise((20, 32, spp), 1 << bps, seed=spp * 3 + extra)
        kw = dict(extra_samples=[extra] * (spp - 1))
        if photometric == 3:
            kw["colormap"] = _noise((1 << bps, 3), 1 << 16, seed=spp)
        info = _same_as_cv2(cv2, tmp_path / "extra.tif", fx.tiff_bytes(
            px, bps=bps, photometric=photometric, planar=planar, tile=tile,
            compression=5, **kw))
        assert (info is not None) == (photometric != 3 or (
            bps == 8 and planar == 1))


@pytest.mark.parametrize("bps,photometric,spp", [(16, 1, 1), (8, 1, 2),
                                                 (16, 0, 2), (8, 3, 2)])
def test_tiles_cut_at_the_edge_read_as_strips(cv2, tmp_path, bps,
                                              photometric, spp):
    # cv2's chunky gray and palette routines skip a cut tile's columns by
    # their count in bytes, not in samples (ROADMAP §3): the port reads
    # the tiles as it reads the strips, which cv2 reads
    px = _noise((20, 37, spp), 1 << bps, seed=13)
    kw = dict(bps=bps, photometric=photometric)
    if spp > 1:
        kw["extra_samples"] = [2]
    if photometric == 3:
        kw["colormap"] = _noise((256, 3), 1 << 16, seed=14)
    tiled = tmp_path / "tiled.tif"
    tiled.write_bytes(fx.tiff_bytes(px, tile=(16, 16), **kw))
    want = cv2.imread(str(tiled))
    got = read_tiff(str(tiled))
    assert not (got == want[..., ::-1]).all()
    assert _same_as_cv2(cv2, tmp_path / "strips.tif", fx.tiff_bytes(
        px, **kw)) is not None
    np.testing.assert_array_equal(got, read_tiff(str(tmp_path /
                                                     "strips.tif")))


@pytest.mark.parametrize("photometric,spp", [(2, 5), (2, 6), (5, 5),
                                             (1, 5)])
def test_more_than_four_samples_are_refused_as_cv2_refuses(
        cv2, tmp_path, photometric, spp):
    # OpenCV reads at most 4 samples a pixel; the port read RGB and CMYK
    # of 5 and 6 before
    base = {1: 1, 2: 3, 5: 4}[photometric]
    px = _noise((7, 9, spp), 256, seed=spp)
    for planar in (1, 2):
        assert _same_as_cv2(cv2, tmp_path / "many.tif", fx.tiff_bytes(
            px, photometric=photometric, planar=planar,
            extra_samples=[0] * (spp - base))) is None


def _with_counts(data: bytes, tag: int, delta: int) -> bytes:
    """A little-endian TIFF with each value of a LONG tag moved by delta."""
    import struct

    _, tags = image_io._tiff_directory(data, "x")
    ifd = struct.unpack_from("<I", data, 4)[0]
    out = bytearray(data)
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        entry = ifd + 2 + 12 * i
        t, _, count = struct.unpack_from("<HHI", data, entry)
        if t != tag:
            continue
        at = entry + 8 if count == 1 else struct.unpack_from(
            "<I", data, entry + 8)[0]
        for k in range(count):
            struct.pack_into("<I", out, at + 4 * k, tags[tag][k] + delta)
    return bytes(out)


@pytest.mark.parametrize("fill", [1, 2])
@pytest.mark.parametrize("tile", [(16, 16), (32, 32), (16, 64), (48, 16)])
def test_uncompressed_tile_byte_counts_match_cv2(cv2, tmp_path, tile, fill):
    # libtiff reads an uncompressed tile only where its byte count is the
    # tile's size, and under FillOrder 2 only where that is whole KiB (its
    # buffer's size); compressed tiles and strips take any count
    px = _noise((40, 40, 3), 256, seed=15)
    whole = tile[0] * tile[1] * 3 % 1024 == 0 or fill == 1
    for comp, delta in itertools.product((1, 5), (0, -1, 1, 100)):
        data = _with_counts(fx.tiff_bytes(px, tile=tile, fill_order=fill,
                                          compression=comp), 325, delta)
        path = tmp_path / "count.tif"
        if comp == 1 and fill == 2 and delta < 0 and whole:
            # cv2 reads a short tile that rounds up to whole KiB as other
            # samples than the file's (ROADMAP §3); the port refuses it
            path.write_bytes(data)
            with pytest.raises(ValueError, match="count.tif: an "
                                                 "uncompressed TIFF tile"):
                read_tiff(str(path))
            continue
        read = _same_as_cv2(cv2, path, data)
        if comp == 1:
            assert (read is not None) == (delta == 0 and whole)
        elif delta >= 0:
            assert read is not None
