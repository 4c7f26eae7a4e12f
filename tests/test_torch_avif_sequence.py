"""The port's AVIF reader on image sequences (``avis``) and on the AV1 tools
libaom's good-quality mode adds, against cv2 5.0.0 (libavif 1.4.2, libaom
3.14.1, libyuv 1924) bit for bit, or both refuse (cv2 returns None; the
port raises naming the file).

Pillow writes a sequence with ``save_all=True``: a ``moov`` whose track's
first sample is a temporal unit of a full sequence header and a shown key
frame.  libaom's good-quality mode codes loop restoration at speeds up to
4 and segmentation with ``aq-mode=1``.  The tests hold: Pillow's sequences
at speeds 2-6 with and without ``aq-mode=1``, every subsampling and RGBA,
to cv2, and their planes to libavif's; the container layouts libavif
meets (brands, the order of ``meta`` and ``moov``, chunks, ``co64``,
``stss``, edit lists, a sample past the end), each with cv2's verdict; the
loop restoration filters alone against libaom's own
``av1_(highbd_)wiener_convolve_add_src_c`` and
``av1_apply_selfguided_restoration_c`` by ELF symbol at 8, 10 and 12 bits;
still items whose reduced headers are rewritten as full ones (timing and
decoder model info, operating points, frame ids, order hints, OBU
extensions outside operating point 0); and the data's later frames, of
which libaom outputs the last one shown.
"""

import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif, read_image

import torch_avif_oracles as oracle

# decode_av1's info: tiles, 128x128 superblocks; loop restoration's frame
# types (Y, U, V), Wiener and self-guided units; segmentation, blocks of
# segments 0 and 1
TILES, SB128, LR_TYPES, WIENER, SGRPROJ, SEG, SEG0, SEG1 = (
    slice(10, 12), 12, slice(26, 29), 29, 30, 31, 32, 33)


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


def _first_frame(data: bytes):
    """(planes, info) of the port's decode of a sequence's first sample."""
    heif = image_io._Heif(data, "file")
    heif.parse()
    assert heif.source == "tracks"
    return image_io.decode_av1(heif.track_image(heif.colour_track()[0])[0])


# ------------------------------------------------- Pillow's sequences


@pytest.mark.parametrize("aq", [False, True])
@pytest.mark.parametrize("speed", [2, 3, 4, 5, 6])
def test_pillow_sequences_match_cv2(cv2, pil, tmp_path, speed, aq):
    img = oracle.avif_image("photo", 96, 128, np.random.default_rng(speed))
    opts = dict(speed=speed)
    if aq:
        opts["advanced"] = {"aq-mode": "1"}
    data = oracle.pillow_sequence(img, **opts)
    assert data[8:12] == b"avis" and b"moov" in data
    assert _same_as_cv2(cv2, tmp_path / f"s{speed}.avif", data)
    info = _first_frame(data)[1]
    assert bool(info[SEG]) == aq      # aq-mode=1 enables segmentation
    if speed >= 5:                    # libaom keeps restoration off
        assert not any(info[LR_TYPES])


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:2:2", "4:0:0"])
def test_subsamplings_match_cv2(cv2, pil, tmp_path, sub):
    img = oracle.avif_image("photo", 120, 160, np.random.default_rng(3))
    data = oracle.pillow_sequence(img, speed=3, subsampling=sub)
    assert _same_as_cv2(cv2, tmp_path / "sub.avif", data)


def test_tools_in_use(cv2, pil, tmp_path):
    # the tools libaom's good-quality mode codes, shown in use through
    # decode_av1's counts: Wiener, self-guided and switchable frames and
    # units, 128x128 superblocks (lr_unit_shift's other form), segments
    img = oracle.avif_image("photo", 416, 640, np.random.default_rng(0))
    seen = dict(wiener=0, sgrproj=0, switchable=0, sb128=0, segments=0)
    for opts in (dict(speed=2), dict(speed=3, advanced={"sb-size": "128"}),
                 dict(speed=4, advanced={"aq-mode": "1"})):
        data = oracle.pillow_sequence(img, **opts)
        assert _same_as_cv2(cv2, tmp_path / "tools.avif", data)
        info = _first_frame(data)[1]
        seen["wiener"] += info[WIENER]
        seen["sgrproj"] += info[SGRPROJ]
        seen["switchable"] += 3 in info[LR_TYPES]
        seen["sb128"] += info[SB128]
        seen["segments"] += info[SEG0] > 0 and info[SEG1] > 0
    assert all(seen.values()), seen


def test_planes_match_libavif(cv2, pil):
    # the first frame before colour conversion, as libavif decodes it
    rng = np.random.default_rng(4)
    for opts in (dict(speed=2), dict(speed=4, subsampling="4:4:4"),
                 dict(speed=3, advanced={"aq-mode": "1"})):
        img = oracle.avif_image("photo", 144, 176, rng)
        data = oracle.pillow_sequence(img, **opts)
        want = oracle.libavif_planes(data)[0]
        got = _first_frame(data)[0]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sub", ["4:2:0", "4:0:0"])
def test_rgba_sequences_match_cv2(cv2, pil, tmp_path, sub):
    # an alpha track (auxl to the colour track): decoded and checked, then
    # dropped; a gray image with alpha is refused as OpenCV refuses it
    img = oracle.avif_image("photo", 80, 112, np.random.default_rng(6))
    alpha = np.random.default_rng(7).integers(0, 256, img.shape[:2],
                                              np.uint8)
    data = oracle.pillow_sequence(np.dstack([img, alpha]), speed=4,
                                  subsampling=sub)
    assert len(oracle.sequence_parts(data)) == 2
    assert _same_as_cv2(cv2, tmp_path / "rgba.avif", data) == \
        (sub == "4:2:0")


# ---------------------------------------------- the container's rules


def _two_frames():
    """Two samples that are each a key frame of its own image (A, B), and
    the colour track's sample entry properties."""
    rng = np.random.default_rng(3)
    a = oracle.avif_image("photo", 96, 128, rng)
    b = oracle.avif_image("smooth", 96, 128, rng)
    sa, props, w, h, _ = oracle.sequence_parts(oracle.pillow_sequence(a))[0]
    sb = oracle.sequence_parts(oracle.pillow_sequence(b))[0][0]
    return [sa[0], sb[0]], props, w, h


_LAYOUTS = {
    # (build_sequence's options, which frame cv2 gives: A, B or None)
    "major_avif_item_second": (dict(major=b"avif", item_sample=1), "B"),
    "major_avis_item_second": (dict(major=b"avis", item_sample=1), "A"),
    "major_mif1": (dict(major=b"mif1", item_sample=1), "A"),
    "major_mif1_avif_only": (dict(major=b"mif1", compat=(b"avif", b"mif1"),
                                  item_sample=1), "B"),
    "avis_only_no_meta": (dict(compat=(b"avis", b"msf1"), meta=False), "A"),
    "moov_first": (dict(moov_first=True), "A"),
    "moov_first_major_avif": (dict(moov_first=True, major=b"avif",
                                   item_sample=1), "B"),
    "no_moov": (dict(moov=False), None),
    "no_moov_major_avif": (dict(moov=False, major=b"avif"), None),
    "moov_without_meta": (dict(meta=False), None),
    "sample_past_end": (dict(past_end=10000), None),
    "co64": (dict(co64=True), "A"),
    "chunks_1_1": (dict(chunks=[1, 1]), "A"),
    "stss_not_first": (dict(stss=(2,)), "A"),
    "no_stss": (dict(stss=None), "A"),
    "no_edts": (dict(edts=False), "A"),
    "no_edts_duration_0": (dict(edts=False, duration=0), "A"),
    "repeating_duration_0": (dict(duration=0), None),
    "entry_av02": (dict(entry=b"av02"), None),
    "second_track_not_alpha": (dict(alpha="other"), "A"),
}


@pytest.mark.parametrize("layout", list(_LAYOUTS))
def test_container_layouts_match_cv2(cv2, pil, tmp_path, layout):
    samples, props, w, h = _two_frames()
    opts, frame = _LAYOUTS[layout]
    if opts.get("alpha") == "other":
        opts = dict(opts, alpha=([samples[1], samples[1]], props))
    refs = {k: cv2.imdecode(np.frombuffer(oracle.build_sequence(
        samples, props, w, h, major=b"avif", item_sample=i), np.uint8), 1)
        for k, i in (("A", 0), ("B", 1))}
    data = oracle.build_sequence(samples, props, w, h, **opts)
    read = _same_as_cv2(cv2, tmp_path / f"{layout}.avif", data)
    assert read == (frame is not None)
    if read:
        np.testing.assert_array_equal(
            read_avif(str(tmp_path / f"{layout}.avif")), refs[frame][..., ::-1])


def test_track_scaled_is_not_read_yet(cv2, pil, tmp_path):
    # libavif scales a frame to its track header's size (avif_scale); the
    # port reads it as cv2 does
    samples, props, w, h = _two_frames()
    path = tmp_path / "scaled.avif"
    path.write_bytes(oracle.build_sequence(samples, props, w, h,
                                           tkhd_size=(64, 48)))
    assert cv2.imread(str(path)).shape == (48, 64, 3)
    np.testing.assert_array_equal(read_avif(str(path)),
                                  cv2.imread(str(path))[..., ::-1])


# ----------------------------------------- loop restoration, by symbol


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["wiener", "selfguided"])
def test_restoration_filters_match_libaom(cv2, kind, depth):
    rng = np.random.default_rng(depth)
    top = (1 << depth) - 1
    for trial in range(40):
        h, w = (int(x) for x in rng.integers(1, 65, 2))
        if trial % 2:
            src = rng.integers(0, top + 1, (h + 7, w + 7))
        else:       # smooth, with the extremes clipped
            src = np.clip(np.cumsum(rng.integers(-40, 41, (h + 7, w + 7)),
                                    1) + (top >> 1), 0, top)
        if kind == "wiener":
            taps = [[int(rng.integers(-5, 11)), int(rng.integers(-23, 9)),
                     int(rng.integers(-17, 47))] for _ in range(2)]
            want = oracle.libaom_wiener(src, taps, depth)
            got = oracle.port_wiener(src, taps, depth)
        else:
            sgr = int(rng.integers(0, 16))
            xqd = [int(rng.integers(-96, 32)), int(rng.integers(-32, 96))]
            if oracle.SGR_RADII[sgr][0] == 0:
                xqd[0] = 0
            if oracle.SGR_RADII[sgr][1] == 0:
                xqd[1] = int(np.clip(128 - xqd[0], -32, 95))
            want = oracle.libaom_selfguided(src[:h + 6, :w + 6], sgr, xqd,
                                            depth)
            got = oracle.port_selfguided(src[:h + 6, :w + 6], sgr, xqd,
                                         depth)
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------ full headers


_FULL = {
    "plain": dict(),
    "not_still": dict(still=0),
    "timing": dict(timing=True),
    "decoder_model": dict(timing=True, decoder_model=True),
    "frame_ids": dict(frame_ids=True),
    "no_order_hint": dict(order_hint_bits=0),
    "display_delay": dict(display_delay=True),
    "two_operating_points": dict(ops=((0x103, None), (0x101, 8))),
    "extension_in_point": dict(ops=((0x103, None),), extension=(0, 0)),
    "extension_spatial_out": dict(ops=((0x102, None),), extension=(0, 0)),
    "extension_temporal_out": dict(ops=((0x101, None),), extension=(1, 0)),
    "extension_point_idc_0": dict(extension=(1, 1)),
    "level_undefined": dict(ops=((0, 6),)),
    "level_5_2": dict(ops=((0, 14),)),
    "show_existing_frame": dict(frame_kind="1000"),
    "intra_only_frame": dict(frame_kind="0101"),
    "inter_frame": dict(frame_kind="0011"),
    "hidden_key_frame": dict(still=0, frame_kind="0000"),
}


@pytest.mark.parametrize("source", ["cv2", "screen"])
@pytest.mark.parametrize("variant", list(_FULL))
def test_full_headers_match_cv2(cv2, pil, tmp_path, variant, source):
    # still items whose reduced headers are rewritten as full ones; OBUs
    # whose extension lies outside operating point 0 are dropped (then no
    # frame is left); frames other than a shown key frame first raise
    rng = np.random.default_rng(5)
    if source == "cv2":
        data = oracle.cv2_avif(oracle.avif_image("photo", 40, 56, rng))
    else:
        data = oracle.pillow_avif(oracle.screen_image("text", 64, 64, rng),
                                  advanced={"tune-content": "screen"})
    stream, props = oracle.item_parts(data)
    path = tmp_path / f"{variant}.avif"
    path.write_bytes(oracle.build_avif(
        oracle.full_headers(stream, **_FULL[variant]), props))
    want = cv2.imread(str(path))
    try:
        got = read_avif(str(path))
    except RuntimeError as err:
        assert path.name in str(err)
        assert want is None or "not read yet" in str(err), str(err)
        assert variant in ("extension_spatial_out", "extension_temporal_out",
                           "level_undefined", "show_existing_frame",
                           "intra_only_frame", "inter_frame",
                           "hidden_key_frame")
        return
    assert want is not None
    np.testing.assert_array_equal(got, want[..., ::-1])


# --------------------------------------------- the data's later frames


@pytest.mark.parametrize("layout", ["frame_obu", "temporal_unit",
                                    "delimiter_then_unit", "zero_bytes"])
def test_last_shown_frame_is_the_image(cv2, tmp_path, layout):
    # libaom decodes every frame of the data and outputs the last one
    # shown: a still item whose data holds a second key frame reads as it
    rng = np.random.default_rng(3)
    a = oracle.avif_image("photo", 40, 56, rng)
    b = oracle.avif_image("smooth", 40, 56, rng)
    sa, props = oracle.item_parts(oracle.cv2_avif(a))
    sb, _ = oracle.item_parts(oracle.cv2_avif(b))
    frame_b = oracle.obu(6, oracle.obus(sb)[-1][2])
    stream = {"frame_obu": sa + frame_b, "temporal_unit": sa + sb,
              "delimiter_then_unit": sa + oracle.obu(2, b"") + sb,
              "zero_bytes": sa + bytes(3)}[layout]
    assert _same_as_cv2(cv2, tmp_path / "two.avif",
                        oracle.build_avif(stream, props))
    want = cv2.imdecode(np.frombuffer(oracle.build_avif(
        sa if layout == "zero_bytes" else sb, props), np.uint8), 1)
    np.testing.assert_array_equal(read_avif(str(tmp_path / "two.avif")),
                                  want[..., ::-1])


def test_inter_frame_after_the_key_frame_is_not_read_yet(cv2, pil,
                                                         tmp_path):
    # Pillow's second sample is an inter frame: in the first sample's data
    # libaom decodes it on the key frame; Pillow's (libaom's default inter
    # tools: the motion field projected, use_ref_frame_mvs) is read since
    # the inter tools' slice, as cv2 reads it
    img = oracle.avif_image("photo", 96, 128, np.random.default_rng(3))
    samples, props, w, h, _ = oracle.sequence_parts(
        oracle.pillow_sequence(img))[0]
    inter = oracle.obu(6, oracle.obus(samples[1])[-1][2])
    path = tmp_path / "inter.avif"
    path.write_bytes(oracle.build_sequence([samples[0] + inter, samples[1]],
                                           props, w, h))
    want = cv2.imread(str(path))
    assert want is not None
    np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])


@pytest.mark.parametrize("copy", ["frame_header_twice", "redundant_same",
                                  "redundant_differs"])
def test_frame_header_copies_match_cv2(cv2, tmp_path, copy):
    # a frame header OBU and its tile group: libaom refuses a second frame
    # header OBU before the frame's tiles, and a redundant frame header
    # (OBU type 7) that is not a copy of the frame's
    from test_torch_avif import _split_frame

    img = oracle.avif_image("photo", 40, 56, np.random.default_rng(13))
    stream, props = oracle.item_parts(oracle.cv2_avif(img))
    parts = [(k, p) for k, _, p in oracle.obus(_split_frame(stream, props))]
    kinds = [k for k, _ in parts]
    assert kinds == [1, 3, 4]
    fh = parts[1][1]
    extra = {"frame_header_twice": (3, fh), "redundant_same": (7, fh),
             "redundant_differs": (7, bytes([fh[0] ^ 1]) + fh[1:])}[copy]
    stream = b"".join(oracle.obu(k, p) for k, p in
                      parts[:2] + [extra] + parts[2:])
    assert _same_as_cv2(cv2, tmp_path / f"{copy}.avif", oracle.build_avif(
        stream, props)) == (copy == "redundant_same")
