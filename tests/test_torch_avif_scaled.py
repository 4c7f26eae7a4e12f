"""The port's AV1 decoder on frames predicted from references of another
size against cv2 5.0.0 (libavif 1.4.2 over libaom 3.14.1) bit for bit:
libaom's own good-quality encoder with its ``resize`` (inter frames coded
smaller than the key frame) and ``superres`` (inter frames, key frames or
both coded narrower and upscaled) controls (``torch_avif_oracles.
libaom_encode_frames`` through its C API), at 8, 10 and 12 bits in every
chroma format, at denominators 9 and 16 (16: a reference twice the frame,
libaom's limit); compound and OBMC blocks beside a scaled reference;
global motion that a scaled reference turns into a translation; a
reference beyond libaom's limits (cv2 refuses the file, and so does the
port).  Each file is also shown to use what it is there for by the
decoder's counters (``torch_make_image_fixtures.scaled_info``).

The predictor from a scaled reference is held to libaom's
``av1_convolve_2d_scale_c`` and ``av1_highbd_convolve_2d_scale_c`` by ELF
symbol, its scale factors to ``av1_setup_scale_factors_for_frame`` and its
positions to ``av1_scale_mv``.  The committed files (``tests/
torch_images/``, written by ``torch_make_image_fixtures.py --scaled``)
need no cv2.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif

import torch_avif_oracles as oracle
import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _same_as_cv2(cv2, tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want is not None, name
    np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])


def _every_frame_as_cv2(cv2, tmp_path, name, data):
    """The file and each of its cuts after a temporal unit against cv2
    (fx.temporal_units): every frame shown is held to libaom's."""
    for k, item in enumerate(fx.temporal_units(data)):
        _same_as_cv2(cv2, tmp_path, f"{k}_{name}", item)


# ------------------------------------------------ the stages by symbol


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("compound", [False, True])
def test_scale_convolve_matches_libaom(depth, compound):
    # random phases, steps from 1/2x to 2x (512-2048 at 1/1024), every
    # filter pair, widths and heights 2-128 (the 4-tap rule at 4 and less),
    # samples and the compound intermediate precision
    rng = np.random.default_rng(depth * 2 + compound)
    sizes = [2, 4, 8, 16, 32, 64, 128]
    for k in range(48):
        w = sizes[k % 7] if k < 14 else int(rng.integers(2, 129))
        h = sizes[k // 7 % 7] if k < 14 else int(rng.integers(2, 129))
        fx_, fy_ = k % 4, k // 4 % 4
        xs, ys = (int(rng.integers(512, 2049)) for _ in range(2))
        if k % 5 == 0:
            xs, ys = 2048, 512
        sx, sy = (int(rng.integers(0, 1024)) for _ in range(2))
        shape = oracle.scale_src_shape(w, h, sx, xs, sy, ys)
        src = rng.integers(0, 1 << depth, shape)
        if k % 6 == 0:                     # extremes: the rounding's edges
            src = (rng.integers(0, 2, shape) * ((1 << depth) - 1))
        want = oracle.libaom_scale_convolve(src, w, h, fx_, fy_, sx, xs, sy,
                                            ys, depth, compound)
        got = oracle.port_scale_convolve(src, w, h, fx_, fy_, sx, xs, sy,
                                         ys, depth, compound)
        np.testing.assert_array_equal(got, want, err_msg=str(
            (w, h, fx_, fy_, sx, xs, sy, ys)))


def test_scale_factors_match_libaom():
    # the scales and steps of a reference's size over the frame's, and
    # libaom's limits (twice the frame, a sixteenth of it) either side
    rng = np.random.default_rng(3)
    cases = [(100, 72, 50, 36), (100, 72, 49, 36), (100, 72, 50, 35),
             (16, 16, 256, 256), (16, 16, 257, 256), (16, 16, 256, 257),
             (1297, 840, 865, 560), (65536, 2, 32768, 1), (1, 1, 16, 16)]
    for _ in range(300):
        w, h = (int(rng.integers(1, 4000)) for _ in range(2))
        rw = int(w * rng.uniform(0.05, 2.2)) + 1
        rh = int(h * rng.uniform(0.05, 2.2)) + 1
        cases.append((rw, rh, w, h))
    for rw, rh, w, h in cases:
        want = oracle.libaom_scale_factors(rw, rh, w, h)
        got, valid = oracle.port_scale_factors(rw, rh, w, h)
        assert valid == (want[0] != -1), (rw, rh, w, h, want)
        if valid:
            assert got == want, (rw, rh, w, h)


def test_scaled_positions_match_libaom():
    # the block's position at 1/1024 of a reference sample: scaled_x of
    # its position at 1/16 plus the MV, less that of the position alone,
    # as av1_scale_mv gives it, over scales from 1/16x to 2x
    rng = np.random.default_rng(4)
    for _ in range(2000):
        xs, ys = (int(rng.integers(1024, 32769)) for _ in range(2))
        x, y = (int(rng.integers(0, 4096)) for _ in range(2))
        row, col = (int(rng.integers(-(1 << 14) + 1, 1 << 14))
                    for _ in range(2))
        want = oracle.libaom_scale_mv(row, col, x, y, xs, ys)
        got = (oracle.port_scaled_position(16 * y + row, ys)
               - oracle.port_scaled_position(16 * y, ys),
               oracle.port_scaled_position(16 * x + col, xs)
               - oracle.port_scaled_position(16 * x, xs))
        assert got == want, (row, col, x, y, xs, ys)


# ---------------------------------------------- libaom's files and cv2


_FORMATS = fx.AVIF_TOOLS_FORMATS


@pytest.mark.parametrize("depth,fmt", _FORMATS,
                         ids=[f"d{d}_{f}" for d, f in _FORMATS])
def test_resized_frames_match_cv2(cv2, tmp_path, depth, fmt):
    # a key frame, then inter frames libaom codes at 8/d of its size (d 9
    # and 16 in turn): every frame shown against cv2, scaled prediction
    # counted
    d = 16 if _FORMATS.index((depth, fmt)) % 2 else 9
    data = fx.scaled_item(np.random.default_rng(depth * 7 + len(fmt)),
                          depth, fmt, resize=(1, d, 8))
    _every_frame_as_cv2(cv2, tmp_path, "resize.avif", data)
    assert fx.scaled_info(data)[0] > 0


@pytest.mark.parametrize("kind", list(fx.AVIF_SUPERRES_KINDS))
@pytest.mark.parametrize("d", [9, 16])
def test_superres_frames_match_cv2(cv2, tmp_path, kind, d):
    # superres in inter frames (predicting at a scale from references of
    # their own upscaled size), in key frames, or both
    depth, fmt = _FORMATS[(d + len(kind)) % len(_FORMATS)]
    data = fx.scaled_item(np.random.default_rng(d), depth, fmt,
                          superres=fx.AVIF_SUPERRES_KINDS[kind](d))
    _every_frame_as_cv2(cv2, tmp_path, "superres.avif", data)
    t = fx.scaled_info(data)
    if kind == "key":
        assert t[4] > 0 and t[0] == 0, t
    else:
        assert t[1] > 0 and t[0] > 0, t


def test_scaled_references_in_grid_alpha_and_track(cv2, tmp_path):
    # resized frames as a grid's tiles, as an alpha item (4:0:0) and as a
    # sequence track's first sample
    h, w = 64, 96
    r = np.random.default_rng(12)

    def item(fmt):
        img = oracle.avif_image("photo", h, w, r)
        return fx.inter_item(fx.inter_frames(img, 3, 2, -3), 8, fmt,
                             controls={"cpu-used": 5}, resize=(1, 12, 8))
    colour, alpha = item("420"), item("400")
    tile = oracle.tile_item(colour)
    _same_as_cv2(cv2, tmp_path, "grid.avif",
                 oracle.grid_avif([tile, tile], 1, 2, 2 * w, h))
    _same_as_cv2(cv2, tmp_path, "alpha.avif",
                 oracle.alpha_file(colour, alpha, False))
    obu, props = oracle.item_parts(colour)
    _same_as_cv2(cv2, tmp_path, "track.avif",
                 oracle.build_sequence([obu], props, w, h))


def test_reference_beyond_twice_the_frame_fails_as_cv2(cv2, tmp_path):
    # libaom's resize to half the key frame's width (error resilient: the
    # frame's size in its header), the last frame's width rewritten: at
    # half the reference's width it decodes, one sample less makes the
    # reference more than twice the frame and libaom refuses the file
    img = oracle.avif_image("photo", 72, 100, np.random.default_rng(26))
    stream = oracle.libaom_encode_frames(
        [fx.inter_planes(f, 8, "420") for f in fx.inter_frames(img, 4, 2,
                                                               -3)],
        8, 1, 1, resize=(1, 16, 8), controls={
            "cpu-used": 4, "error-resilient-mode": 1})
    for width in (50, 51):
        _same_as_cv2(cv2, tmp_path, f"w{width}.avif", fx.inter_avif(
            oracle.with_frame_size(stream, width, 36), 100, 72, 8, "420"))
    for width in (49, 40):
        path = tmp_path / f"w{width}.avif"
        path.write_bytes(fx.inter_avif(oracle.with_frame_size(
            stream, width, 36), 100, 72, 8, "420"))
        assert cv2.imread(str(path)) is None
        with pytest.raises(RuntimeError, match=f"w{width}.avif: AV1 data "
                           "cv2 does not read: a reference frame with "
                           "invalid dimensions"):
            read_avif(str(path))


def test_frames_of_another_width_in_the_same_grid(cv2, tmp_path):
    # a frame's width rewritten within its 8-sample mi grid: the tile data
    # decodes as before, every reference now at another scale; a width
    # past the sequence's maximum too (libaom holds the maximum only where
    # the header reads the size without found_ref)
    with open(os.path.join(fx.FOLDER, "avif_unported_global.avif"),
              "rb") as f:
        units = fx.temporal_units(f.read())
    for k, unit in enumerate(units[1:3]):
        obu, props = oracle.item_parts(unit)
        w, h = struct.unpack_from(">II", props[b"ispe"], 12)
        assert (w + 7) >> 3 == (w + 8) >> 3 == (w + 4) >> 3
        for width in (w - 1, w - 3, w + 1):
            data = oracle.build_avif(oracle.with_frame_size(obu, width, h),
                                     props)
            _same_as_cv2(cv2, tmp_path, f"{k}_{width}.avif", data)
            assert fx.scaled_info(data)[0] > 0


# ------------------------------------------------- the committed files


# what each committed file's scaled_info must show: the kind it is there
# for (its last frame's, where it was cut after it)
def _uses(name, t):
    if name == "avif_unported_superres_ref.avif" or \
            name.startswith("avif_superres_key_"):
        return t[4] > 0
    if name == "avif_unported_superres_inter.avif" or \
            name.startswith("avif_superres_"):
        return t[0] > 0 and t[1] > 0
    if name == "avif_unported_switch.avif":
        return t[2] > 0
    return t[{"avif_scaled_compound.avif": 5, "avif_scaled_obmc.avif": 6,
              "avif_scaled_global.avif": 3}.get(name, 0)] > 0


_COMMITTED = [n for n in fx.AVIF_SCALED_CASES
              if n != "avif_unported_switch.avif"]


@pytest.mark.parametrize("name", _COMMITTED)
def test_committed_scaled_fixtures_match_cv2(name):
    # no cv2 here: the decode is cv2's recorded one
    got = read_avif(os.path.join(fx.FOLDER, name))
    want = image_io.read_png(os.path.join(fx.FOLDER, fx._want(name)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", _COMMITTED)
def test_committed_scaled_fixtures_use_their_kinds(name):
    # the decoder's counters show the kind each file is there for; the
    # frame past the sequence's maximum is one sample wider than it
    with open(os.path.join(fx.FOLDER, name), "rb") as f:
        data = f.read()
    if name == "avif_scaled_over_max.avif":
        heif = image_io._Heif(data, name)
        heif.parse()
        info = image_io.decode_av1(heif.primary_item()[0])[1]
        assert info[0] == 126 and info[73] > 0, info[:2] + info[73:]
        return
    t = fx.scaled_info(data)
    assert _uses(name, t), t


def test_committed_reference_too_large_is_refused():
    # no cv2 here: cv2 returns None for it (torch_make_image_fixtures
    # --scaled checks); the port fails naming the file and libaom's reason
    name = fx.AVIF_SCALED_REFUSED[0]
    with pytest.raises(RuntimeError, match=f"{name}: AV1 data cv2 does not "
                       "read: a reference frame with invalid dimensions"):
        read_avif(os.path.join(fx.FOLDER, name))
