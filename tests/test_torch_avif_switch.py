"""The port's AV1 decoder on switch frames (``frame_type`` 3) against cv2
5.0.0 (libavif 1.4.2 over libaom 3.14.1) bit for bit.  libaom's encoder
writes none (its ``sframe_dist`` and ``AOM_EFLAG_SET_S_FRAME`` make
none in 3.14.1), so each is an error resilient inter frame of libaom's own
encoder rewritten as a switch frame (``torch_avif_oracles.
switch_last_frame``: error_resilient_mode, frame_size_override_flag and
refresh_frame_flags implied, its size written), at 8, 10 and 12 bits in
every chroma format; the decoder counts the switch frames it read.

A slot's ``ref_order_hint`` rewritten (``torch_avif_oracles.
with_ref_order_hint``) is what libaom repairs with a neutral-grey buffer:
cv2 reads such files, and so does the port (``test_torch_avif_rebuilt.py``
holds every kind of it).  The committed files (``tests/torch_images/``,
written by ``torch_make_image_fixtures.py --scaled``) need no cv2.
"""

import os

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


def _stream(seed, depth, fmt, n=3, size=(56, 80), **controls):
    """libaom's error resilient stream of n frames of a photo crop (the
    last translated and in part darkened)."""
    rng = np.random.default_rng(seed)
    img = oracle.avif_image("photo", *size, rng)
    sx, sy = {"420": (1, 1), "422": (1, 0), "444": (0, 0),
              "400": (1, 1)}[fmt]
    return oracle.libaom_encode_frames(
        [fx.inter_planes(f, depth, fmt) for f in fx.inter_frames(
            img, n, 2, -3)], depth, sx, sy, mono=fmt == "400", controls={
                "cpu-used": 5, "cq-level": 30, "error-resilient-mode": 1,
                **controls})


def _switch_count(data):
    heif = image_io._Heif(data, "switch")
    heif.parse()
    return image_io.decode_av1(heif.primary_item()[0])[1][75]


_FORMATS = fx.AVIF_TOOLS_FORMATS


@pytest.mark.parametrize("depth,fmt", _FORMATS,
                         ids=[f"d{d}_{f}" for d, f in _FORMATS])
def test_switch_frames_match_cv2(cv2, tmp_path, depth, fmt):
    # the last frame of an error resilient stream as a switch frame, and
    # the stream as libaom wrote it: both as cv2 reads them
    stream = _stream(depth * 5 + len(fmt), depth, fmt)
    h, w = 56, 80
    for name, s in (("plain.avif", stream),
                    ("switch.avif", oracle.switch_last_frame(stream))):
        data = fx.inter_avif(s, w, h, depth, fmt)
        path = tmp_path / name
        path.write_bytes(data)
        want = cv2.imread(str(path))
        assert want is not None, name
        np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])
        assert _switch_count(data) == (name == "switch.avif")


def test_switch_frame_with_every_inter_tool(cv2, tmp_path):
    # a switch frame of libaom's default inter tools (motion-field
    # projection is off in error resilient frames; OBMC, inter-intra,
    # global motion and compound stay on), four frames, film grain off
    for seed in range(3):
        stream = _stream(100 + seed, 8, "420", n=4, size=(72, 104),
                         **{"cpu-used": 2})
        data = fx.inter_avif(oracle.switch_last_frame(stream), 104, 72, 8,
                             "420")
        path = tmp_path / f"switch_{seed}.avif"
        path.write_bytes(data)
        want = cv2.imread(str(path))
        assert want is not None
        np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])
        assert _switch_count(data) == 1


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_rebuilt_slots_are_refused_as_cv2_reads_them(cv2, tmp_path, depth):
    # one slot's ref_order_hint rewritten in the last frame, a slot its
    # references name or one they do not: cv2 reads the file (libaom
    # rebuilds the slot as a neutral-grey buffer), and the port reads it as
    # cv2 does, counting the slot rebuilt and, where named, the blocks that
    # predict from it
    stream = _stream(depth, depth, "420")
    order, idx = oracle.ref_order_hints(stream)
    for slot in (idx[0], max(set(range(8)) - set(idx))):
        path = tmp_path / f"slot{slot}.avif"
        data = fx.inter_avif(oracle.with_ref_order_hint(
            stream, slot, order[slot] + 1), 80, 56, depth, "420")
        path.write_bytes(data)
        want = cv2.imread(str(path))
        assert want is not None
        np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])
        info = fx.rebuilt_info(data)
        assert info[0] == 1 and (info[2] > 0) == (slot == idx[0])


def test_committed_switch_file_matches_cv2():
    # no cv2 here: the inter slice's refused switch file, read as cv2 read
    # it, its switch frame counted
    name = "avif_unported_switch.avif"
    path = os.path.join(fx.FOLDER, name)
    np.testing.assert_array_equal(read_avif(path), image_io.read_png(
        os.path.join(fx.FOLDER, fx._want(name))))
    with open(path, "rb") as f:
        assert _switch_count(f.read()) == 1
