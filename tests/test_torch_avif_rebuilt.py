"""The port's AV1 decoder on reference slots libaom rebuilds from
``ref_order_hint``, against cv2 5.0.0 (libavif 1.4.2 over libaom 3.14.1)
bit for bit.

An error resilient frame signals each slot's order hint; where a slot's
differs (or the slot is empty), libaom's ``read_uncompressed_header``
takes the first free buffer of its pool (16 buffers, after the one the
frame itself took), reallocates it at the sequence's maximum frame size,
fills its crop area with neutral grey and puts it in the slot with that
order hint, valid for referencing.  Every other field of the buffer stays
as the last frame decoded into it left it (a buffer no frame was decoded
into has none: libaom then refuses its entropy context, its film grain, its
colour format and a show_existing_frame of it).  No writer makes such
files, so each is libaom's own stream (``torch_avif_oracles.
libaom_encode_frames``) with one frame's hint rewritten (``torch_avif_
oracles.with_ref_order_hint``; ``torch_make_image_fixtures.rebuilt_item``,
``rebuilt_shown``): a slot the last frame's references name (at the
maximum size, and resized to half of it: the grey slot a 2x reference),
one they do not name, one that a later frame without error resilience
reads through its primary reference frame or a motion-field projection,
slots no frame filled (an error resilient intra-only frame first), a
slot beyond libaom's 2x limit, and a show_existing_frame of a rebuilt
slot; at 8, 10 and 12 bits in 4:2:0, 4:4:4 and 4:0:0.  The decoder counts
the slots it rebuilt, the frames and blocks that read them and the reads
of what a rebuilt buffer kept (``rebuilt_info``).  The committed files
(``tests/torch_images/``, written by ``torch_make_image_fixtures.py
--rebuilt``) need no cv2.
"""

import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_avif, read_png

import torch_avif_oracles as oracle
import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


_FORMATS = [(d, f) for d in (8, 10, 12) for f in ("420", "444", "400")
            if (d, f) != (12, "400")]
_IDS = [f"d{d}_{f}" for d, f in _FORMATS]


def _item(seed, depth, fmt, kind):
    """rebuilt_item of the first seed from ``seed`` that has a slot of the
    kind (a leftover read needs a buffer that held a decoded frame)."""
    for s in range(seed, seed + 20):
        data = fx.rebuilt_item(np.random.default_rng(s), depth, fmt, kind)
        if data is not None:
            return data
    raise AssertionError(f"no {kind} file of 20 seeds")


def _verdict(cv2, tmp_path, data, name="rebuilt.avif"):
    """"equal" where the port reads the file as cv2 does, "refused" where
    both refuse it (the port naming the file); fails otherwise."""
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    try:
        got = read_avif(str(path))
    except RuntimeError as err:
        assert name in str(err), str(err)
        assert want is None, f"cv2 reads what the port refuses: {err}"
        return "refused"
    assert want is not None, "the port reads what cv2 refuses"
    np.testing.assert_array_equal(got, want[..., ::-1])
    return "equal"


@pytest.mark.parametrize("depth,fmt", _FORMATS, ids=_IDS)
def test_named_slot_rebuilt_matches_cv2(cv2, tmp_path, depth, fmt):
    # (a) a slot the last frame's references name, rebuilt grey at the
    # frame's own size: blocks predict from it
    data = _item(depth, depth, fmt, "named")
    assert _verdict(cv2, tmp_path, data) == "equal"
    rebuilt, named, blocks, _, frames = fx.rebuilt_info(data)
    assert rebuilt == 1 and named == 1 and blocks > 0 and frames == 3


@pytest.mark.parametrize("depth,fmt", _FORMATS, ids=_IDS)
def test_rebuilt_slot_as_a_scaled_reference(cv2, tmp_path, depth, fmt):
    # (b) the same with the inter frames resized to half the key frame's
    # size: the grey slot, at the sequence's maximum size, is a 2x
    # reference that blocks predict from through the scaled predictor
    data = _item(depth + 1, depth, fmt, "scaled")
    assert _verdict(cv2, tmp_path, data) == "equal"
    assert fx.rebuilt_info(data)[2] > 0 and fx.scaled_info(data)[0] > 0


@pytest.mark.parametrize("depth,fmt", _FORMATS, ids=_IDS)
def test_rebuilt_state_read_by_a_later_frame(cv2, tmp_path, depth, fmt):
    # (c) a slot rebuilt in an earlier error resilient frame, whose buffer
    # held a decoded frame: a later frame without error resilience reads
    # what it kept (its entropy context, segmentation and loop filter
    # deltas as primary reference frame, or its motion field, frame type,
    # mi grid and saved order hints as a projection's source)
    data = _item(depth + 2, depth, fmt, "leftover")
    assert _verdict(cv2, tmp_path, data) == "equal"
    assert fx.rebuilt_info(data)[3] > 0


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_unnamed_slot_rebuilt_matches_cv2(cv2, tmp_path, depth):
    # a slot no reference of the frame names: rebuilt, and read by nothing
    data = _item(depth + 3, depth, "420", "unnamed")
    assert _verdict(cv2, tmp_path, data) == "equal"
    assert fx.rebuilt_info(data)[:3] == [1, 0, 0]


def _intra_only_first(depth):
    """cv2's still as an error resilient intra-only frame first (every slot
    empty: each rebuilt from its ref_order_hint) and its item's props."""
    rng = np.random.default_rng(depth)
    img = oracle.avif_image("photo", 40, 56, rng)
    if depth > 8:
        img = oracle.deepen(img, rng) >> (16 - depth)
    obu, props = oracle.item_parts(oracle.cv2_avif(
        img, 60, None if depth == 8 else depth))
    return oracle.full_headers(obu, still=0, frame_kind="intra_only_"
                               "resilient", hints=(5, 9, 0, 3, 127, 1, 2,
                                                   64)), props


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_empty_slots_rebuilt_matches_cv2(cv2, tmp_path, depth):
    # eight empty slots rebuilt, each into a buffer no frame was decoded
    # into: the frame reads as cv2 reads it; a show_existing_frame of the
    # frame's own slot shows it, of a rebuilt one is refused (a calloc'ed
    # buffer is not showable)
    stream, props = _intra_only_first(depth)
    data = oracle.build_avif(stream, props)
    assert _verdict(cv2, tmp_path, data) == "equal"
    assert fx.rebuilt_info(data) == [8, 0, 0, 0, 1]
    for slot, verdict in ((0, "equal"), (3, "refused")):
        shown = stream + oracle.obu(3, oracle._bytes(
            "1" + format(slot, "03b") + "1"))
        assert _verdict(cv2, tmp_path, oracle.build_avif(shown, props),
                        f"show{slot}.avif") == verdict


@pytest.mark.parametrize("fmt", ["420", "444"])
def test_rebuilt_slot_beyond_twice_the_frame(cv2, tmp_path, fmt):
    # key and inter frames at half of the 88-sample maximum (libaom's
    # resize): a grey slot, at 88, is a 2x reference of a 44-sample frame
    # and read; of the last frame rewritten to 43 samples (the same mi
    # grid) it is past libaom's 2x limit, and both refuse the file, which
    # reads without the rebuild
    img = oracle.avif_image("photo", 64, 88, np.random.default_rng(3))
    sx, sy = {"420": (1, 1), "444": (0, 0)}[fmt]
    stream = oracle.libaom_encode_frames(
        [fx.inter_planes(f, 8, fmt) for f in fx.inter_frames(img, 3, 1, 2)],
        8, sx, sy, resize=(1, 16, 16),
        controls={"cpu-used": 5, "error-resilient-mode": 1})
    small = oracle.with_frame_size(stream, 43, 32)
    order, idx = oracle.ref_order_hints(stream)
    wrap = lambda s: fx.inter_avif(s, 88, 64, 8, fmt)   # noqa: E731
    assert _verdict(cv2, tmp_path, wrap(small)) == "equal"
    read = wrap(oracle.with_ref_order_hint(stream, idx[0], order[idx[0]] + 1))
    assert _verdict(cv2, tmp_path, read) == "equal"
    assert fx.rebuilt_info(read)[2] > 0 and fx.scaled_info(read)[0] > 0
    refused = wrap(oracle.with_ref_order_hint(small, idx[0],
                                              order[idx[0]] + 1))
    assert _verdict(cv2, tmp_path, refused) == "refused"


_SHOWN = [(8, "420"), (10, "444"), (12, "420"), (8, "400")]


@pytest.mark.parametrize("grain", [0, 1], ids=["plain", "grain"])
@pytest.mark.parametrize("depth,fmt", _SHOWN,
                         ids=[f"d{d}_{f}" for d, f in _SHOWN])
def test_show_existing_of_a_rebuilt_slot(cv2, tmp_path, depth, fmt, grain):
    # a show_existing_frame header of a rebuilt slot: shown (neutral grey,
    # with the film grain its buffer kept) where the buffer held a shown
    # frame, refused where it held none
    r = np.random.default_rng(depth + grain)
    img = oracle.avif_image("photo", 56, 72, r)
    sx, sy = {"420": (1, 1), "444": (0, 0), "400": (1, 1)}[fmt]
    ctl = {"cpu-used": 5}
    if grain:
        ctl["film-grain-test-vector"] = 3
    stream = oracle.libaom_encode_frames(
        [fx.inter_planes(f, depth, fmt) for f in fx.inter_frames(img, 7, 1,
                                                                 2)],
        depth, sx, sy, mono=fmt == "400",
        flags=fx.REBUILT_FLAGS["leftover"], controls=ctl)
    wrap = lambda s: fx.inter_avif(s, 72, 56, depth, fmt)   # noqa: E731
    shown = fx.rebuilt_shown(stream, r, True, wrap)
    assert _verdict(cv2, tmp_path, wrap(shown)) == "equal"
    assert fx.rebuilt_info(wrap(shown))[3] > 0
    got = read_avif(str(tmp_path / "rebuilt.avif"))
    assert (got.std() > 0) == bool(grain)    # grey, or grey with grain
    refused = fx.rebuilt_shown(stream, r, False, wrap)
    assert _verdict(cv2, tmp_path, wrap(refused)) == "refused"


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_fresh_buffer_state_is_refused_as_cv2_refuses(cv2, tmp_path, depth):
    # a slot rebuilt into a buffer no frame was decoded into, then named as
    # the primary reference frame of the next frame (the one before
    # refreshed no slot): libaom refuses its uninitialised entropy context
    r = np.random.default_rng(depth + 4)
    img = oracle.avif_image("photo", 48, 64, r)
    flags = {2: oracle.AOM_EFLAG_ERROR_RESILIENT | (7 << 23)}
    stream = oracle.libaom_encode_frames(
        [fx.inter_planes(f, depth, "420") for f in fx.inter_frames(img, 5,
                                                                   1, 2)],
        depth, 1, 1, flags=flags, controls={"cpu-used": 5})
    refs = oracle.frame_refs(stream, 3)
    assert not refs["resilient"] and refs["primary"] != 7
    slot = refs["idx"][refs["primary"]]
    order, _ = oracle.ref_order_hints(stream, 2)
    wrap = lambda s: fx.inter_avif(s, 64, 48, depth, "420")  # noqa: E731
    assert _verdict(cv2, tmp_path, wrap(stream)) == "equal"
    data = wrap(oracle.with_ref_order_hint(stream, slot, order[slot] + 3, 2))
    assert _verdict(cv2, tmp_path, data) == "refused"


@pytest.mark.parametrize("name", fx.AVIF_REBUILT_CASES)
def test_committed_rebuilt_file_matches_cv2(name):
    # no cv2 here: each committed file read as cv2 read it, its kind's
    # counter above 0
    path = os.path.join(fx.FOLDER, name)
    np.testing.assert_array_equal(read_avif(path), read_png(
        os.path.join(fx.FOLDER, fx._want(name))))
    with open(path, "rb") as f:
        info = fx.rebuilt_info(f.read())
    assert info[0] > 0
    assert info[fx.AVIF_REBUILT_COUNTER.get(name, 0)] > 0
