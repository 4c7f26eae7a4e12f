"""The port's AV1 decoder on compound prediction and skip mode against cv2
5.0.0 (libavif 1.4.2 over libaom 3.14.1) bit for bit: libaom's own
good-quality encoder at every default (``torch_avif_oracles.
libaom_encode_frames`` through its C API; ``torch_make_image_fixtures.
compound_item``: photo crops at speeds 0-2, where libaom takes compound
prediction), with and without its lookahead (a hidden ALTREF: backward
references, bidirectional pairs), at 8, 10 and 12 bits in every chroma
format; each control of compound prediction on alone; skip mode; single-
reference blocks beside compound ones; in a grid tile, an alpha item and a
track's first sample.  Each file is also shown to use what it is there for
by the decoder's counters (``compound_info``: compound blocks by type,
skip-mode blocks, single-reference blocks beside a compound neighbour).

The committed files (``tests/torch_images/``, written by
``torch_make_image_fixtures.py --compound``) need no cv2; the stages are
held to libaom's functions by symbol in ``test_torch_avif_compound.py``.
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


def _same_as_cv2(cv2, tmp_path, name, data):
    path = tmp_path / name
    path.write_bytes(data)
    want = cv2.imread(str(path))
    assert want is not None, name
    np.testing.assert_array_equal(read_avif(str(path)), want[..., ::-1])


def _every_frame_as_cv2(cv2, tmp_path, name, data):
    """The file and each of its cuts after a temporal unit against cv2
    (fx.temporal_units): cv2 shows the last frame shown, so every frame
    shown, hidden ones when they are, is held to libaom's."""
    for k, item in enumerate(fx.temporal_units(data)):
        _same_as_cv2(cv2, tmp_path, f"{k}_{name}", item)


def _any_compound(t):
    return sum(t[:4]) > 0


def _until_used(cv2, tmp_path, name, make, uses=_any_compound, base=1000,
                tries=10):
    """make(rng) over seeds base.. each against cv2, until a file uses what
    uses(compound_info) asks → (the file, its compound_info); fails where
    none of tries does."""
    for seed in range(base, base + tries):
        data = make(np.random.default_rng(seed))
        _every_frame_as_cv2(cv2, tmp_path, name, data)
        info = fx.compound_info(data)
        if uses(info):
            return data, info
    pytest.fail(f"no file of {tries} uses what {name} is for")


_FORMATS = fx.AVIF_TOOLS_FORMATS


@pytest.mark.parametrize("depth,fmt", _FORMATS,
                         ids=[f"d{d}_{f}" for d, f in _FORMATS])
def test_default_compound_matches_cv2(cv2, tmp_path, depth, fmt):
    # libaom at every default: compound blocks (the lookahead in every
    # other format: backward references), each file equal to cv2's
    k = _FORMATS.index((depth, fmt))
    _until_used(cv2, tmp_path, f"d{depth}_{fmt}.avif", lambda r: (
        fx.compound_item(r, depth, fmt, lag=35 * (k % 2))), base=100 * k)


# libaom seldom takes a wedge on these crops: the depth and first seed of
# its first file with one (at 10 bits none of seeds 1000-1039 has one)
_ALONE_FROM = {"interinter_wedge": (8, 1033)}


@pytest.mark.parametrize("tool", list(fx.AVIF_COMPOUND_ALONE))
def test_compound_control_alone_matches_cv2(cv2, tmp_path, tool):
    # each control of compound prediction on alone (the other inter tools
    # off; the masked types with enable-masked-comp), its compound type
    # in use
    on, lag, counter = fx.AVIF_COMPOUND_ALONE[tool]
    depth, base = _ALONE_FROM.get(tool, (10, 1000))
    _until_used(cv2, tmp_path, f"{tool}.avif", lambda r: fx.compound_item(
        r, depth, "420", lag=lag, controls={**oracle.INTER_TOOLS_OFF, **on}),
        lambda t: t[counter] > 0, base=base)


@pytest.mark.parametrize("lag", [0, 35])
@pytest.mark.parametrize("fmt", ["422", "444"])
def test_skip_mode_matches_cv2(cv2, tmp_path, lag, fmt):
    # skip-mode blocks: the two forward references closest to the frame,
    # or (with the lookahead) the closest forward and backward ones
    _until_used(cv2, tmp_path, "skip.avif", lambda r: fx.compound_item(
        r, 12 if fmt == "422" else 8, fmt, lag=lag), lambda t: t[4] > 0)


def test_single_blocks_beside_compound_match_cv2(cv2, tmp_path):
    # single-reference blocks that read their references beside compound
    # neighbours: the contexts count both of a neighbour's references
    _, info = _until_used(cv2, tmp_path, "beside.avif", lambda r: (
        fx.compound_item(r, 8, "420", lag=35)),
        lambda t: t[5] > 0 and _any_compound(t))
    assert info[5] > 0


def test_compound_in_grid_alpha_and_track(cv2, tmp_path):
    # compound files as a grid's tiles, as an alpha item (4:0:0, compound
    # too) and as a sequence track's first sample
    h, w = 64, 96
    colour, _ = _until_used(cv2, tmp_path, "colour.avif", lambda r: (
        fx.compound_item(r, 8, "420", size=(h, w))))
    alpha, _ = _until_used(cv2, tmp_path, "mono.avif", lambda r: (
        fx.compound_item(r, 8, "400", size=(h, w))), base=2000)
    tile = oracle.tile_item(colour)
    _same_as_cv2(cv2, tmp_path, "grid.avif",
                 oracle.grid_avif([tile, tile], 1, 2, 2 * w, h))
    _same_as_cv2(cv2, tmp_path, "alpha.avif",
                 oracle.alpha_file(colour, alpha, False))
    obu, props = oracle.item_parts(colour)
    _same_as_cv2(cv2, tmp_path, "track.avif",
                 oracle.build_sequence([obu], props, w, h))


# ------------------------------------------------- the committed files


# what each committed file's compound_info must show: the compound type or
# skip mode it is there for
def _uses(name, t):
    if name == "avif_unported_skip_mode.avif" or \
            name == "avif_compound_skip_mode.avif":
        return t[4] > 0
    if name == "avif_compound_neighbours.avif":
        return t[5] > 0 and _any_compound(t)
    if name.startswith("avif_compound_") and \
            name[14:-5] in fx.AVIF_COMPOUND_ALONE:
        return t[fx.AVIF_COMPOUND_ALONE[name[14:-5]][2]] > 0
    return _any_compound(t) and t[6] >= 2


@pytest.mark.parametrize("name", fx.AVIF_COMPOUND_CASES)
def test_committed_compound_fixtures_match_cv2(name):
    # no cv2 here: the decode is cv2's recorded one
    got = read_avif(os.path.join(fx.FOLDER, name))
    want = image_io.read_png(os.path.join(fx.FOLDER, fx._want(name)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", fx.AVIF_COMPOUND_CASES)
def test_committed_compound_fixtures_use_their_tools(name):
    # the decoder's counters show the compound type or skip mode each file
    # is there for
    with open(os.path.join(fx.FOLDER, name), "rb") as f:
        t = fx.compound_info(f.read())
    assert _uses(name, t), t
