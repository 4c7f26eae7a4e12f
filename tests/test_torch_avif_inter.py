"""The port's AV1 decoder on frames after the first, against cv2 5.0.0
(libavif 1.4.2 over libaom 3.14.1) bit for bit: intra-only frames, hidden
key and inter frames that a show_existing_frame header shows, and
single-reference inter frames, in an item, a grid tile, an alpha item and
a track's first sample, at 8, 10 and 12 bits in every chroma format.

The inter frames come from libaom's own good-quality encoder
(``torch_avif_oracles.libaom_encode_frames``, through its C API) with the
inter tools the slice came before switched off (``INTER_TOOLS_OFF``; later
test files hold each of them, and every file the slice refused reads as
cv2 reads it now).  The predictor is held
to libaom's own ``av1_*convolve_*_sr_c`` by ELF symbol.  No cv2 is needed
by the tests of the committed files (``tests/torch_images/``, written by
``torch_make_image_fixtures.py --inter``).
"""

import os

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif, read_png

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


def _item(seed, depth, fmt, n=3, size=(64, 96), shift=(2, -3), **kw):
    """An AVIF item of n frames of a photo crop (the last translated and in
    part darkened), the next slice's tools off unless ``controls`` says."""
    rng = np.random.default_rng(seed)
    img = oracle.avif_image("photo", *size, rng)
    controls = {**oracle.INTER_TOOLS_OFF, "cpu-used": 5, "cq-level": 30,
                **kw.pop("controls", {})}
    return fx.inter_item(fx.inter_frames(img, n, *shift), depth, fmt,
                         controls=controls, **kw)


def _info(data):
    heif = image_io._Heif(data, "x.avif")
    heif.parse()
    return image_io.decode_av1(heif.primary_item()[0])[1]


# ---------------------------------------------------- the predictor


_SIZES = [(2, 2), (4, 4), (8, 4), (4, 16), (16, 8), (32, 32)]


@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("kind", ["2d", "x", "y"])
def test_predictor_matches_libaom(depth, kind):
    # the sub-pixel filter of the port's inter prediction against libaom's
    # av1_convolve_2d_sr_c, av1_convolve_x_sr_c, av1_convolve_y_sr_c (and
    # their highbd forms) at every filter pair and sub-pixel position:
    # the 8-tap regular, smooth and sharp filters, bilinear, and the 4-tap
    # forms of blocks 4 or fewer samples wide or high
    rng = np.random.default_rng(depth)
    for w, h in _SIZES:
        src = rng.integers(0, 1 << depth, (h + 7, w + 7))
        for fx_ in range(4):
            for fy in range(4):
                for sx in range(16) if kind != "y" else [0]:
                    for sy in range(16) if kind != "x" else [0]:
                        want = oracle.libaom_convolve(src, w, h, fx_, fy, sx,
                                                      sy, depth, kind)
                        got = oracle.port_convolve(src, w, h, fx_, fy, sx,
                                                   sy, depth)
                        np.testing.assert_array_equal(
                            got, want, err_msg=f"{w}x{h} filters "
                            f"{fx_},{fy} at {sx},{sy}")


def test_encoder_inter_controls_are_libaom_controls():
    # the control ids libaom_encode_frames passes for the inter tools are
    # the ones the library's encoder_ctrl_maps pairs with its functions
    ids = oracle.aom_control_ids()
    for opt, cid in oracle.AOM_INTER_CONTROLS.items():
        name = {"error-resilient-mode": "error_resilient_mode"}.get(
            opt, opt.replace("-", "_"))
        assert ids[f"ctrl_set_{name}"] == cid, opt


# ------------------------------------------------- libaom's inter frames


_FORMATS = [(d, f) for d in (8, 10, 12) for f in ("420", "422", "444", "400")]


@pytest.mark.parametrize("depth,fmt", _FORMATS,
                         ids=[f"d{d}_{f}" for d, f in _FORMATS])
def test_inter_frames_match_cv2(cv2, tmp_path, depth, fmt):
    # two to four frames, the last of each a translated copy of the first:
    # nonzero MVs, the single references, the MV modes and DRL
    seed = depth * 10 + int(fmt[1])
    n = 2 + seed % 3
    data = _item(seed, depth, fmt, n=n, size=(56 + seed % 17, 80 + seed % 29))
    _same_as_cv2(cv2, tmp_path, f"inter_{depth}_{fmt}.avif", data)
    info = _info(data)
    assert info[46] == n and sum(info[49:53]) > 0


_TOOLS = {
    # 128x128 superblocks in 2x2 tiles
    "sb128_tiles": dict(size=(136, 296), controls={
        "superblock-size": 1, "tile-columns": 1, "tile-rows": 1}),
    # CDEF and loop restoration at 10 bits
    "cdef_lr": dict(depth=10, controls={"enable-restoration": 1,
                                        "cpu-used": 2, "cq-level": 40}),
    # cyclic refresh: segmentation with temporal update
    "seg_temporal": dict(n=4, size=(112, 144), controls={"aq-mode": 3,
                                                         "cpu-used": 6}),
    # film grain at 10 bits, loaded from a reference (update_grain 0)
    "grain_ref": dict(depth=10, controls={"film-grain-test-vector": 5}),
    # the switchable filters (speed 1)
    "switchable": dict(size=(128, 160), shift=(3, -5), controls={
        "cpu-used": 1, "cq-level": 20}),
    # libaom's realtime usage
    "realtime": dict(usage=1, controls={"cpu-used": 8}),
    # error resilient inter frames (no primary reference frame, their
    # references' order hints read)
    "error_resilient": dict(controls={"error-resilient-mode": 1}),
    # 12-bit 4:2:2 with quantizer and loop filter deltas at speed 3
    "d12_422": dict(depth=12, fmt="422", controls={"cpu-used": 3,
                                                    "cq-level": 45}),
}


@pytest.mark.parametrize("kind", list(_TOOLS))
def test_inter_tools_match_cv2(cv2, tmp_path, kind):
    opts = dict(_TOOLS[kind])
    depth, fmt = opts.pop("depth", 8), opts.pop("fmt", "420")
    data = _item(len(kind), depth, fmt, **opts)
    _same_as_cv2(cv2, tmp_path, f"{kind}.avif", data)
    info = _info(data)
    assert info[46] >= 2
    if kind == "sb128_tiles":
        assert info[12] == 1 and info[10:12] == [2, 2]
    if kind == "grain_ref":
        assert info[22] == 1


@pytest.mark.parametrize("depth", [8, 10])
def test_hidden_inter_frame_matches_cv2(cv2, tmp_path, depth):
    # the last frame hidden (showable), then a show_existing_frame header
    # that shows it: the image is that frame
    rng = np.random.default_rng(depth)
    img = oracle.avif_image("photo", 72, 100, rng)
    frames = [fx.inter_planes(f, depth, "420")
              for f in fx.inter_frames(img, 3, -2, 2)]
    stream = oracle.libaom_encode_frames(
        frames, depth, 1, 1, controls={**oracle.INTER_TOOLS_OFF,
                                       "cpu-used": 5})
    data = fx.inter_avif(oracle.hide_last_frame(stream), 100, 72, depth,
                         "420")
    _same_as_cv2(cv2, tmp_path, "hidden.avif", data)
    assert _info(data)[46:49] == [3, 0, 1]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_short_signaled_references_match_cv2(cv2, tmp_path, seed):
    # the last frame's references short-signaled: libaom's
    # av1_set_frame_refs and the port's set_frame_refs each pick the five
    # references the header leaves out from the slots' order hints
    rng = np.random.default_rng(seed)
    img = oracle.avif_image("photo", 64, 96, rng)
    n = 3 + seed
    frames = [fx.inter_planes(f, 8, "420")
              for f in fx.inter_frames(img, n, 2, -2)]
    stream = oracle.libaom_encode_frames(
        frames, 8, 1, 1, controls={**oracle.INTER_TOOLS_OFF, "cpu-used": 5,
                                   "max-reference-frames": 7})
    data = fx.inter_avif(oracle.short_signal_last_frame(stream), 96, 64, 8,
                         "420")
    _same_as_cv2(cv2, tmp_path, "short.avif", data)


@pytest.mark.parametrize("kind", ["intra_only", "hidden_key"])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_frame_kinds_match_cv2(cv2, tmp_path, kind, depth):
    # cv2's still item as an intra-only frame first, and as a hidden key
    # frame that a show_existing_frame header shows
    img = oracle.avif_image("photo", 64, 80, np.random.default_rng(depth))
    if depth > 8:
        img = oracle.deepen(img, np.random.default_rng(1)) >> (16 - depth)
    obu, props = oracle.item_parts(oracle.cv2_avif(
        img, 60, None if depth == 8 else depth))
    data = oracle.build_avif(oracle.frame_of_kind(obu, kind), props)
    _same_as_cv2(cv2, tmp_path, f"{kind}.avif", data)
    info = _info(data)
    assert info[47:49] == ([1, 0] if kind == "intra_only" else [0, 1])


def test_inter_frames_in_grid_alpha_and_track(cv2, tmp_path):
    # the frames as a grid's tiles, as an alpha item (4:0:0) and as a
    # sequence track's first sample
    tiles = [oracle.tile_item(_item(k, 8, "420", size=(64, 64)))
             for k in range(4)]
    _same_as_cv2(cv2, tmp_path, "grid.avif",
                 oracle.grid_avif(tiles, 2, 2, 128, 128))
    colour = _item(5, 8, "420", size=(64, 96))
    alpha = _item(6, 8, "400", size=(64, 96))
    _same_as_cv2(cv2, tmp_path, "alpha.avif",
                 oracle.alpha_file(colour, alpha, False))
    obu, props = oracle.item_parts(_item(7, 10, "444", size=(48, 64)))
    _same_as_cv2(cv2, tmp_path, "track.avif",
                 oracle.build_sequence([obu], props, 64, 48))


# ------------------------------------------------- the committed files


@pytest.mark.parametrize("name", fx.AVIF_REBUILT_MOVED)
def test_next_slice_tools_are_refused(name):
    # no cv2 here: the file the inter slice found refused for the last kind
    # it did not read (a slot libaom rebuilds from ref_order_hint) now reads
    # as cv2 read it, the slot rebuilt and blocks predicted from it
    path = os.path.join(fx.FOLDER, name)
    np.testing.assert_array_equal(read_avif(path), read_png(
        os.path.join(fx.FOLDER, fx._want(name))))
    with open(path, "rb") as f:
        info = fx.rebuilt_info(f.read())
    assert info[0] > 0 and info[2] > 0


# each committed inter fixture and what its decode counts (decode_av1's
# info): frames decoded, intra-only frames, show_existing_frame headers,
# then blocks by mode and by filter
def _uses(name, info):
    frames, intra_only, shown = info[46:49]
    modes, filters = info[49:53], info[53:58]
    if name == "avif_intra_only.avif":
        return intra_only == 1 and frames == 1
    if name == "avif_hidden_key.avif":
        return shown == 1 and frames == 1
    if frames < 2 or sum(modes) == 0 or modes[3] == 0:   # NEWMV blocks
        return False
    if name == "avif_inter_hidden.avif":
        return shown == 1
    if name == "avif_inter_switchable.avif":
        return filters[1] + filters[2] > 0               # smooth, sharp
    if name == "avif_inter_sb128_tiles.avif":
        return info[12] == 1 and info[10:12] == [2, 2]
    if name == "avif_inter_cdef_lr.avif":
        return info[13] == 1 and info[29] + info[30] > 0
    if name == "avif_inter_seg_temporal.avif":
        return info[31] == 1
    if name == "avif_inter_grain_ref.avif":
        return info[22] == 1
    return True


@pytest.mark.parametrize("name", fx.AVIF_INTER_CASES)
def test_committed_inter_fixtures_use_their_tools(name):
    # no cv2 here: the decode is cv2's recorded one, and the decoder's
    # counters show the kind in use
    with open(os.path.join(fx.FOLDER, name), "rb") as f:
        data = f.read()
    got = read_avif(os.path.join(fx.FOLDER, name))
    want = image_io.read_png(os.path.join(fx.FOLDER, fx._want(name)))
    np.testing.assert_array_equal(got, want)
    info = _info(data)
    assert _uses(name, info), info[46:]
