"""The lossless JPEG kinds no writer here makes, each settled against cv2
5.0.0 (libjpeg-turbo 3.1.2): a lossless frame of subsampled components,
which cv2 reads (libjpeg-turbo undoes each component at its own size and
upsamples it by replication) and the port now reads bit for bit;
arithmetic-coded lossless (SOF11), which cv2 refuses from its frame header
on, whatever its scan holds; a lossless restart interval that splits an
MCU row, and an interleaved scan of more than 10 samples an MCU, which cv2
refuses and the port refuses naming the file.  The files are written here
by hand (``torch_make_image_fixtures.lossless_jpeg``: T.81 Annex H with
libjpeg-turbo's prediction); the committed ones are held with the counter
``read_jpeg`` reports.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_jpeg, read_png

import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def _planes(sampling, h, w, seed):
    """Noise at each component's own size for ``sampling``."""
    rng = np.random.default_rng(seed)
    hmax = max(a for a, _ in sampling)
    vmax = max(b for _, b in sampling)
    return [rng.integers(0, 256, (-(-h * v // vmax), -(-w * a // hmax)))
            .astype(np.uint8) for a, v in sampling]


def _same_as_cv2(cv2, path, data):
    """The port equals cv2 bit for bit (warnings of a cut-short file aside),
    or both refuse, the port raising naming the file.  → read_jpeg's
    counters, or None where both refuse."""
    path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(ValueError, match=path.name) as err:
            read_jpeg(str(path))
        assert "yet" not in str(err.value)
        return None
    info = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = read_jpeg(str(path), info)
    np.testing.assert_array_equal(got, want[..., ::-1], err_msg=path.name)
    return info


# ----------------------------------------------- subsampled lossless frames


_SAMPLINGS = {
    "y22": [(2, 2), (1, 1), (1, 1)], "y21": [(2, 1), (1, 1), (1, 1)],
    "y12": [(1, 2), (1, 1), (1, 1)], "cb22": [(1, 1), (2, 2), (1, 1)],
    "mixed": [(2, 2), (2, 1), (1, 2)], "y41_cr21": [(4, 1), (1, 1), (2, 1)],
    "y31": [(3, 1), (1, 1), (1, 1)], "y14_cb12": [(1, 4), (1, 2), (1, 1)],
    "y32": [(3, 2), (1, 1), (1, 1)], "four": [(2, 2), (1, 1), (1, 1),
                                              (2, 2)],
}


@pytest.mark.parametrize("psv", range(1, 8))
@pytest.mark.parametrize("kind", list(_SAMPLINGS))
def test_subsampled_lossless_matches_cv2(cv2, tmp_path, kind, psv):
    # each predictor, point transforms 0 and 3, restarts every MCU row and
    # every two, sizes that are not whole MCUs
    sampling = _SAMPLINGS[kind]
    hmax = max(a for a, _ in sampling)
    for (h, w), pt in [((1, 1), 0), ((5, 7), 3), ((29, 38), 0),
                       ((17, 50), 3)]:
        per_row = -(-w // hmax)
        for restart in (0, per_row, 2 * per_row):
            data = fx.lossless_jpeg(_planes(sampling, h, w, h * w + psv), h,
                                    w, sampling, psv=psv, pt=pt,
                                    restart=restart)
            info = _same_as_cv2(cv2, tmp_path / f"{kind}.jpg", data)
            if len(sampling) == 4:   # CMYK: cv2 reads it, no conversion
                continue
            assert info["subsampled_lossless"] == 1


@pytest.mark.parametrize("kind", ["y22", "y21", "y12", "mixed", "y14_cb12"])
def test_a_scan_a_component_matches_cv2(cv2, tmp_path, kind):
    # non-interleaved scans: one sample an MCU, the component's own rows;
    # a restart before any MCU row of an iMCU row (v rows) starts the
    # prediction anew at its first row (jddiffct.c undoes an iMCU row
    # after decoding it)
    sampling = _SAMPLINGS[kind]
    for h, w in [(5, 7), (29, 38), (16, 20)]:
        planes = _planes(sampling, h, w, h + w)
        widths = {p.shape[1] for p in planes}
        restarts = [0] + ([planes[0].shape[1], 3 * planes[0].shape[1]]
                          if len(widths) == 1 else [])
        for restart in restarts:
            for psv in (1, 6):
                data = fx.lossless_jpeg(planes, h, w, sampling, psv=psv,
                                        restart=restart, interleave=False)
                info = _same_as_cv2(cv2, tmp_path / "scans.jpg", data)
                assert info["subsampled_lossless"] == 1


def test_a_scan_a_component_restarts_inside_an_imcu_row(cv2, tmp_path):
    # the lone scans of a (1, 2) luma and (1, 1) chroma of one width: a
    # restart every sample row, every three, every five
    sampling = [(1, 2), (1, 2), (1, 2)]
    for h, w in [(12, 9), (13, 9)]:
        planes = _planes(sampling, h, w, h)
        for rows in (1, 3, 5):
            data = fx.lossless_jpeg(planes, h, w, sampling, psv=4,
                                    restart=rows * w, interleave=False)
            _same_as_cv2(cv2, tmp_path / "imcu.jpg", data)


@pytest.mark.parametrize("kind", ["y22", "mixed", "y41_cr21"])
def test_cut_short_subsampled_lossless_matches_cv2(cv2, tmp_path, kind):
    # data that runs out: the MCU row it ran out in decodes zero bits, every
    # later one zero differences from a fresh prediction (jdlhuff.c)
    sampling = _SAMPLINGS[kind]
    hmax = max(a for a, _ in sampling)
    h, w = 29, 38
    for restart in (0, -(-w // hmax)):
        full = fx.lossless_jpeg(_planes(sampling, h, w, 5), h, w, sampling,
                                psv=1, restart=restart)
        for fraction in (0.3, 0.55, 0.8, 0.97):
            path = tmp_path / "cut.jpg"
            data = fx._cut(full, fraction)
            path.write_bytes(data)
            with pytest.warns(RuntimeWarning, match="cut.jpg"):
                read_jpeg(str(path))
            _same_as_cv2(cv2, path, data)


# ------------------------------------------------ the kinds cv2 refuses


def _scan_start(data: bytes) -> int:
    at = data.index(b"\xff\xda")
    return at + 2 + ((data[at + 2] << 8) | data[at + 3])


def test_arithmetic_lossless_is_refused_from_its_header(cv2, tmp_path):
    # SOF11 over the scan of a valid lossless file, over noise and over
    # nothing: cv2 refuses all three, while SOF3 over the same noise it
    # reads (with libjpeg's warnings): its verdict comes before the data
    img = fx.fixture_image(29, 38, seed=3)
    one = [img[..., k] for k in range(3)]
    valid = fx.lossless_jpeg(one, 29, 38, marker=0xCB)
    at = _scan_start(valid)
    noise = np.random.default_rng(5).integers(0, 255, 400).astype(
        np.uint8).tobytes()
    for name, data in (("valid", valid),
                       ("noise", valid[:at] + noise + b"\xff\xd9"),
                       ("empty", valid[:at] + b"\xff\xd9")):
        path = tmp_path / f"sof11_{name}.jpg"
        assert _same_as_cv2(cv2, path, data) is None
        with pytest.raises(ValueError, match=f"sof11_{name}.jpg: "
                                             f"arithmetic-coded lossless"):
            read_jpeg(str(path))
        sof3 = data.replace(b"\xff\xcb", b"\xff\xc3", 1)
        if name == "noise":
            assert _same_as_cv2(cv2, tmp_path / "sof3_noise.jpg",
                                sof3) is not None


@pytest.mark.parametrize("restart", [1, 5, 19, 39, 57])
def test_restarts_that_split_a_row_are_refused(cv2, tmp_path, restart):
    # libjpeg-turbo's lossless decoder takes whole MCU rows between
    # restarts only (38 MCUs a row here; 19 in the subsampled frame)
    img = fx.fixture_image(29, 38, seed=4)
    one = [img[..., k] for k in range(3)]
    path = tmp_path / "split.jpg"
    assert _same_as_cv2(cv2, path, fx.lossless_jpeg(
        one, 29, 38, restart=restart)) is None
    with pytest.raises(ValueError, match="split.jpg: lossless JPEG with a "
                                         "restart interval that splits"):
        read_jpeg(str(path))
    sampling = _SAMPLINGS["y22"]
    data = fx.lossless_jpeg(_planes(sampling, 29, 38, 1), 29, 38, sampling,
                            restart=restart)
    read = _same_as_cv2(cv2, tmp_path / "split_sub.jpg", data)
    assert (read is None) == (restart % 19 != 0)


@pytest.mark.parametrize("lossless", [True, False])
def test_more_than_10_blocks_an_mcu_are_refused(cv2, tmp_path, lossless):
    # jdinput.c's D_MAX_BLOCKS_IN_MCU, in a lossless frame (4x4 + 2x2 + 1
    # samples) and in a lossy one (cv2's 4:2:0 file with its factors made
    # 4x4, 2x2, 1x1: 21 blocks)
    path = tmp_path / "mcu.jpg"
    if lossless:
        sampling = [(4, 4), (2, 2), (1, 1)]
        data = fx.lossless_jpeg(_planes(sampling, 29, 38, 2), 29, 38,
                                sampling)
    else:
        ok, enc = cv2.imencode(".jpg", fx.fixture_image(29, 38, seed=2))
        data = bytearray(enc.tobytes())
        sof = data.index(b"\xff\xc0")
        data[sof + 11], data[sof + 14] = 0x44, 0x22
        data = bytes(data)
    assert _same_as_cv2(cv2, path, data) is None
    with pytest.raises(ValueError, match="mcu.jpg: an interleaved scan of "
                                         "more than 10"):
        read_jpeg(str(path))


def test_no_jpeg_refusal_says_not_supported_yet():
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "gsplat_tpu_torch", "csrc", "jpeg_codec.cpp")
    with open(src) as f:
        assert "not supported yet" not in f.read()


# ------------------------------------------------- the committed files


@pytest.mark.parametrize("name", [n for n in fx.KINDS_CASES
                                  if n.endswith(".jpg")])
def test_committed_lossless_kinds_use_their_kind(name):
    # no cv2 here: the decode is cv2's recorded one, and the counter shows
    # the subsampled lossless frame
    info = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = read_jpeg(os.path.join(fx.FOLDER, name), info)
    want = read_png(os.path.join(fx.FOLDER, name[:-4] + ".want.png"))
    np.testing.assert_array_equal(got, want)
    assert info[fx.TIFF_KINDS_USES[name]] > 0


@pytest.mark.parametrize("name", [n for n in fx.KINDS_REFUSED
                                  if n.endswith(".jpg")])
def test_committed_refused_lossless_kinds_raise(name):
    with pytest.raises(ValueError, match=name):
        read_jpeg(os.path.join(fx.FOLDER, name))
