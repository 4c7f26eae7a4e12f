"""libaom 3.14.1's multi-frame files at every default but its speed and
quantizer, against cv2 5.0.0 (libavif 1.4.2 over libaom 3.14.1) bit for bit,
each frame: a photo crop of 64-159 x 64-199, 3-6 frames each moved by up to
4 pixels from the one before and the last in part darkened
(``torch_make_image_fixtures.inter_item``), speed 0-6, quantizer 10-49,
seeds 0-39.  Before the port read compound prediction and skip mode it
refused 22 of these 40 files (13 for compound prediction, 9 for skip
mode); cv2 reads all 40.  The stages are held to libaom by symbol in
``test_torch_avif_compound.py``, the compound tools one by one in
``test_torch_avif_compound_files.py``.
"""

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_avif

import torch_avif_oracles as oracle
import torch_make_image_fixtures as fx


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_default_speeds_match_cv2(cv2, tmp_path, seed):
    # libaom at every default but its speed (0-6) and quantizer (10-49),
    # no lookahead: 22 of the 40 files use compound prediction or skip
    # mode; each frame against cv2
    for s in range(seed, seed + 5):
        r = np.random.default_rng(s)
        h, w = int(r.integers(64, 160)), int(r.integers(64, 200))
        img = oracle.avif_image("photo", h, w, r)
        frames = fx.inter_frames(img, int(r.integers(3, 7)),
                                 int(r.integers(-4, 5)),
                                 int(r.integers(-4, 5)))
        data = fx.inter_item(frames, 8, "420", controls={
            "cpu-used": int(r.integers(0, 7)),
            "cq-level": int(r.integers(10, 50))})
        for k, item in enumerate(fx.temporal_units(data)):
            path = tmp_path / f"speed_{s}_{k}.avif"
            path.write_bytes(item)
            want = cv2.imread(str(path))
            assert want is not None, path.name
            np.testing.assert_array_equal(read_avif(str(path)),
                                          want[..., ::-1])
