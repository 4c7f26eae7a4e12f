"""A wider sweep than the tier-1 tests of the port's TIFF reader against
cv2, on the CPU (not collected by pytest; needs cv2):

    python tests/torch_tiff_sweep.py [--files 5000] [--seed 0] [--keep DIR]

Each file is written by hand (``torch_make_image_fixtures.tiff_bytes``)
with random fields: a photometric interpretation (gray, white-is-zero,
RGB, palette, separated, YCbCr, CIELab; ICCLab and ITULab now and then),
bits a sample (1-16, the usual ones most often), extra samples (an
unassociated, associated or unspecified alpha), YCbCr subsampling (any of
1, 2, 4 by 1, 2, 4, the tag left out now and then) with the predictor's
differences as libtiff writes them or unit by unit, a compression (none,
LZW in new- or old-style codes, Deflate under either code, PackBits),
Predictor 2 or none, chunky or separate planes, strips of any height or
tiles of 16-48, FillOrder 1 or 2, II or MM, an orientation (or none), a
CIELab WhitePoint now and then, a size of 1-60 a side, and samples of
noise or of ``fixture_image``.  A file passes when ``read_tiff`` equals
``cv2.imread(path)[..., ::-1]`` bit for bit, or when both refuse it (the
port raising ``ValueError`` naming the file).  Two faults of cv2 the port
does not copy (ROADMAP §3) are drawn and left out, counted apart
(``cv2_fault``): tiles under orientations 2, 3, 6 and 7, and tiles cut
by the image's right edge in 16-bit gray and in 8-bit gray or palette
with extra samples.  Prints one JSON
line of counts (among them the files of each kind this sweep is for:
16-bit CIELab, subsampled YCbCr whose predictor libtiff undid or left,
old-style LZW); exits 1 on any mismatch.  ``--keep DIR`` keeps each
mismatching file there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import torch_make_image_fixtures as fx  # noqa: E402

from gsplat_tpu_torch.utils.image_io import read_tiff  # noqa: E402

_PHOTOS = {0: 1, 1: 5, 2: 7, 3: 3, 5: 2, 6: 9, 8: 6, 9: 1, 10: 1}
_BITS = {0: (1, 2, 4, 8, 16), 1: (1, 2, 4, 8, 16), 2: (8, 16, 8, 16, 4),
         3: (1, 2, 4, 8, 16), 5: (8, 8, 16), 6: (8, 8, 8, 16),
         8: (8, 16, 16, 4), 9: (8, 16), 10: (8, 16)}
_SUBSAMPLINGS = [(1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4),
                 (1, 4), (2, 4), (4, 4), (2, 2)]
_COMPRESSIONS = [1, 5, 5, 8, 32946, 32773]


def random_tiff(rng) -> tuple[bytes, dict]:
    """One random TIFF → (its bytes, what was drawn)."""
    photos = list(_PHOTOS)
    photo = int(rng.choice(photos, p=np.array(list(_PHOTOS.values()))
                           / sum(_PHOTOS.values())))
    bps = int(rng.choice(_BITS[photo]))
    colour = {0: 1, 1: 1, 3: 1, 5: 4}.get(photo, 3)
    extra = int(rng.random() < 0.15)
    spp = colour + extra
    extra_kind = [int(rng.integers(0, 3))] if extra else None
    h, w = (int(x) for x in rng.integers(1, 61, 2))
    compression = int(rng.choice(_COMPRESSIONS))
    old = compression == 5 and rng.random() < 0.5
    predictor = 2 if rng.random() < (0.6 if bps in (8, 16) else 0.1) \
        else 1
    planar = 2 if spp > 1 and rng.random() < 0.25 else 1
    tile = None
    if rng.random() < 0.3:
        tile = (16 * int(rng.integers(1, 4)), 16 * int(rng.integers(1, 4)))
    rps = int(rng.integers(1, h + 1)) if rng.random() < 0.6 else h
    kw = dict(bps=bps, photometric=photo, compression=compression,
              predictor=predictor, planar=planar, tile=tile,
              rows_per_strip=None if tile else rps,
              endian="<" if rng.random() < 0.5 else ">",
              old_lzw=old, fill_order=2 if rng.random() < 0.1 else 1,
              extra_samples=extra_kind, tags={})
    if rng.random() < 0.3:
        kw["orientation"] = int(rng.integers(1, 9))
    if photo == 8 and rng.random() < 0.2:
        kw["tags"][318] = (5, [int(rng.integers(2000, 4000)), 10000,
                               int(rng.integers(2000, 4000)), 10000])
    if photo == 3:
        kw["colormap"] = rng.integers(0, 1 << 16, (1 << min(bps, 16), 3))
    if rng.random() < 0.5 or bps not in (8, 16):
        samples = rng.integers(0, 1 << bps, (h, w, spp))
    else:
        img = fx.fixture_image(h, w, seed=int(rng.integers(1 << 30)))
        samples = np.concatenate([img] * 2, 2)[..., :spp].astype(np.int64)
        if bps == 16:
            samples = samples * 257 + rng.integers(0, 257, samples.shape)
    sub = None
    if photo == 6:
        sub = _SUBSAMPLINGS[int(rng.integers(len(_SUBSAMPLINGS)))]
        if bps == 8 and spp == 3 and planar == 1 and sub != (1, 1):
            kw["subsampling"] = sub
            if sub == (2, 2) and rng.random() < 0.3:
                kw["subsampling"] = None          # the tag's default
                kw["tags"][530] = None
            kw["ycbcr_rows"] = "pixels" if rng.random() < 0.2 else \
                "libtiff"
        else:
            kw["tags"][530] = (3, list(sub))
    if kw["tags"].get(530, 0) is None:
        del kw["tags"][530]
        data = fx.tiff_bytes(samples, **{**kw, "subsampling": (2, 2)})
        data = _drop_tag(data, 530)
    else:
        data = fx.tiff_bytes(samples, **kw)
    drawn = dict(photo=photo, bps=bps, spp=spp, sub=sub,
                 compression=compression, old_lzw=old, predictor=predictor,
                 planar=planar, tile=tile, orientation=kw.get("orientation"),
                 width=w)
    return data, drawn


def _drop_tag(data: bytes, tag: int) -> bytes:
    """The TIFF with one tag of its (last-written) IFD removed."""
    import struct

    e = "<" if data[:2] == b"II" else ">"
    ifd = struct.unpack_from(e + "I", data, 4)[0]
    n = struct.unpack_from(e + "H", data, ifd)[0]
    entries = [data[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(n)]
    kept = [x for x in entries if struct.unpack_from(e + "H", x)[0] != tag]
    return data[:ifd] + struct.pack(e + "H", len(kept)) + b"".join(kept) \
        + bytes(4) + data[ifd + 2 + 12 * n + 4:]


def cv2_fault(drawn) -> bool:
    """The faults of cv2 the port does not copy (ROADMAP §3): tiles under
    orientations 2, 3, 6 and 7 (each tile mirrored), and tiles the image's
    right edge cuts in the chunky gray and palette routines that skip the
    cut columns by their count in bytes, not in samples (16-bit gray;
    8-bit gray or palette with extra samples)."""
    if drawn["tile"] is None:
        return False
    cut = drawn["width"] % drawn["tile"][0] != 0
    chunky = drawn["planar"] == 1 or drawn["spp"] == 1
    skew = (drawn["photo"] in (0, 1) and drawn["bps"] == 16) or (
        drawn["photo"] in (0, 1, 3) and drawn["bps"] == 8
        and drawn["spp"] > 1)
    return drawn["orientation"] in (2, 3, 6, 7) or (cut and chunky and skew)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--files", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keep", default=None)
    args = p.parse_args()
    os.environ.setdefault("OPENCV_LOG_LEVEL", "OFF")
    import cv2

    rng = np.random.default_rng(args.seed)
    counts = dict(files=0, equal=0, refused_by_both=0, mismatches=0,
                  cv2_faults_left_out=0, cielab16=0,
                  ycbcr_predictor_undone=0, ycbcr_predictor_left=0,
                  old_lzw=0)
    mismatched = []
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.tif")
        while counts["files"] < args.files:
            data, drawn = random_tiff(rng)
            if cv2_fault(drawn):
                counts["cv2_faults_left_out"] += 1
                continue
            counts["files"] += 1
            with open(path, "wb") as f:
                f.write(data)
            want = cv2.imread(path)
            info = {}
            try:
                got = read_tiff(path, info)
            except ValueError as err:
                got = None
                assert path in str(err), err
            if want is None and got is None:
                counts["refused_by_both"] += 1
                continue
            if want is not None and got is not None and \
                    got.shape == want[..., ::-1].shape and \
                    (got == want[..., ::-1]).all():
                counts["equal"] += 1
                counts["cielab16"] += info["cielab16"]
                counts["ycbcr_predictor_undone"] += int(
                    info["ycbcr_predictor_chunks"] > 0)
                counts["ycbcr_predictor_left"] += int(
                    info["ycbcr_predictor_skipped"] > 0)
                counts["old_lzw"] += int(info["old_lzw_chunks"] > 0)
                continue
            counts["mismatches"] += 1
            mismatched.append(drawn)
            if args.keep:
                os.makedirs(args.keep, exist_ok=True)
                with open(os.path.join(
                        args.keep, f"mismatch_{counts['files']}.tif"),
                        "wb") as f:
                    f.write(data)
    counts["seconds"] = round(time.time() - t0, 1)
    counts["seed"] = args.seed
    print(json.dumps(counts))
    for d in mismatched[:20]:
        print("mismatch:", json.dumps(d), file=sys.stderr)
    return 1 if counts["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
