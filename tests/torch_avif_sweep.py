"""A wider sweep than the tier-1 tests of the port's AVIF reader against
cv2, on the CPU (not collected by pytest; needs cv2 and Pillow):

    python tests/torch_avif_sweep.py [--seconds 600] [--seed 0]

Each file is random: a size (1-400 a side, log-uniform; one in twenty up
to 1300), a content (a crop of the committed 1297x840 view, noise, a flat
colour, smooth ramps; or screen content: text-like glyphs, flat blocks, a
ramp) and a writer: cv2 at a random quality (0-100) and depth (8, 10 or 12
bits), from colour or gray input (gray: a monochrome file), or Pillow at a
random quality with random libaom options (4:4:4, 4:2:2 and 4:0:0, tile
columns and rows, 64 or 128 superblocks, CDEF, quantizer matrices, aq and
deltaq modes, ``tune-content=screen``, film grain in a quarter of the
files: libaom's test vectors 1-16 or its denoiser) from RGB or RGBA (an
alpha item).  One file in ten is a grid: 2-6 tiles of one writer's
streams (the same options, cut from one image, 64 pixels a side at least)
placed by a ``grid`` item, with a grid alpha where the tiles have one.
``read_image`` must equal ``cv2.imread(path)[..., ::-1]`` bit for bit; a
file of a kind the port does not decode yet (where a random option makes
one) is counted apart, by kind.  Prints one JSON line of counts (and the
files that used palette and intra block copy); exits 1 on any mismatch.
``--keep DIR`` keeps each mismatching file there.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_avif_oracles as oracle  # noqa: E402

from gsplat_tpu_torch.utils import image_io  # noqa: E402
from gsplat_tpu_torch.utils.image_io import read_image  # noqa: E402


def random_file(rng):
    """(bytes, a description) of one random AVIF file."""
    top = 1300 if rng.random() < 0.05 else 400
    h, w = (int(np.exp(rng.uniform(0, np.log(top)))) for _ in range(2))
    if rng.random() < 0.3:
        kind = str(rng.choice(oracle.SCREEN_KINDS))
        img = oracle.screen_image(kind, h, w, rng)
    else:
        kind = str(rng.choice(oracle.KINDS))
        img = oracle.avif_image(kind, h, w, rng)
    quality = int(rng.integers(0, 101))
    if rng.random() < 0.5:
        depth = int(rng.choice([8, 8, 10, 12]))
        gray = rng.random() < 0.15
        if gray:
            img = img[..., 1]
        if depth > 8:
            img = oracle.deepen(img, rng)
        desc = dict(writer="cv2", quality=quality, depth=depth, gray=gray)
        return oracle.cv2_avif(img, quality, None if depth == 8 else depth), \
            (h, w, kind, desc)
    if rng.random() < 0.2:
        alpha = oracle.screen_image("blocks", h, w, rng)[..., :1]
        img = np.concatenate([img, alpha], -1)
    adv = {}
    if rng.random() < 0.3:
        adv["tune-content"] = "screen"
    if rng.random() < 0.25:         # film grain: a test vector or the
        if rng.random() < 0.75:     # denoiser's noise model
            adv["film-grain-test"] = str(int(rng.integers(1, 17)))
        else:
            adv["denoise-noise-level"] = str(int(rng.integers(1, 51)))
    if rng.random() < 0.5:
        adv["tile-columns"] = str(int(rng.integers(0, 3)))
    if rng.random() < 0.5:
        adv["tile-rows"] = str(int(rng.integers(0, 2)))
    if rng.random() < 0.4:
        adv["sb-size"] = str(rng.choice(["64", "128"]))
    for key in ("enable-cdef", "enable-qm", "deltaq-mode", "aq-mode"):
        if rng.random() < 0.4:
            adv[key] = str(int(rng.integers(0, 2)))
    opts = dict(quality=quality, advanced=adv)
    if rng.random() < 0.5:
        opts["subsampling"] = str(rng.choice(["4:4:4", "4:2:2", "4:0:0"]))
    return oracle.pillow_avif(img, **opts), (
        h, w, kind, dict(writer="pillow", alpha=img.shape[2] == 4, **opts))


def random_grid(rng):
    """(bytes, a description) of a random grid file: one writer's tiles
    (random_file's, re-encoded from crops of one image) in a rows x
    columns grid whose output size the last row and column overlap."""
    rows, cols = int(rng.integers(1, 3)), int(rng.integers(1, 4))
    if rows * cols == 1:
        cols = 2
    tw, th = (2 * int(rng.integers(32, 100)) for _ in range(2))
    w = tw * (cols - 1) + 2 * int(rng.integers(1, tw // 2 + 1))
    h = th * (rows - 1) + 2 * int(rng.integers(1, th // 2 + 1))
    _, desc = random_file(rng)
    # the same writer and options again, on each tile of one image
    kind, opts = desc[2], desc[3]
    img = (oracle.screen_image(kind, th * rows, tw * cols, rng)
           if kind in oracle.SCREEN_KINDS else
           oracle.avif_image(kind, th * rows, tw * cols, rng))
    if opts["writer"] == "cv2":
        if opts["gray"]:
            img = img[..., 1]
        if opts["depth"] > 8:
            img = oracle.deepen(img, rng)
        depth = None if opts["depth"] == 8 else opts["depth"]
        write = lambda t: oracle.cv2_avif(t, opts["quality"], depth)  # noqa
    else:
        if opts["alpha"]:
            img = np.concatenate([img, oracle.screen_image(
                "blocks", th * rows, tw * cols, rng)[..., :1]], -1)
        keys = ("quality", "advanced", "subsampling")
        pil = {k: opts[k] for k in keys if k in opts}
        write = lambda t: oracle.pillow_avif(t, **pil)  # noqa
    files = [write(t) for t in oracle.split_tiles(img, rows, cols, tw, th)]
    tiles = [oracle.tile_item(f) for f in files]
    alpha = None
    if opts["writer"] == "pillow" and opts["alpha"]:
        alpha = []
        for f in files:
            _, _, aobu, aprops = oracle.alpha_parts(f)
            alpha.append((aobu, [(b, e) for b, e in aprops
                                 if b[4:8] != b"auxC"]))
        alpha = (alpha, rows, cols)
    return oracle.grid_avif(tiles, rows, cols, w, h, alpha=alpha), (
        h, w, kind, dict(opts, grid=(rows, cols, tw, th)))


def tools(data: bytes):
    """decode_av1's info on a file's primary item."""
    heif = image_io._Heif(data, "file")
    heif.parse()
    return image_io.decode_av1(heif.primary_item()[0])[1]


def keep(folder, data: bytes, counts: dict):
    if folder:
        os.makedirs(folder, exist_ok=True)
        name = os.path.join(folder, f"mismatch_{counts['mismatch']}.avif")
        with open(name, "wb") as f:
            f.write(data)


def main():
    import cv2

    p = argparse.ArgumentParser()
    p.add_argument("--seconds", type=float, default=600.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--keep", default=None)
    a = p.parse_args()
    rng = np.random.default_rng(a.seed)
    counts = dict(files=0, equal=0, both_refuse=0, not_yet=0, writer_fail=0,
                  mismatch=0, cv2=0, pillow=0, grid=0, grain=0, palette=0,
                  intrabc=0, not_yet_kinds={})
    end = time.time() + a.seconds
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.avif")
        while time.time() < end:
            try:
                data, desc = random_grid(rng) if rng.random() < 0.1 else \
                    random_file(rng)
            except Exception:             # a writer refusing its options
                counts["writer_fail"] += 1
                continue
            with open(path, "wb") as f:
                f.write(data)
            counts["files"] += 1
            counts[desc[3]["writer"]] += 1
            counts["grid"] += "grid" in desc[3]
            grain = str(desc[3].get("advanced", {}))
            counts["grain"] += "grain" in grain or "denoise" in grain
            want = cv2.imread(path)
            try:
                got = read_image(path)
            except RuntimeError as err:
                if want is None:
                    counts["both_refuse"] += 1
                elif "not read yet" in str(err):
                    counts["not_yet"] += 1
                    why = str(err).split(": an AVIF ")[-1]
                    kinds = counts["not_yet_kinds"]
                    kinds[why] = kinds.get(why, 0) + 1
                    print("not yet", desc, err, file=sys.stderr)
                else:
                    counts["mismatch"] += 1
                    keep(a.keep, data, counts)
                    print("refused", desc, err, file=sys.stderr)
                continue
            if want is not None and got.shape == want.shape and \
                    (got == want[..., ::-1]).all():
                counts["equal"] += 1
                info = tools(data)
                counts["palette"] += info[20] > 0
                counts["intrabc"] += info[21] > 0
            else:
                counts["mismatch"] += 1
                keep(a.keep, data, counts)
                print("mismatch", desc, file=sys.stderr)
    print(json.dumps(counts))
    return 1 if counts["mismatch"] else 0


if __name__ == "__main__":
    sys.exit(main())
