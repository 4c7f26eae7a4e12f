"""A wider sweep than the tier-1 tests of the port's JPEG 2000 reader on HT
code-blocks and Part 2 markers against cv2, on the CPU (not collected by
pytest; needs cv2 and the system libopenjp2):

    python tests/torch_j2k_sweep.py [--files 5000] [--seed 0] [--jobs 1]
                                    [--keep DIR]

Each file is drawn at random.  Most (HT) are ``torch_j2k_ht``'s
codestreams: a size of 1-96 a side (now and then wider), 1, 3 or 4
components of 8, 12 or 16 bits, 1-5 resolutions, code-blocks of 4-64 a
side (1024x4 now and then), samples through the 5/3 (and the RCT) or
random 9/7 indices under derived or expounded step sizes, a cleanup
plane of 0-3 with 1-3 passes, 1-3 layers, tiles, precincts, LRCP or
RLCP, SOP and EPH, VSC and the other style bits beside HT, CAP and CPF
variants, a JPH box around it now and then.  The rest (Part 2) are
libopenjp2's ``opj_set_MCT`` files, Part 1 files and HT files whose main
header gets random CBD, MCT, MCC and MCO markers (element and array
types, indices, collections, stages, lengths) and a random COD MCT byte.
A quarter of all files is then cut or has 1-3 bytes overwritten.  A file
passes when ``read_image`` equals ``cv2.imread(path)[..., ::-1]`` bit for
bit, or when both refuse it (the port raising ``RuntimeError`` naming the
file).  Prints one JSON line of counts; exits 1 on any mismatch.
``--jobs J`` splits the files over J processes (seeds seed .. seed + J -
1); ``--keep DIR`` keeps each mismatching file there.
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

import torch_j2k_ht as ht  # noqa: E402
import torch_make_image_fixtures as fx  # noqa: E402

from gsplat_tpu_torch.utils.image_io import read_image  # noqa: E402


def _pick(rng, items, p=None):
    return items[int(rng.choice(len(items), p=p))]


def random_ht(rng) -> tuple[bytes, dict]:
    """One random HT codestream (or JPH file) → (bytes, what was drawn)."""
    h, w = (int(v) for v in rng.integers(1, 97, 2))
    if rng.random() < 0.05:
        w = int(rng.integers(300, 1100))
    nc = _pick(rng, [3, 3, 3, 1, 4])
    prec = _pick(rng, [8, 8, 12, 16])
    numres = int(rng.integers(1, 6))
    while numres > 1 and min(h, w) >> (numres - 1) < 1:
        numres -= 1
    cw = int(rng.integers(2, 7))
    ch = int(rng.integers(2, min(7, 13 - cw)))
    if rng.random() < 0.05:
        cw, ch = 10, 2
    passes = int(rng.integers(1, 4))
    plane = int(rng.integers(1 if passes > 1 else 0, 4))
    layers = int(rng.integers(1, 4))
    salt = int(rng.integers(1 << 30))
    drawn = dict(size=(h, w), comps=nc, prec=prec, numres=numres,
                 cblk=(cw, ch), passes=passes, plane=plane, layers=layers)
    kw = dict(numres=numres, cblk=(cw, ch), passes=passes, plane=plane,
              layers=layers, prec=prec, fallback=False,
              layer_of=lambda *k: hash((salt,) + k) % layers)
    if rng.random() < 0.3:
        kw["tiles"] = tuple(int(v) for v in rng.integers(4, 64, 2))
    if rng.random() < 0.2:
        kw["precincts"] = [tuple(int(v) for v in rng.integers(
            3 if r else 2, 7, 2)) for r in range(numres)]
    kw["prog"] = _pick(rng, ["LRCP", "RLCP"])
    kw["sop"], kw["eph"] = bool(rng.random() < 0.2), bool(rng.random() < 0.2)
    kw["style"] = 0x40 | (_pick(rng, [0, 0, 0, 8, 1, 2, 4, 16, 32, 0x3F])
                          if rng.random() < 0.4 else 0)
    cap = rng.random()
    if cap < 0.1:
        kw["cap"] = b""
    elif cap < 0.2:
        kw["cap"] = ht.cap_marker(bytes(rng.integers(0, 256, int(
            rng.integers(0, 8)), np.uint8)))
    if rng.random() < 0.2:
        kw["cpf"] = ht.cpf_marker(tuple(int(v) for v in rng.integers(
            0, 1 << 16, int(rng.integers(1, 4)))))
    if rng.random() < 0.5:
        img = fx.fixture_image(h, w, seed=salt % 1000)
        planes = [img[..., k].astype(np.int64) for k in range(3)]
        if prec > 8:
            planes = [(p << (prec - 8)) + rng.integers(0, 1 << (prec - 8),
                                                       p.shape)
                      for p in planes]
        planes = (planes + planes[:1])[:nc]
        if nc >= 3 and rng.random() < 0.5:
            kw["mct"] = 1
        drawn["wavelet"] = "5/3"
        data = ht.ht_codestream(planes, **kw)
    else:
        expn = int(rng.integers(prec, prec + 6))
        amp = int(rng.integers(1, 1 << min(expn, 16)))
        geo_tiles = kw.get("tiles") or (h, w)
        ntx = -(-w // geo_tiles[1])
        nty = -(-h // geo_tiles[0])
        coeffs = []
        for t in range(ntx * nty):
            ty, tx = t // ntx, t % ntx
            th = min(geo_tiles[0], h - ty * geo_tiles[0])
            tw = min(geo_tiles[1], w - tx * geo_tiles[1])
            coeffs.append([rng.integers(-amp, amp + 1, (th, tw)) * (
                rng.random((th, tw)) < rng.random()) for _ in range(nc)])
        qstyle = _pick(rng, [1, 2])
        drawn["wavelet"] = f"9/7 qstyle {qstyle}"
        # derived step sizes shrink the high bands' exponents: keep every
        # coefficient inside its band's bit-planes
        lim = 1 << (expn + 2 - numres if qstyle == 1 else expn + 1)
        coeffs = [[np.clip(c, -(lim - 1), lim - 1) for c in ct]
                  for ct in coeffs]
        data = ht.ht_codestream(coeffs=coeffs, size=(h, w), reversible=False,
                                qstyle=qstyle, expn=expn,
                                mant=int(rng.integers(2048)), **kw)
    if rng.random() < 0.25:
        data = ht.jph_file(data, nc, h, w, colr=17 if nc == 1 else 16,
                           bpc=prec - 1)
        drawn["jph"] = True
    return data, drawn


def random_part2(rng) -> tuple[bytes, dict]:
    """A file whose main header carries random Part 2 markers."""
    img = fx.fixture_image(int(rng.integers(8, 40)), int(rng.integers(8, 40)),
                           seed=int(rng.integers(1000)))
    planes = [img[..., k] for k in range(3)]
    src = _pick(rng, ["opj_set_MCT", "part1", "ht"])
    if src == "opj_set_MCT":
        off = [int(v) for v in rng.integers(-200, 300, 3)]
        cs = fx.openjpeg_encode(planes, mct_array=(np.eye(3)[rng.permutation(
            3)], off), numres=int(rng.integers(1, 4)))
    elif src == "part1":
        cs = fx.openjpeg_encode(planes, numres=int(rng.integers(1, 4)),
                                irreversible=bool(rng.random() < 0.5))
    else:
        cs = ht.ht_codestream(planes, numres=int(rng.integers(1, 4)),
                              passes=3, plane=1)
    ms, rest = ht.main_markers(cs)
    ms = [m for m in ms if m[0] not in (0xFF74, 0xFF75, 0xFF77, 0xFF78)]
    for m in ms:
        if m[0] == 0xFF52:
            m[1][4] = _pick(rng, [0, 0, 1, 2])
    extra = []
    elements = list(ht._EL)
    nrec = int(rng.integers(0, 4))
    for _ in range(nrec):
        el = _pick(rng, elements)
        kind = int(rng.integers(0, 4))
        n = _pick(rng, [3, 9, 2, 4])
        vals = (rng.integers(0, 1 << 16, n) if el == "i16" else
                rng.integers(-(1 << 31), 1 << 31, n) if el == "i32" and
                rng.random() < 0.2 else rng.integers(-300, 300, n))
        vals = [float(v) if el[0] == "f" else int(v) for v in vals]
        extra.append(ht.mct(int(rng.integers(0, 4)), kind, vals, el,
                            zmct=int(rng.random() < 0.1),
                            ymct=int(rng.random() < 0.1)))
    for _ in range(int(rng.integers(0, 3))):
        extra.append(ht.mcc(int(rng.integers(0, 4)), int(rng.integers(0, 4)),
                            int(rng.integers(0, 4)),
                            n=_pick(rng, [3, 3, 2]),
                            coll=_pick(rng, [1, 1, 0, 2]),
                            xmcc=_pick(rng, [1, 1, 1, 0, 3]),
                            wide=bool(rng.random() < 0.2),
                            reversible=bool(rng.random() < 0.5)))
    if rng.random() < 0.8:
        extra.append(ht.mco(*[int(v) for v in rng.integers(
            0, 4, _pick(rng, [1, 1, 0, 2]))]))
    if rng.random() < 0.3:
        extra.append(ht.cbd([int(v) for v in rng.integers(
            6, 16, 3)] if rng.random() < 0.9 else [0x87, 7, 7]))
    rng.shuffle(extra)
    at = next(i for i, m in enumerate(ms) if m[0] == 0xFF5C) + 1
    data = ht.join_markers(ms[:at] + extra + ms[at:], rest)
    return data, dict(part2=src, markers=[hex(m[0]) for m in extra])


def run(files: int, seed: int, keep) -> tuple[dict, list]:
    """``files`` files from ``seed`` → (counts, what the mismatches drew)."""
    os.environ.setdefault("OPENCV_LOG_LEVEL", "OFF")
    import cv2

    rng = np.random.default_rng(seed)
    counts = dict(files=0, equal=0, refused_by_both=0, mismatches=0,
                  ht_files=0, ht_refined=0, ht_97=0, jph=0, part2_files=0,
                  part2_read=0, cut=0, overwritten=0)
    mismatched = []
    with tempfile.TemporaryDirectory() as tmp:
        while counts["files"] < files:
            if rng.random() < 0.7:
                try:
                    data, drawn = random_ht(rng)
                except ValueError:          # past what the writer codes
                    continue
                counts["ht_files"] += 1
                counts["ht_refined"] += drawn["passes"] > 1
                counts["ht_97"] += drawn["wavelet"] != "5/3"
                counts["jph"] += bool(drawn.get("jph"))
            else:
                data, drawn = random_part2(rng)
                counts["part2_files"] += 1
            mut = rng.random()
            if mut < 0.1:
                data = data[:int(rng.integers(1, len(data)))]
                counts["cut"] += 1
                drawn["cut"] = len(data)
            elif mut < 0.25:
                data = bytearray(data)
                for _ in range(int(rng.integers(1, 4))):
                    data[int(rng.integers(len(data)))] = int(rng.integers(256))
                data = bytes(data)
                counts["overwritten"] += 1
                drawn["overwritten"] = True
            counts["files"] += 1
            path = os.path.join(tmp, f"sweep_{counts['files']}.j2k")
            with open(path, "wb") as f:
                f.write(data)
            try:
                want = cv2.imread(path)
            except cv2.error:
                want = None
            try:
                got = read_image(path)
            except RuntimeError as err:
                got = None
                assert path in str(err), err
            os.remove(path)
            if want is None and got is None:
                counts["refused_by_both"] += 1
                continue
            if want is not None and got is not None and \
                    got.shape == want[..., ::-1].shape and \
                    (got == want[..., ::-1]).all():
                counts["equal"] += 1
                counts["part2_read"] += "part2" in drawn
                continue
            counts["mismatches"] += 1
            mismatched.append(drawn)
            if keep:
                os.makedirs(keep, exist_ok=True)
                with open(os.path.join(
                        keep, f"mismatch_{seed}_{counts['files']}.j2k"),
                        "wb") as f:
                    f.write(data)
    return counts, mismatched


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--files", type=int, default=5000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--jobs", type=int, default=1)
    p.add_argument("--keep", default=None)
    args = p.parse_args()
    t0 = time.time()
    share = [args.files // args.jobs + (j < args.files % args.jobs)
             for j in range(args.jobs)]
    jobs = [(n, args.seed + j, args.keep) for j, n in enumerate(share)]
    if args.jobs > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            results = pool.starmap(run, jobs)
    else:
        results = [run(*jobs[0])]
    counts = {k: sum(r[0][k] for r in results) for k in results[0][0]}
    mismatched = [d for r in results for d in r[1]]
    counts["seconds"] = round(time.time() - t0, 1)
    counts["seed"] = args.seed
    counts["jobs"] = args.jobs
    print(json.dumps(counts))
    for d in mismatched[:20]:
        print("mismatch:", json.dumps(d, default=str), file=sys.stderr)
    return 1 if counts["mismatches"] else 0


if __name__ == "__main__":
    sys.exit(main())
