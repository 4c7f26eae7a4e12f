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
With ``--avis`` every file is instead an image sequence: Pillow's
``save_all=True`` of two frames (the second a copy of the first, or the
image flipped) at a random speed (1-9), quality, subsampling, ``aq-mode``
and the options above, from RGB or RGBA (an alpha track).
``read_image`` must equal ``cv2.imread(path)[..., ::-1]`` bit for bit, or
both refuse the file.  Prints one JSON line of counts (and the
files that used palette, intra block copy, loop restoration and
segmentation, and Pillow's files with limited range, an ICC profile, a
premultiplied alpha and an EXIF orientation: a quarter, a fifth, half the
RGBA ones and a fifth of the stills); exits 1 on any mismatch.
``--keep DIR`` keeps each mismatching file there.

With ``--libavif`` every file is instead one of the kinds of libavif's own
path, its scaling and libaom's superres and delta loop filter
(``random_libavif``): libaom's own encoder (``libaom_encode``, in a forked
child, since the library can corrupt its heap) at 8, 10 or 12 bits in any
chroma format with superres at a random denominator (9-16) in 70% of the
files and ``deltaq-mode`` 2, 3 or 6 with ``deltalf-mode`` in half
(delta_lf_multi set by hand in a tenth of those), tile columns, loop
restoration, both usages, film grain in a tenth; cv2's and libavif's
encoder's files with a hand-edited nclx (any matrix 0-20, primaries, range;
libavif's 4:4:4 and 4:2:2 with an alpha, premultiplied or not); files
whose frames libavif scales (an item's ispe, an alpha item's, a grid's
tiles, a sequence's colour and alpha tkhd); and monochrome frames under a
colour av1C.  Files the writer refuses or crashes on are counted apart.

With ``--inter`` every file is instead several frames (``random_inter``):
libaom's own good-quality (or, in a fifth, realtime) encoder
(``libaom_encode_frames``, in a forked child) on 2-4 frames of a random
content, each moved by a random shift from the one before and the last in
part darkened (a quarter instead rotated, zoomed and moved:
``warped_frames``), at 8, 10 or 12 bits in any chroma format (4:0:0 too),
at a random speed, quantizer, tiling, superblock size, aq-mode, CDEF and
loop restoration, dual filter, reference count, error resilience, film
grain (a tenth) and superres or resizing (a twentieth each), each inter
tool of ``INTER_TOOLS_OFF`` on in three files of four (libaom has every
one on by default: motion-field projection, warped and global motion,
OBMC, inter-intra, and compound prediction's controls), libaom's default
lookahead (35 frames: a hidden ALTREF, backward references) in a third;
a tenth each with the
last frame hidden and shown by a show_existing_frame header
(``hide_last_frame``), with its references short-signaled
(``short_signal_last_frame``) and made a switch frame
(``switch_last_frame``, where it is error resilient), a tenth in a grid,
an alpha item or a track; and
one in twenty cv2's still as an intra-only frame or a hidden key frame
(``frame_of_kind``); and in a third of the files (3-7 frames, error
resilient in every frame or in random ones: ``AOM_EFLAG_ERROR_RESILIENT``)
1-3 slots' ``ref_order_hint`` rewritten in a random error resilient frame
(``rewrite_hints``: libaom rebuilds each slot that then differs; a fifth
of them then show a rewritten slot by a show_existing_frame header).  The
equal files are counted by the inter tools they use (frames predicted
from a reference of another size or with superres, switch frames, slots
rebuilt, frames and blocks that read them, reads of what a rebuilt
buffer kept, among them).

With ``--scaled`` every file is ``--inter``'s kind with frames coded at
another size than their references: libaom's ``resize`` (a denominator
9-16 for inter frames, 8 or another for key frames) or ``superres`` (a
denominator 9-16 for inter frames, key frames or both), or both, in
every file, at 8, 10 or 12 bits in any chroma format; a third of the
files with compound prediction's controls on at speeds 0-2 (where libaom
takes it), and no intra-only or hidden key frame files.

With ``--flips`` every file is instead a committed multi-frame fixture
(``AVIF_INTER_CASES``, ``AVIF_TOOLS_CASES``, ``AVIF_COMPOUND_CASES``) with
one bit of its OBUs
flipped (``random_flip``), held to cv2's verdict as above.
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
    # the colour and orientation options: limited range, an ICC profile,
    # a premultiplied alpha, an EXIF orientation (stills: Pillow segfaults
    # writing one into a sequence)
    if rng.random() < 0.25:
        opts["range"] = "limited"
    if rng.random() < 0.2:
        opts["icc"] = True
    if img.shape[2] == 4 and rng.random() < 0.5:
        opts["alpha_premultiplied"] = True
    if rng.random() < 0.2:
        opts["exif"] = int(rng.integers(1, 9))
    return pillow_file(img, opts), (
        h, w, kind, dict(writer="pillow", alpha=img.shape[2] == 4, **opts))


def pillow_options(opts: dict) -> dict:
    """random_file's description → Pillow's save options."""
    out = {k: v for k, v in opts.items() if k not in ("icc", "exif")}
    if opts.get("icc"):
        out["icc_profile"] = oracle.icc_profile()
    if "exif" in opts:
        out["exif"] = oracle.orientation_exif(opts["exif"])
    return out


def pillow_file(img, opts: dict) -> bytes:
    return oracle.pillow_avif(img, **pillow_options(opts))


def random_sequence(rng):
    """(bytes, a description) of a random image sequence: random_file's
    Pillow options, a speed and aq-mode, two frames."""
    while True:
        data, desc = random_file(rng)
        if desc[3]["writer"] == "pillow":
            break
    h, w, kind, opts = desc
    img = (oracle.screen_image(kind, h, w, rng) if kind in
           oracle.SCREEN_KINDS else oracle.avif_image(kind, h, w, rng))
    if opts["alpha"]:
        img = np.concatenate([img, oracle.screen_image(
            "blocks", h, w, rng)[..., :1]], -1)
    pil = {k: opts[k] for k in ("quality", "advanced", "subsampling",
                                "range", "alpha_premultiplied") if k in opts}
    if opts.get("icc"):
        pil["icc_profile"] = oracle.icc_profile()
    pil["speed"] = int(rng.integers(1, 10))
    if rng.random() < 0.4:
        pil["advanced"] = dict(pil["advanced"], **{"aq-mode": "1"})
    from PIL import Image
    frames = [Image.fromarray(np.ascontiguousarray(
        img[..., [2, 1, 0, 3][:img.shape[2]]]))]
    frames.append(frames[0] if rng.random() < 0.5 else
                  frames[0].transpose(Image.Transpose.FLIP_TOP_BOTTOM))
    import io
    buf = io.BytesIO()
    frames[0].save(buf, "AVIF", save_all=True, append_images=frames[1:],
                   **pil)
    pil.pop("icc_profile", None)
    opts = {k: v for k, v in opts.items() if k != "exif"}
    return buf.getvalue(), (h, w, kind, dict(opts, sequence=True, **pil))


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
        keys = ("quality", "advanced", "subsampling", "range", "icc",
                "alpha_premultiplied", "exif")
        pil = {k: opts[k] for k in keys if k in opts}
        write = lambda t: pillow_file(t, pil)  # noqa
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


_SUB = {"420": (1, 1), "422": (1, 0), "444": (0, 0)}


def _planes(img, depth, fmt, rng):
    a = oracle.deepen(img, rng).astype(np.int64) >> (16 - depth)
    sx, sy = _SUB[fmt]
    return [a[..., 0], a[::1 + sy, ::1 + sx, 1], a[::1 + sy, ::1 + sx, 2]]


def _forked(fn, *args, **kw):
    """fn(*args, **kw) (bytes) in a forked child, or None where it fails or
    the child dies."""
    rfd, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(rfd)
        try:
            data = fn(*args, **kw)
            with os.fdopen(wfd, "wb") as f:
                f.write(data)
            os._exit(0)
        except BaseException:
            os._exit(3)
    os.close(wfd)
    with os.fdopen(rfd, "rb") as f:
        data = f.read()
    _, status = os.waitpid(pid, 0)
    return data if status == 0 else None


def _scaled(data, rng):
    """A one-item file again with a random ispe."""
    obu, _ = oracle.item_parts(data)
    w, h = (int(np.exp(rng.uniform(0, np.log(600)))) for _ in range(2))
    props = [(oracle.ispe_box(w, h) if b[4:8] == b"ispe" else b, e)
             for b, e in oracle.item_props(data, 1)]
    return oracle.build_items([(1, b"av01", obu, props)], []), (w, h)


def random_libavif(rng):
    """(bytes or None where the writer failed, a description) of one file
    of ``--libavif``'s kinds."""
    h, w = (int(np.exp(rng.uniform(0, np.log(400)))) for _ in range(2))
    img = oracle.avif_image(str(rng.choice(oracle.KINDS)), h, w, rng)
    depth = int(rng.choice([8, 10, 12]))
    fmt = str(rng.choice(["420", "422", "444"]))
    pick = rng.random()
    if pick < 0.45:                 # libaom: superres, delta loop filter
        kw, ctl = {}, {"cq-level": int(rng.integers(0, 64)),
                       "enable-restoration": int(rng.integers(0, 2))}
        if rng.random() < 0.7:
            d = int(rng.integers(9, 17))
            kw["superres"] = (1, d, d)
        if rng.random() < 0.5:
            ctl.update({"deltaq-mode": int(rng.choice([2, 3, 6])),
                        "deltalf-mode": 1})
        # libaom's cpu-used 7 corrupts its own heap with deltalf-mode
        ctl["cpu-used"] = int(rng.choice([4, 5, 6, 8, 9] if
                                         "deltalf-mode" in ctl else
                                         range(4, 10)))
        if rng.random() < 0.3:
            ctl["tile-columns"] = int(rng.integers(0, 3))
        usage = int(rng.choice([0, 2]))
        data = _forked(oracle.encoded_avif, _planes(img, depth, fmt, rng),
                       depth, *_SUB[fmt], usage=usage, controls=ctl, **kw)
        desc = dict(writer="libaom", depth=depth, fmt=fmt, usage=usage,
                    **kw, **ctl)
        if data is not None and rng.random() < 0.15:
            stream, props = oracle.item_parts(data)
            try:
                info = image_io.decode_av1(stream)[1]
            except RuntimeError:
                info = None
            if info is not None and info[42] and rng.random() < 0.6:
                bit = 8 * info[23] + info[45] + 3     # delta_lf_multi
                edit = bytearray(data)
                edit[len(data) - len(stream) + bit // 8] |= \
                    0x80 >> (bit % 8)
                data, desc["multi"] = bytes(edit), True
            elif info is not None:
                g = oracle.grain_dict(oracle.grain_test_vectors()[
                    int(rng.integers(0, 16))])
                data = oracle.build_avif(oracle.with_grain(stream, g), props)
                desc["grain"] = True
        return data, (h, w, fmt, desc)
    nclx = (int(rng.choice(list(range(0, 26)) + [int(rng.integers(
        0, 65536))])) if rng.random() < 0.5 else 1, 13,
        int(rng.integers(0, 21)), bool(rng.integers(0, 2)))
    if pick < 0.7:                  # colr edits on cv2's and libavif's
        alpha = None
        if rng.random() < 0.5:
            data = oracle.cv2_avif(img if depth == 8 else
                                   oracle.deepen(img, rng) >> (16 - depth),
                                   int(rng.integers(0, 101)),
                                   None if depth == 8 else depth)
        else:
            data = oracle.libavif_encode(_planes(img, depth, fmt, rng),
                                         depth, fmt, nclx[3])
            if rng.random() < 0.4:
                alpha = oracle.libavif_encode([rng.integers(
                    0, 1 << depth, (h, w))], depth, "400")
        data = oracle.with_colr(data, [oracle.nclx(*nclx)])
        prem = False
        if alpha is not None:
            prem = bool(rng.integers(0, 2))
            data = oracle.alpha_file(data, alpha, prem)
        return data, (h, w, fmt, dict(writer="colr", nclx=nclx,
                                      alpha=alpha is not None, prem=prem))
    if pick < 0.9:                  # frames libavif scales
        which = rng.random()
        if which < 0.5:
            data, size = _scaled(oracle.cv2_avif(
                img if depth == 8 else oracle.deepen(img, rng) >>
                (16 - depth), int(rng.integers(0, 101)),
                None if depth == 8 else depth), rng)
            return data, (h, w, fmt, dict(writer="scaled", ispe=size))
        rgba = np.dstack([img, rng.integers(0, 256, (h, w)).astype(
            np.uint8)])
        prem = bool(rng.integers(0, 2))
        if which < 0.75:
            cobu, cprops, _, _ = oracle.alpha_parts(oracle.pillow_avif(
                rgba, alpha_premultiplied=prem))
            ah, aw = (int(np.exp(rng.uniform(0, np.log(300))))
                      for _ in range(2))
            _, _, aobu, aprops = oracle.alpha_parts(oracle.pillow_avif(
                np.dstack([oracle.avif_image("photo", ah, aw, rng),
                           rng.integers(0, 256, (ah, aw)).astype(np.uint8)
                           ])))
            aprops = [(b, e) for b, e in aprops if b[4:8] != b"ispe"]
            if rng.random() < 0.8:
                aprops.append((oracle.ispe_box(w, h), False))
            refs = [(b"auxl", 2, [1])] + ([(b"prem", 1, [2])] if prem
                                          else [])
            return oracle.build_items([(1, b"av01", cobu, cprops),
                                       (2, b"av01", aobu, aprops)], refs), \
                (h, w, fmt, dict(writer="alpha_scaled", prem=prem,
                                 alpha=(aw, ah)))
        (samples, props, sw, sh, _), (asamples, aprops, *_) = \
            oracle.sequence_parts(oracle.pillow_sequence(rgba))[:2]
        tk = tuple(int(np.exp(rng.uniform(0, np.log(500))))
                   for _ in range(2))
        atk = tk if rng.random() < 0.7 else None
        return oracle.build_sequence(
            samples, props, sw, sh, tkhd_size=tk, alpha=(asamples, aprops),
            alpha_tkhd_size=atk, prem_by=2 if prem else 0), \
            (h, w, fmt, dict(writer="tkhd_scaled", tkhd=tk, alpha_tkhd=atk,
                             prem=prem))
    # a monochrome frame under a colour av1C
    gray = img[..., 1]
    data = bytearray(oracle.cv2_avif(
        gray if depth == 8 else gray.astype(np.uint16) << (depth - 8),
        int(rng.integers(0, 101)), None if depth == 8 else depth))
    s, e = oracle.find_box(bytes(data), (b"meta", b"iprp", b"ipco"))
    at = [bs for k, _, bs, _ in oracle.boxes(bytes(data), s + 8, e)
          if k == b"av1C"][0]
    data[at + 2] &= ~0x10
    return oracle.with_colr(bytes(data), [oracle.nclx(*nclx)]), \
        (h, w, "400", dict(writer="mono_frame", nclx=nclx, depth=depth))


_INTER_FMTS = {"420": (1, 1), "422": (1, 0), "444": (0, 0), "400": (1, 1)}


def random_inter(rng, scaled: bool = False):
    """(bytes or None where the writer failed, a description) of one file
    of ``--inter``'s kinds (``scaled``: of ``--scaled``'s)."""
    import torch_make_image_fixtures as fx

    compound = scaled and rng.random() < 1 / 3
    top = 160 if compound else 800 if rng.random() < 0.05 else 240
    h, w = (int(np.exp(rng.uniform(np.log(8), np.log(top)))) for _ in
            range(2))
    img = oracle.avif_image(str(rng.choice(oracle.KINDS)), h, w, rng)
    if not scaled and rng.random() < 0.05:
        kind = str(rng.choice(["intra_only", "hidden_key"]))
        depth = int(rng.choice([8, 10, 12]))
        if depth > 8:
            img = oracle.deepen(img, rng) >> (16 - depth)
        obu, props = oracle.item_parts(oracle.cv2_avif(
            img, int(rng.integers(0, 100)), None if depth == 8 else depth))
        return oracle.build_avif(oracle.frame_of_kind(obu, kind), props), \
            (h, w, "420", dict(writer="libaom", kind=kind, depth=depth))
    depth = int(rng.choice([8, 10, 12]))
    fmt = str(rng.choice(list(_INTER_FMTS)))
    # a third of the files (with order hints: all but realtime's) have a
    # slot's ref_order_hint rewritten in an error resilient frame
    rebuilt = not scaled and rng.random() < 1 / 3
    n = int(rng.integers(3, 8)) if rebuilt else int(rng.integers(2, 5))
    if rng.random() < 0.25:
        frames = fx.warped_frames(img, n, float(rng.uniform(-4, 4)),
                                  float(rng.uniform(0.95, 1.05)),
                                  float(rng.uniform(-3, 3)),
                                  float(rng.uniform(-3, 3)))
    else:
        frames = fx.inter_frames(img, n, int(rng.integers(-6, 7)),
                                 int(rng.integers(-6, 7)))
    usage = 1 if rng.random() < 0.2 and not rebuilt else 0
    # each inter tool on in three files of four (libaom's default is on)
    controls = {k: int(rng.random() < 0.75) for k in oracle.INTER_TOOLS_OFF}
    lag = 35 if usage == 0 and rng.random() < 1 / 3 else 0
    slow = compound or (rng.random() < 0.1 and h * w < 40000)
    if compound:
        controls.update({k: 1 for k in oracle.COMPOUND_TOOLS})
    controls.update({
        "cpu-used": int(rng.integers(0, 3)) if slow else
        int(rng.integers(3, 7 if usage == 0 else 11)),
        "cq-level": int(rng.integers(0, 64)),
        "tile-columns": int(rng.integers(0, 3)),
        "tile-rows": int(rng.integers(0, 3)),
        "superblock-size": int(rng.integers(0, 3)),
        "aq-mode": int(rng.choice([0, 0, 1, 2, 3])),
        "enable-cdef": int(rng.random() < 0.8),
        "enable-restoration": int(rng.random() < 0.5),
        "enable-dual-filter": int(rng.random() < 0.5),
        "max-reference-frames": int(rng.integers(3, 8)),
        "enable-reduced-reference-set": int(rng.random() < 0.3),
        "error-resilient-mode": int(rng.random() < 0.1)})
    # error resilience in every frame (frame ids too), or in some frames
    # alone (AOM_EFLAG_ERROR_RESILIENT: frames without it after them)
    flags = None
    if rebuilt:
        controls["error-resilient-mode"] = int(rng.random() < 0.3)
        if not controls["error-resilient-mode"]:
            flags = {int(i): oracle.AOM_EFLAG_ERROR_RESILIENT
                     for i in rng.integers(1, n, int(rng.integers(1, n)))}
    grain = rng.random() < 0.1
    if grain:
        controls["film-grain-test-vector"] = int(rng.integers(1, 17))
    kw = {}
    r = rng.random()
    if r < 0.05 or (scaled and r < 0.6):
        d = int(rng.integers(9, 17))
        kw["superres"] = tuple(int(x) for x in rng.choice(
            [(1, d, d), (1, d, 8), (1, 8, d)]))
    if 0.05 <= r < 0.1 or (scaled and r >= 0.4):
        kd = int(rng.choice([8, int(rng.integers(9, 17))])) if scaled else 8
        kw["resize"] = (1, int(rng.integers(9, 17)), kd)
    planes = [fx.inter_planes(f, depth, fmt) for f in frames]
    sx, sy = _INTER_FMTS[fmt]
    stream = _forked(oracle.libaom_encode_frames, planes, depth, sx, sy,
                     usage=usage, mono=fmt == "400", lag=lag, flags=flags,
                     controls=controls, **kw)
    desc = dict(writer="libaom", depth=depth, fmt=fmt, frames=n,
                usage=usage, lag=lag, grain=grain, **controls, **kw)
    if stream is None:
        return None, (h, w, fmt, desc)
    if rebuilt:
        stream = rewrite_hints(stream, rng, desc)
    edit = rng.random()
    if not grain and edit < 0.3:
        # the last frame hidden and shown by show_existing_frame, its
        # references short-signaled, or made a switch frame
        how = ("hidden", "short_signaled", "switch")[int(edit * 10)]
        try:
            stream = {"hidden": oracle.hide_last_frame,
                      "short_signaled": oracle.short_signal_last_frame,
                      "switch": oracle.switch_last_frame}[how](stream)
            desc[how] = True
        except (AssertionError, RuntimeError):
            pass
    data = fx.inter_avif(stream, w, h, depth, fmt)
    r = rng.random()
    if r < 0.03 and h >= 64 and w >= 64 and fmt != "400":
        tile = oracle.tile_item(data)
        data = oracle.grid_avif([tile, tile], 1, 2, 2 * w, h)
        desc["grid"] = True
    elif r < 0.06 and fmt != "400":
        alpha = fx.inter_avif(_forked(
            oracle.libaom_encode_frames, [p[:1] for p in planes], depth, 1,
            1, mono=True, controls=controls) or b"", w, h, depth, "400")
        data = oracle.alpha_file(data, alpha, bool(rng.random() < 0.5))
        desc["alpha"] = True
    elif r < 0.1:
        obu, props = oracle.item_parts(data)
        data = oracle.build_sequence([obu], props, w, h)
        desc["track"] = True
    return data, (h, w, fmt, desc)


def rewrite_hints(stream: bytes, rng, desc: dict) -> bytes:
    """The stream with ref_order_hint[] rewritten in a random error
    resilient inter frame: 1-3 random slots given random order hints
    (libaom rebuilds each that then differs), the frame and the slots in
    ``desc``; in a fifth, a show_existing_frame header of a rewritten slot
    after the last frame (where the sequence has no frame ids)."""
    frames = sum(1 for k, _, _ in oracle.obus(stream) if k == 6)
    er = []
    for k in range(frames):
        try:
            if oracle.frame_refs(stream, k)["resilient"]:
                er.append(k)
        except AssertionError:           # an intra frame
            pass
    if not er:
        return stream
    k = er[int(rng.integers(len(er)))]
    f = oracle._inter_frame(stream, None, k)
    seq, bits = f["seq"], f["bits"]
    slots = sorted(set(int(i) for i in rng.integers(0, 8, int(
        rng.integers(1, 4)))))
    n = seq["hint_bits"]
    for slot in slots:
        at = f["hints"] + n * slot
        bits = bits[:at] + format(int(rng.integers(1 << n)), f"0{n}b") + \
            bits[at + n:]
    stream = oracle._with_header(f, bits)
    desc.update(rebuilt_frame=k, rebuilt_slots=slots)
    if not seq["id_bits"] and rng.random() < 0.2:
        stream += oracle.obu(3, oracle._bytes("1" + format(slots[0], "03b") +
                                              "1"))
        desc["show_rebuilt"] = True
    return stream


def random_flip(rng):
    """(bytes, a description) of a committed multi-frame fixture with one
    bit of its OBUs flipped."""
    import torch_make_image_fixtures as fx

    names = fx.AVIF_INTER_CASES + fx.AVIF_TOOLS_CASES + \
        fx.AVIF_COMPOUND_CASES
    name = names[int(rng.integers(len(names)))]
    with open(os.path.join(fx.FOLDER, name), "rb") as f:
        obu, props = oracle.item_parts(f.read())
    data = bytearray(obu)
    at, bit = int(rng.integers(len(data))), int(rng.integers(8))
    data[at] ^= 1 << bit
    return oracle.build_avif(bytes(data), props), (0, 0, "", dict(
        writer="libaom", file=name, byte=at, bit=bit))


def tools(data: bytes):
    """decode_av1's info on a file's primary item, or its colour track's
    first sample."""
    heif = image_io._Heif(data, "file")
    heif.parse()
    if heif.source == "tracks":
        return image_io.decode_av1(heif.track_image(
            heif.colour_track()[0])[0])[1]
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
    p.add_argument("--avis", action="store_true",
                   help="image sequences only")
    p.add_argument("--libavif", action="store_true",
                   help="libavif's own path, scaling, superres, delta LF")
    p.add_argument("--inter", action="store_true",
                   help="several frames: intra-only, hidden, inter")
    p.add_argument("--scaled", action="store_true",
                   help="several frames, of another size than their "
                        "references: resize and superres")
    p.add_argument("--flips", action="store_true",
                   help="one-bit flips of the committed inter fixtures")
    a = p.parse_args()
    rng = np.random.default_rng(a.seed)
    counts = dict(files=0, equal=0, both_refuse=0, writer_fail=0,
                  mismatch=0, cv2=0, pillow=0, libaom=0, colr=0, scaled=0,
                  alpha_scaled=0, tkhd_scaled=0, mono_frame=0, superres=0,
                  delta_lf=0, grid=0, grain=0, palette=0,
                  intrabc=0, restoration=0, segmentation=0, limited=0,
                  icc=0, premultiplied=0, exif=0,
                  multi_frame=0, intra_only=0, show_existing=0, nearestmv=0,
                  nearmv=0, globalmv=0, newmv=0, smooth_or_sharp=0,
                  dual_filter=0, ref_frame_mvs=0, temporal=0, local_warp=0,
                  local_warp_invalid=0, global_motion=0, global_warped=0,
                  obmc=0, interintra_smooth=0, interintra_wedge=0,
                  compound_average=0, compound_distance=0, compound_wedge=0,
                  compound_diffwtd=0, skip_mode=0, single_by_compound=0,
                  lookahead=0, scaled_prediction=0, superres_inter=0,
                  switch_frame=0, scaled_unwarped=0, superres_ref=0,
                  resize_drawn=0, superres_drawn=0, rebuilt_drawn=0,
                  rebuilt=0, rebuilt_named=0, rebuilt_predicted=0,
                  rebuilt_leftover=0)
    end = time.time() + a.seconds
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "sweep.avif")
        while time.time() < end:
            try:
                if a.flips:
                    data, desc = random_flip(rng)
                elif a.inter or a.scaled:
                    data, desc = random_inter(rng, a.scaled)
                    if data is None:
                        raise RuntimeError("the writer failed")
                elif a.libavif:
                    data, desc = random_libavif(rng)
                    if data is None:
                        raise RuntimeError("the writer failed")
                elif a.avis:
                    data, desc = random_sequence(rng)
                else:
                    data, desc = random_grid(rng) if rng.random() < 0.1 \
                        else random_file(rng)
            except Exception:             # a writer refusing its options
                counts["writer_fail"] += 1
                continue
            with open(path, "wb") as f:
                f.write(data)
            counts["files"] += 1
            counts[desc[3]["writer"]] += 1
            counts["grid"] += "grid" in desc[3]
            grain = str(desc[3].get("advanced", {}))
            counts["grain"] += "grain" in grain or "denoise" in grain or \
                bool(desc[3].get("grain"))
            counts["limited"] += desc[3].get("range") == "limited"
            counts["icc"] += bool(desc[3].get("icc"))
            counts["premultiplied"] += bool(desc[3].get(
                "alpha_premultiplied"))
            counts["exif"] += "exif" in desc[3]
            counts["resize_drawn"] += "resize" in desc[3]
            counts["superres_drawn"] += "superres" in desc[3]
            counts["rebuilt_drawn"] += "rebuilt_frame" in desc[3]
            want = cv2.imread(path)
            try:
                got = read_image(path)
            except RuntimeError as err:
                if want is None:
                    counts["both_refuse"] += 1
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
                counts["restoration"] += any(info[26:29])
                counts["segmentation"] += info[31] > 0
                counts["superres"] += info[40] != 8
                counts["delta_lf"] += info[42] > 0
                counts["multi_frame"] += info[46] + info[48] > 1
                counts["intra_only"] += info[47] > 0
                counts["show_existing"] += info[48] > 0
                for k, name in enumerate(("nearestmv", "nearmv", "globalmv",
                                          "newmv")):
                    counts[name] += info[49 + k] > 0
                counts["smooth_or_sharp"] += info[54] + info[55] > 0
                counts["dual_filter"] += info[57] > 0
                for k, name in enumerate((
                        "ref_frame_mvs", "temporal", "local_warp",
                        "local_warp_invalid", "global_motion",
                        "global_warped", "obmc", "interintra_smooth",
                        "interintra_wedge", "compound_average",
                        "compound_distance", "compound_wedge",
                        "compound_diffwtd", "skip_mode",
                        "single_by_compound")):
                    counts[name] += info[58 + k] > 0
                for k, name in enumerate((
                        "scaled_prediction", "superres_inter",
                        "switch_frame", "scaled_unwarped", "superres_ref")):
                    counts[name] += info[73 + k] > 0
                for k, name in enumerate((
                        "rebuilt", "rebuilt_named", "rebuilt_predicted",
                        "rebuilt_leftover")):
                    counts[name] += info[80 + k] > 0
                counts["lookahead"] += bool(desc[3].get("lag"))
            else:
                counts["mismatch"] += 1
                keep(a.keep, data, counts)
                print("mismatch", desc, file=sys.stderr)
    print(json.dumps(counts))
    return 1 if counts["mismatch"] else 0


if __name__ == "__main__":
    sys.exit(main())
