"""The port's AVIF reader on the kinds Pillow's own options write beyond
cv2's writer: libaom's screen content tools (palette and intra block
copy), 4:2:2 and 4:0:0 chroma, and the alpha item; against cv2 5.0.0
(libavif 1.4.2, libaom 3.14.1, libyuv 1924) bit for bit, or both refuse.
Each tool is shown in use through ``decode_av1``'s info (the palette and
IntraBC blocks decoded).  Stage oracles, through ctypes on the
opencv-python wheel's libaom (``tests/torch_avif_oracles.py``): the palette
cache, the colour index context and the IntraBC convolution against
libaom's own functions by ELF symbol, the planes against libavif's.
"""

import ctypes
import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils import image_io
from gsplat_tpu_torch.utils.image_io import read_avif, read_image

import torch_avif_oracles as oracle

# decode_av1's info: screen content tools, intra block copy allowed, the
# palette blocks and the IntraBC blocks decoded
SCT, ALLOW_IBC, N_PALETTE, N_IBC = 18, 19, 20, 21
SCREEN = {"tune-content": "screen"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


@pytest.fixture
def pil():
    pytest.importorskip("PIL.AvifImagePlugin")


def _same_as_cv2(cv2, path, data=None):
    """The port's decode against cv2's: equal bit for bit, or cv2 refuses
    and the port raises naming the file.  → whether cv2 read it."""
    if data is not None:
        path.write_bytes(data)
    want = cv2.imread(str(path))
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    return True


def _info(data: bytes):
    heif = image_io._Heif(data, "file")
    heif.parse()
    return image_io.decode_av1(heif.primary_item()[0])[1]


# ------------------------------------------------------------- palette


@pytest.mark.parametrize("size", [(64, 64), (96, 128), (130, 67), (257, 129),
                                  (33, 250)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["blocks", "text"])
def test_palette_matches_cv2(cv2, pil, tmp_path, kind, size):
    # palette blocks (sizes whose blocks overhang the frame's edge too):
    # Pillow's default on text-like content, and tune-content=screen;
    # the small sizes use the palette without intra block copy
    rng = np.random.default_rng(size[0] * 3 + size[1])
    img = oracle.screen_image(kind, *size, rng)
    used = 0
    for opts in (dict(), dict(advanced=SCREEN),
                 dict(subsampling="4:4:4", advanced=SCREEN)):
        data = oracle.pillow_avif(img, **opts)
        assert _same_as_cv2(cv2, tmp_path / "p.avif", data)
        info = _info(data)
        used += info[N_PALETTE]
        if info[N_PALETTE] and size[0] * size[1] < 20000:
            assert info[ALLOW_IBC] == 0 or info[N_IBC] == 0
    assert used > 0


def test_default_ramp_turns_the_tools_on(cv2, pil, tmp_path):
    # Pillow's default on a large smooth ramp: libaom's content test sets
    # allow_screen_content_tools (the 833x1183 file PR 17's sweep found)
    img = oracle.avif_image("smooth", 1183, 833, np.random.default_rng(0))
    data = oracle.pillow_avif(img)
    assert _same_as_cv2(cv2, tmp_path / "ramp.avif", data)
    assert _info(data)[SCT] == 1


# ---------------------------------------------------- intra block copy


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:2:2"])
@pytest.mark.parametrize("layout", ["sb64", "sb128", "tiles_2x1",
                                    "tiles_2x2_sb128"])
def test_intrabc_matches_cv2(cv2, pil, tmp_path, sub, layout):
    # text-like content under tune-content=screen: intra block copy (and
    # palette) in use, with 64 and 128 superblocks and several tilings
    adv = dict(SCREEN)
    if "sb128" in layout:
        adv["sb-size"] = "128"
    if "tiles" in layout:
        adv["tile-columns"] = "1"
    if "2x2" in layout:
        adv["tile-rows"] = "1"
    rng = np.random.default_rng(len(layout) + len(sub))
    ibc = 0
    for size, quality in (((200, 300), 60), ((257, 129), 30),
                          ((144, 520), 85)):
        img = oracle.screen_image("text", *size, rng)
        data = oracle.pillow_avif(img, subsampling=sub, quality=quality,
                                  advanced=adv)
        assert _same_as_cv2(cv2, tmp_path / "ibc.avif", data)
        info = _info(data)
        assert info[SCT] == 1
        ibc += info[N_IBC]
        if "tiles" in layout and size == (144, 520):
            assert info[10] == 2
    assert ibc > 0


@pytest.mark.parametrize("variant", ["lossless", "qm", "deltaq", "cdef",
                                     "mono", "mono_qm"])
def test_screen_header_branches_match_cv2(cv2, pil, tmp_path, variant):
    # the frame header's branches under screen content: with intra block
    # copy the loop filter, CDEF, loop restoration and delta LF fields are
    # not read; a monochrome frame reads no U/V fields but qm_u
    opts = dict(quality=100 if variant == "lossless" else 50,
                advanced=dict(SCREEN))
    if variant in ("qm", "mono_qm"):
        opts["advanced"]["enable-qm"] = "1"
    if variant == "deltaq":
        opts["advanced"]["deltaq-mode"] = "1"
    if variant == "cdef":
        opts["advanced"]["enable-cdef"] = "1"
    if variant.startswith("mono"):
        opts["subsampling"] = "4:0:0"
    rng = np.random.default_rng(len(variant))
    seen = {"ibc": 0, "no_ibc": 0}
    for size in ((200, 300), (96, 128)):
        for kind in ("text", "blocks", "photo"):
            img = (oracle.avif_image(kind, *size, rng) if kind == "photo"
                   else oracle.screen_image(kind, *size, rng))
            data = oracle.pillow_avif(img, **opts)
            assert _same_as_cv2(cv2, tmp_path / "h.avif", data)
            info = _info(data)
            seen["ibc" if info[ALLOW_IBC] else "no_ibc"] += 1
            if variant == "lossless":
                assert info[15] == 1
    assert seen["ibc"] and seen["no_ibc"], seen


def test_intrabc_flips_end_as_cv2_ends(cv2, pil, tmp_path):
    # one flipped bit in the tile data of files that use intra block copy:
    # a DV read wrong points outside the decoded area, where libaom marks
    # the frame corrupt and cv2 returns None (some flips must end so); or
    # both read the same image
    rng = np.random.default_rng(18)
    counts = {"same": 0, "both refuse": 0, "dv": 0}
    for trial in range(48):
        img = oracle.screen_image("text", int(rng.integers(120, 200)),
                                  int(rng.integers(200, 320)), rng)
        data = bytearray(oracle.pillow_avif(img, quality=int(rng.integers(
            30, 90)), advanced=SCREEN))
        obu, _ = oracle.item_parts(bytes(data))
        start = len(data) - len(obu) + 12
        data[int(rng.integers(start, len(data)))] ^= 1 << int(
            rng.integers(0, 8))
        path = tmp_path / f"flip{trial}.avif"
        path.write_bytes(bytes(data))
        want = cv2.imread(str(path))
        try:
            got = read_image(str(path))
        except RuntimeError as err:
            assert path.name in str(err) and want is None, str(err)
            counts["both refuse"] += 1
            counts["dv"] += "intra block copy vector" in str(err)
            continue
        assert want is not None, path.name
        np.testing.assert_array_equal(got, want[..., ::-1])
        counts["same"] += 1
    assert counts["dv"], counts


# --------------------------------------------------------- 4:2:2, 4:0:0


@pytest.mark.parametrize("option", ["default", "q20", "q90", "lossless",
                                    "cdef", "sb128", "tiles", "cdef_qm"])
@pytest.mark.parametrize("sub", ["4:2:2", "4:0:0"])
def test_subsampling_matches_cv2(cv2, pil, tmp_path, sub, option):
    # Pillow's 4:2:2 (profile 2) and 4:0:0 files with libaom's options:
    # the 4:2:2 chroma through CDEF's chroma directions, the deblocking
    # filter's chroma edges, CfL and libyuv's horizontal upsampling; the
    # 4:0:0 luma copied to gray as OpenCV copies it
    quality = {"q20": 20, "q90": 90, "lossless": 100}.get(option, 50)
    adv = {"cdef": {"enable-cdef": "1"}, "sb128": {"sb-size": "128"},
           "tiles": {"tile-columns": "1", "tile-rows": "1"},
           "cdef_qm": {"enable-cdef": "1", "enable-qm": "1"}}.get(option, {})
    rng = np.random.default_rng(len(option) * 7 + len(sub))
    for size in ((300, 512), (77, 131), (1, 1), (5, 3), (17, 64)):
        for kind in ("photo", "noise", "smooth"):
            img = oracle.avif_image(kind, *size, rng)
            data = oracle.pillow_avif(img, subsampling=sub, quality=quality,
                                      advanced=adv)
            assert _same_as_cv2(cv2, tmp_path / "s.avif", data)
            info = _info(data)
            assert info[3:6] == ([1, 0, 0] if sub == "4:2:2" else [1, 1, 1])


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_cv2_gray_matches_cv2(cv2, tmp_path, depth):
    # cv2 writes a gray image as 4:0:0; past 8 bits OpenCV converts the
    # luma with convertTo (rounded half to even)
    rng = np.random.default_rng(depth)
    for size in ((40, 56), (1, 1), (65, 130)):
        for quality in (30, 75, 100):
            gray = oracle.avif_image("photo", *size, rng)[..., 1]
            if depth > 8:
                gray = (gray.astype(np.uint16) << (depth - 8)) + \
                    rng.integers(0, 1 << (depth - 8), gray.shape,
                                 dtype=np.uint16)
            data = oracle.cv2_avif(gray, quality,
                                   None if depth == 8 else depth)
            assert _same_as_cv2(cv2, tmp_path / "g.avif", data)
            assert _info(data)[5] == 1


def _av1c_at(data):
    s, e = oracle.find_box(data, (b"meta", b"iprp", b"ipco"))
    return [bs for k, _, bs, _ in oracle.boxes(data, s + 8, e)
            if k == b"av1C"][0]


@pytest.mark.parametrize("case", ["colour_frame", "colour_frame_d10",
                                  "colour_frame_d12", "mono_frame",
                                  "mono_frame_d10"])
def test_av1c_monochrome_flag_matches_cv2(cv2, pil, tmp_path, case):
    # libavif takes av1C's monochrome flag: over a colour frame cv2 gets
    # the luma as gray; a monochrome frame under a colour av1C goes through
    # libavif's I400 conversion (the port reads it at 8 bits)
    rng = np.random.default_rng(len(case))
    img = oracle.avif_image("photo", 40, 56, rng)
    depth = int(case[-2:]) if "_d" in case else 8
    if case.startswith("colour"):
        src = oracle.deepen(img, rng) >> (16 - depth) if depth > 8 else img
        data = oracle.cv2_avif(src, 60, None if depth == 8 else depth)
    else:
        gray = img[..., 1].astype(np.uint16) << (depth - 8)
        data = oracle.cv2_avif(gray if depth > 8 else img[..., 1], 60,
                               None if depth == 8 else depth)
    edit = bytearray(data)
    edit[_av1c_at(data) + 10] ^= 0x10
    path = tmp_path / f"{case}.avif"
    path.write_bytes(bytes(edit))
    if case == "mono_frame_d10":
        assert cv2.imread(str(path)) is not None
        with pytest.raises(RuntimeError, match="monochrome frame.*not read "
                                               "yet"):
            read_image(str(path))
        return
    assert _same_as_cv2(cv2, path)


# --------------------------------------------------------------- alpha


@pytest.mark.parametrize("sub", ["4:2:0", "4:4:4", "4:2:2"])
@pytest.mark.parametrize("size", [(1, 1), (40, 56), (130, 67), (300, 200)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_alpha_matches_cv2(cv2, pil, tmp_path, sub, size):
    # Pillow's RGBA: an alpha item (a 4:0:0 AV1 stream behind auxl and
    # auxC) that cv2 decodes and drops
    rng = np.random.default_rng(size[0] + len(sub))
    img = oracle.avif_image("photo", *size, rng)
    alpha = oracle.screen_image("blocks", *size, rng)[..., :1]
    data = oracle.pillow_avif(np.concatenate([img, alpha], -1),
                              subsampling=sub)
    assert _same_as_cv2(cv2, tmp_path / "a.avif", data)
    _, _, aobu, _ = oracle.alpha_parts(data)
    assert image_io.decode_av1(aobu)[1][5] == 1


def _alpha_cases(rng):
    """Hand-edited alpha items: name -> (file, whether cv2 reads it)."""
    img = oracle.avif_image("photo", 40, 56, rng)
    rgba = np.dstack([img, rng.integers(0, 256, img.shape[:2], np.uint8)])
    c_obu, c_props, a_obu, a_props = oracle.alpha_parts(
        oracle.pillow_avif(rgba))
    img2 = oracle.avif_image("photo", 32, 48, rng)
    small = oracle.alpha_parts(oracle.pillow_avif(np.dstack([img2,
                                                             img2[..., 0]])))[2]
    gray10 = (img[..., 0].astype(np.uint16) << 2)
    deep = oracle.item_parts(oracle.cv2_avif(gray10, 60, 10))[0]

    def kind(p):
        return p[0][4:8]

    def drop(props, k):
        return [p for p in props if kind(p) != k]

    def repl(props, k, box):
        return [(box, e) if kind((p, e)) == k else (p, e) for p, e in props]

    def ispe(w, h):
        return oracle.full_box(b"ispe", 0, 0, struct.pack(">II", w, h))

    def auxc(urn, version=0):
        return oracle.full_box(b"auxC", version, 0, urn)

    alpha_urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
    av1c10 = [(p[:10] + bytes([p[10] | 0x40]) + p[11:] if kind((p, e)) ==
               b"av1C" else p, e) for p, e in a_props]
    pixi10 = repl(av1c10, b"pixi", oracle.full_box(b"pixi", 0, 0,
                                                   bytes([1, 10])))
    auxl = [(b"auxl", 2, [1])]
    cases = {
        "pillow": (a_obu, a_props, auxl, True),
        "no_alpha_ispe": (a_obu, drop(a_props, b"ispe"), auxl, True),
        "alpha_ispe_other": (a_obu, repl(a_props, b"ispe", ispe(64, 40)),
                             auxl, False),
        "alpha_ispe_cut": (a_obu, repl(a_props, b"ispe", oracle.full_box(
            b"ispe", 0, 0, struct.pack(">I", 56))), auxl, False),
        "depth_urn": (a_obu, repl(a_props, b"auxC", auxc(
            b"urn:mpeg:hevc:2015:auxid:2\0")), auxl, True),
        "hevc_alpha_urn": (a_obu, repl(a_props, b"auxC", auxc(
            b"urn:mpeg:hevc:2015:auxid:1\0")), auxl, True),
        "no_auxc": (a_obu, drop(a_props, b"auxC"), auxl, True),
        "auxc_version_1": (a_obu, repl(a_props, b"auxC", auxc(alpha_urn, 1)),
                           auxl, False),
        "auxc_unterminated": (a_obu, repl(a_props, b"auxC", auxc(
            alpha_urn[:-1])), auxl, False),
        "unknown_essential": (a_obu, a_props + [(oracle.box(b"zzzz", b""),
                                                 True)], auxl, True),
        "no_av1c": (a_obu, drop(a_props, b"av1C"), auxl, False),
        "pixi_10": (a_obu, repl(a_props, b"pixi", oracle.full_box(
            b"pixi", 0, 0, bytes([1, 10]))), auxl, False),
        "av1c_10_pixi_10_frame_8": (a_obu, pixi10, auxl, True),
        "frame_10": (deep, a_props, auxl, False),
        "frame_smaller": (small, a_props, auxl, True),
        "frame_smaller_own_ispe": (small, repl(a_props, b"ispe",
                                               ispe(48, 32)), auxl, False),
        "colour_stream": (oracle.item_parts(oracle.cv2_avif(img))[0],
                          a_props, auxl, True),
        "irot": (a_obu, a_props + [(oracle.box(b"irot", b"\x01"), True)],
                 auxl, False),
        "cut_stream": (a_obu[:-20], a_props, auxl, False),
        "no_auxl": (a_obu, a_props, [], True),
        "auxl_last_target": (a_obu, a_props, [(b"auxl", 2, [3, 1])], True),
        "thumbnail": (a_obu, a_props, auxl + [(b"thmb", 2, [1])], True),
    }
    out = {}
    for name, (aobu, aprops, refs, reads) in cases.items():
        out[name] = (oracle.build_items([(1, b"av01", c_obu, c_props),
                                         (2, b"av01", aobu, aprops)], refs),
                     reads)
    out["type_xxxx"] = (oracle.build_items(
        [(1, b"av01", c_obu, c_props), (2, b"xxxx", a_obu, a_props)], auxl),
        True)
    out["first_alpha_cut"] = (oracle.build_items(
        [(1, b"av01", c_obu, c_props), (2, b"av01", a_obu[:-20], a_props),
         (3, b"av01", a_obu, a_props)], auxl + [(b"auxl", 3, [1])]), False)
    gray = oracle.pillow_avif(np.dstack([img, img[..., :1]]),
                              subsampling="4:0:0")
    out["gray_with_alpha"] = (gray, False)
    return out


_ALPHA_CASES = [
    "pillow", "no_alpha_ispe", "alpha_ispe_other", "alpha_ispe_cut",
    "depth_urn", "hevc_alpha_urn", "no_auxc", "auxc_version_1",
    "auxc_unterminated", "unknown_essential", "no_av1c", "pixi_10",
    "av1c_10_pixi_10_frame_8", "frame_10", "frame_smaller",
    "frame_smaller_own_ispe", "colour_stream", "irot", "cut_stream",
    "no_auxl", "auxl_last_target", "thumbnail", "type_xxxx",
    "first_alpha_cut", "gray_with_alpha"]


@pytest.mark.parametrize("case", _ALPHA_CASES)
def test_alpha_item_edits_match_cv2(cv2, pil, tmp_path, case):
    # libavif's rules for the alpha item, held through cv2 on files of two
    # or three items written here: its ispe against the colour's (taken
    # from the colour without one), auxC's version and URN (other
    # auxiliary types are not read), av1C and pixi, the decoded depth, a
    # stream that does not decode; OpenCV fails on gray with alpha
    data, reads = _alpha_cases(np.random.default_rng(21))[case]
    assert _same_as_cv2(cv2, tmp_path / f"{case}.avif", data) == reads


def test_premultiplied_alpha_raises_naming_the_kind(cv2, pil, tmp_path):
    # a prem reference makes libavif unpremultiply the colour: cv2 reads
    # it; the port names the kind
    img = oracle.avif_image("photo", 40, 56, np.random.default_rng(22))
    c_obu, c_props, a_obu, a_props = oracle.alpha_parts(
        oracle.pillow_avif(np.dstack([img, img[..., :1]])))
    path = tmp_path / "prem.avif"
    path.write_bytes(oracle.build_items(
        [(1, b"av01", c_obu, c_props), (2, b"av01", a_obu, a_props)],
        [(b"auxl", 2, [1]), (b"prem", 1, [2])]))
    assert cv2.imread(str(path)) is not None
    with pytest.raises(RuntimeError, match="prem.avif: .*premultiplied.*not "
                                           "read yet"):
        read_avif(str(path))


@pytest.mark.parametrize("group", range(2))
def test_alpha_flips_end_as_cv2_ends(cv2, pil, tmp_path, group):
    # one flipped bit inside the alpha item's OBUs: where the alpha does
    # not decode cv2 returns None and the port raises; else both read the
    # colour image
    rng = np.random.default_rng(30 + group)
    counts = {"same": 0, "both refuse": 0}
    for trial in range(40):
        size = (int(rng.integers(8, 80)), int(rng.integers(8, 80)))
        img = oracle.avif_image("photo", *size, rng)
        alpha = oracle.avif_image(oracle.KINDS[trial % 4], *size, rng)
        data = oracle.pillow_avif(np.dstack([img, alpha[..., :1]]),
                                  quality=int(rng.integers(20, 100)))
        c_obu, c_props, a_obu, a_props = oracle.alpha_parts(data)
        flip = bytearray(a_obu)
        flip[int(rng.integers(0, len(flip)))] ^= 1 << int(rng.integers(0, 8))
        path = tmp_path / f"aflip{trial}.avif"
        path.write_bytes(oracle.build_items(
            [(1, b"av01", c_obu, c_props), (2, b"av01", bytes(flip),
                                            a_props)], [(b"auxl", 2, [1])]))
        counts["same" if _same_as_cv2(cv2, path) else "both refuse"] += 1
    assert counts["same"] and counts["both refuse"], counts


# ------------------------------------------------------- stage oracles


def _lib():
    lib = image_io._load_avif_codec()
    vp = ctypes.c_void_p
    lib.av1_palette_cache.argtypes = [ctypes.c_int] + [vp] * 4 + \
        [ctypes.c_int, vp]
    lib.av1_palette_color_context.argtypes = [vp] + [ctypes.c_int] * 4 + [vp]
    lib.av1_intrabc_convolve.argtypes = [vp, ctypes.c_int, vp] + \
        [ctypes.c_int] * 5
    return lib


def test_palette_cache_matches_libaom(cv2):
    # av1_get_palette_cache on a MACROBLOCKD of libaom 3.14.1's layout (its
    # mb_to_top_edge, above and left MB_MODE_INFO pointers, and each
    # MB_MODE_INFO's palette colours and sizes, read off the function's
    # machine code): the merged, sorted, distinct colours, none from above
    # on a 64-row boundary
    lib = _lib()
    theirs = oracle.libaom_function("av1_get_palette_cache", ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p)
    rng = np.random.default_rng(40)
    for trial in range(400):
        xd = (ctypes.c_uint8 * 0x2000)()
        mbmi = [(ctypes.c_uint8 * 0x100)() for _ in range(2)]
        sizes = np.zeros((2, 2), np.uint8)
        colors = np.zeros((2, 24), np.uint16)
        present = [rng.random() < 0.8, rng.random() < 0.8]
        for k in range(2):
            top = int(rng.choice([4, 64, 1024, 4096]))
            for uv in range(2):
                n = int(rng.choice([0, 2, 3, 5, 8]))
                sizes[k, uv] = n
                for p in range(1 + uv):
                    c = np.sort(rng.integers(0, top, n))
                    colors[k, 8 * (uv + p):8 * (uv + p) + n] = c
            ctypes.memmove(ctypes.addressof(mbmi[k]) + 0x5E,
                           colors[k].tobytes(), 48)
            ctypes.memmove(ctypes.addressof(mbmi[k]) + 0x8E,
                           sizes[k].tobytes(), 2)
        mi_row = int(rng.integers(0, 64))
        struct.pack_into("<i", xd, 0x1EFC, -mi_row * 32)
        for k, off in ((0, 0x1ED0), (1, 0x1EC8)):      # above, left
            struct.pack_into("<Q", xd, off, ctypes.addressof(mbmi[k])
                             if present[k] else 0)
        for uv in range(2):
            want = (ctypes.c_uint16 * 16)()
            n = theirs(ctypes.addressof(xd), uv, ctypes.addressof(want))
            got = np.zeros(16, np.uint16)
            args = []
            for k in range(2):
                args += [sizes[k].ctypes.data if present[k] else None,
                         colors[k].ctypes.data if present[k] else None]
            m = lib.av1_palette_cache(mi_row, *args, uv, got.ctypes.data)
            assert m == n and list(got[:m]) == list(want[:n]), trial


def test_palette_color_context_matches_libaom(cv2):
    # av1_get_palette_color_index_context: the context and the colour
    # order of every position of random maps of 2 to 8 colours
    lib = _lib()
    u8p = ctypes.POINTER(ctypes.c_uint8)
    theirs = oracle.libaom_function(
        "av1_get_palette_color_index_context", ctypes.c_int, u8p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
        ctypes.POINTER(ctypes.c_int))
    rng = np.random.default_rng(41)
    for n in range(2, 9):
        for _ in range(6):
            h, w = (int(x) for x in rng.integers(2, 12, 2))
            cmap = rng.integers(0, n, (h, w)).astype(np.uint8)
            if rng.random() < 0.5:                 # runs of one colour
                cmap[:, : w // 2] = cmap[0, 0]
            for r in range(h):
                for c in range(w):
                    if r == 0 and c == 0:
                        continue
                    want_order = (ctypes.c_uint8 * 8)()
                    want = theirs(cmap.ctypes.data_as(u8p), w, r, c, n,
                                  want_order, None)
                    order = np.zeros(8, np.uint8)
                    got = lib.av1_palette_color_context(
                        cmap.ctypes.data, w, r, c, n, order.ctypes.data)
                    assert got == want
                    assert list(order[:n]) == list(want_order[:n])


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_intrabc_convolution_matches_libaom(cv2, depth):
    # the bilinear half-pel prediction of subsampled chroma against
    # libaom's av1_convolve_{x,y,2d}_sr_intrabc_c (their highbd forms past
    # 8 bits), at every block size the chroma of a block takes
    lib = _lib()
    vp, i = ctypes.c_void_p, ctypes.c_int
    hb = "" if depth == 8 else "highbd_"
    tail = [] if depth == 8 else [i]
    fns = {
        (8, 0): oracle.libaom_function(f"av1_{hb}convolve_x_sr_intrabc_c",
                                       None, vp, i, vp, i, i, i, vp, i, vp,
                                       *tail),
        # the highbd y form takes no ConvolveParams
        (0, 8): oracle.libaom_function(f"av1_{hb}convolve_y_sr_intrabc_c",
                                       None, vp, i, vp, i, i, i, vp, i,
                                       *([vp] if depth == 8 else tail)),
        (8, 8): oracle.libaom_function(f"av1_{hb}convolve_2d_sr_intrabc_c",
                                       None, vp, i, vp, i, i, i, vp, vp, i,
                                       i, vp, *tail)}
    # ConvolveParams: round_0 at byte 20 and round_1 at 24 (libaom's
    # get_conv_params_no_round for one reference; 12 bits round more early)
    conv = (ctypes.c_int32 * 12)()
    conv[5], conv[6] = (5, 9) if depth == 12 else (3, 11)
    rng = np.random.default_rng(42 + depth)
    stride = 80
    for w in (2, 4, 8, 16, 32, 64):
        for h in (2, 4, 8, 16, 32, 64):
            src = rng.integers(0, 1 << depth, (h + 2, stride))
            src16 = src.astype(np.uint16)
            ref = src.astype(np.uint8 if depth == 8 else np.uint16)
            for (fx, fy), fn in fns.items():
                want = np.zeros((h, w), ref.dtype)
                args = [ref.ctypes.data, stride, want.ctypes.data, w, w, h]
                if (fx, fy) == (8, 8):
                    args += [None, None, 8, 8, ctypes.addressof(conv)]
                elif fx or depth == 8:
                    args += [None, 8, ctypes.addressof(conv)]
                else:
                    args += [None, 8]
                fn(*(args + ([] if depth == 8 else [depth])))
                got = np.zeros((h, w), np.uint16)
                lib.av1_intrabc_convolve(src16.ctypes.data, stride,
                                         got.ctypes.data, w, w, h, fx, fy)
                np.testing.assert_array_equal(got, want)


def test_planes_match_libavif(cv2, pil):
    # the decoder alone on the new kinds: every plane against libavif's
    # (with its libaom) before any colour conversion
    rng = np.random.default_rng(43)
    files = {}
    for sub in ("4:2:0", "4:4:4", "4:2:2", "4:0:0"):
        img = oracle.screen_image("text", 200, 300, rng)
        files[f"screen_{sub}"] = oracle.pillow_avif(img, subsampling=sub,
                                                    advanced=SCREEN)
        photo = oracle.avif_image("photo", 130, 203, rng)
        files[f"photo_{sub}"] = oracle.pillow_avif(
            photo, subsampling=sub, advanced={"enable-cdef": "1"})
    for name, data in files.items():
        want, depth, _ = oracle.libavif_planes(data)
        got, info = _info_planes(data)
        assert info[2] == depth, name
        for p in range(len(got)):
            np.testing.assert_array_equal(got[p], want[p], err_msg=name)
        assert len(got) == (1 if name.endswith("4:0:0") else 3)


def _info_planes(data):
    heif = image_io._Heif(data, "file")
    heif.parse()
    return image_io.decode_av1(heif.primary_item()[0])
