"""The port's JPEG 2000 reader on HT code-blocks (ITU-T T.814 / ISO/IEC
15444-15: ``csrc/jpeg2000_codec.cpp``'s ``ht_decode_cblk`` and its tier-2
numbering), the CAP and CPF markers and JPH files, against cv2 5.0.0
(OpenJPEG 2.5.3): every file decodes to ``cv2.imread(path)[..., ::-1]`` bit
for bit, or both refuse and the port's message names the file.  The files
are ``tests/torch_j2k_ht.py``'s (an encoder of its own): the cleanup
pass alone and with its SigProp and MagRef passes, code-blocks from 4x4 to
64x64 and 1024x4, the 5/3 (lossless: the decode is also the source) and
the 9/7 with expounded and derived step sizes, ROI, layers, tiles,
precincts, 1, 3 and 4 components of 8 to 16 bits, HT in one COC only, the
other style bits beside HT, cut and corrupted segments, passes past the
first HT set, CAP and CPF variants and JPH boxes.
"""

import os
import struct

import numpy as np
import pytest
import torch

from gsplat_tpu_torch.utils.image_io import read_image

import torch_j2k_ht as ht
import torch_make_image_fixtures as fx

H, W = 37, 58


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cv2():
    return pytest.importorskip("cv2")


def same_as_cv2(cv2, path, data, source=None) -> bool:
    """Equal to cv2's decode (and to ``source`` where given), or both
    refuse → whether cv2 read it."""
    path.write_bytes(data)
    try:
        want = cv2.imread(str(path))
    except cv2.error:
        want = None
    if want is None:
        with pytest.raises(RuntimeError, match=os.path.basename(str(path))):
            read_image(str(path))
        return False
    got = read_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want[..., ::-1])
    if source is not None:
        np.testing.assert_array_equal(got, source)
    return True


def _img(h=H, w=W, seed=0):
    return fx.fixture_image(h, w, seed=seed)


def _planes(img):
    return [img[..., k] for k in range(img.shape[2])]


def _coeffs(h, w, seed, amp=400, density=0.6):
    """Random 9/7 quantisation indices for three components."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(-amp, amp + 1, (h, w))
             * (rng.random((h, w)) < density)) for _ in range(3)]


# ---------------------------------------------- passes, planes, sizes


@pytest.mark.parametrize("passes,plane", [(1, 0), (1, 2), (2, 1), (2, 3),
                                          (3, 1), (3, 2), (3, 4)])
@pytest.mark.parametrize("wavelet", ["53", "97"])
def test_cleanup_sigprop_magref_match_cv2(cv2, tmp_path, wavelet, passes,
                                          plane):
    if wavelet == "53":
        img = _img(seed=passes * 7 + plane)
        data = ht.ht_codestream(_planes(img), numres=3, mct=1, passes=passes,
                                plane=plane, fallback=False)
        lossless = plane == 0
        assert same_as_cv2(cv2, tmp_path / "v.j2c", data,
                           img if lossless else None)
    else:
        data = ht.ht_codestream(coeffs=[_coeffs(H, W, plane)], size=(H, W),
                                numres=3, reversible=False, expn=11,
                                mant=700, passes=passes, plane=plane)
        assert same_as_cv2(cv2, tmp_path / "v.j2c", data)


def test_refined_lossless_blocks_read_back(cv2, tmp_path):
    # a cleanup at plane 1 finished by SigProp and MagRef, where they reach
    # every bit (else the block's cleanup drops to plane 0): the source
    img = _img(64, 96, seed=3)
    st = {}
    data = ht.ht_codestream(_planes(img), numres=2, passes=3, plane=1,
                            stats=st)
    assert st["passes"][3] > 0
    assert same_as_cv2(cv2, tmp_path / "v.j2c", data, img)


@pytest.mark.parametrize("cblk", [(2, 2), (2, 6), (6, 2), (3, 5), (4, 4),
                                  (6, 6), (10, 2), (2, 10)],
                         ids=lambda c: f"{1 << c[0]}x{1 << c[1]}")
def test_code_block_sizes_match_cv2(cv2, tmp_path, cblk):
    # partial blocks at the right and bottom edges; 1024x4 and 4x1024 on
    # images wider or taller than 1024
    h, w = ((9, 1100) if cblk == (10, 2) else (1100, 9) if cblk == (2, 10)
            else (45, 71))
    img = _img(h, w, seed=sum(cblk))
    for passes, plane in ((1, 0), (3, 1)):
        data = ht.ht_codestream(_planes(img), numres=2, cblk=cblk,
                                passes=passes, plane=plane, fallback=False)
        assert same_as_cv2(cv2, tmp_path / f"v{passes}.j2c", data,
                           img if plane == 0 else None)


@pytest.mark.parametrize("qstyle", [1, 2], ids=["derived", "expounded"])
@pytest.mark.parametrize("numres", [1, 4])
def test_97_step_sizes_match_cv2(cv2, tmp_path, qstyle, numres):
    for k, (passes, plane) in enumerate(((1, 0), (3, 1), (2, 3))):
        data = ht.ht_codestream(coeffs=[_coeffs(H, W, 10 + k, amp=900)],
                                size=(H, W), numres=numres, reversible=False,
                                qstyle=qstyle, expn=12, mant=300 + 500 * k,
                                passes=passes, plane=plane)
        assert same_as_cv2(cv2, tmp_path / f"v{k}.j2c", data)


def test_sparse_and_large_coefficients(cv2, tmp_path):
    # near-empty blocks (long MEL runs) and exponents up to 20 bits
    rng = np.random.default_rng(4)
    sparse = [(rng.random((H, W)) < 0.02) * rng.integers(-3, 4, (H, W))
              for _ in range(3)]
    big = [rng.integers(-(1 << 20), 1 << 20, (H, W)) for _ in range(3)]
    for name, co, expn in (("sparse", sparse, 8), ("big", big, 21)):
        for passes, plane in ((1, 0), (3, 1)):
            data = ht.ht_codestream(coeffs=[co], size=(H, W), numres=2,
                                    reversible=False, expn=expn,
                                    passes=passes, plane=plane)
            assert same_as_cv2(cv2, tmp_path / f"{name}{passes}.j2c", data)


# --------------------------------------------- tier 2, tiles, components


def _layer(*key):
    return sum(key) % 3


_T2 = {
    "layers": dict(layers=3, layer_of=_layer),
    "layers_rlcp": dict(layers=3, layer_of=_layer, prog="RLCP"),
    "tiles": dict(tiles=(16, 24)),
    "tiles_odd_layers": dict(tiles=(13, 21), layers=2, layer_of=_layer),
    "precincts": dict(precincts=[(3, 3), (4, 4), (4, 4)], cblk=(2, 3)),
    "precincts_layers": dict(precincts=[(4, 4), (3, 3), (5, 5)],
                             layers=2, layer_of=_layer, prog="RLCP"),
    "sop_eph": dict(sop=True, eph=True, layers=2, layer_of=_layer),
    "one_resolution": dict(numres=1),
    "six_resolutions": dict(numres=6, cblk=(2, 2)),
}


@pytest.mark.parametrize("kind", list(_T2))
def test_layers_tiles_precincts_match_cv2(cv2, tmp_path, kind):
    img = _img(seed=len(kind))
    kw = dict(numres=3, passes=3, plane=1)
    kw.update(_T2[kind])
    data = ht.ht_codestream(_planes(img), **kw)
    assert same_as_cv2(cv2, tmp_path / "v.j2c", data, img)


def test_passes_in_a_later_layer(cv2, tmp_path):
    # SigProp and MagRef in the next layer, one length for both (T.814):
    # OpenJPEG numbers them as a second cleanup length and a refinement
    # segment, and refuses or misreads the block; the port does the same
    img = _img(seed=9)
    for numres in (1, 2, 3):
        data = ht.ht_codestream(_planes(img), numres=numres, layers=2,
                                split=1, passes=3, plane=1, fallback=False)
        same_as_cv2(cv2, tmp_path / f"v{numres}.j2c", data)


@pytest.mark.parametrize("extra", [1, 2, 3, 5])
def test_passes_past_the_first_ht_set(cv2, tmp_path, extra):
    # placeholder passes, or a second HT set: more than 3 passes in the
    # first two segments, which OpenJPEG does not decode
    img = _img(seed=extra)
    for passes in (1, 3):
        data = ht.ht_codestream(_planes(img), numres=2, passes=passes,
                                plane=passes > 1, extra_passes=extra)
        same_as_cv2(cv2, tmp_path / f"v{passes}.j2c", data)


@pytest.mark.parametrize("ncomp", [1, 3, 4])
@pytest.mark.parametrize("prec", [8, 12, 16])
def test_components_and_precisions_match_cv2(cv2, tmp_path, ncomp, prec):
    rng = np.random.default_rng(ncomp * prec)
    img = _img(seed=prec)
    planes = [(p.astype(np.int64) << (prec - 8))
              + rng.integers(0, 1 << (prec - 8), p.shape) for p in
              _planes(img)]
    planes = (planes + planes[:1])[:ncomp]
    data = ht.ht_codestream(planes, prec=prec, numres=3, passes=3, plane=1)
    # a raw gray codestream cv2 refuses; in a JPH file it reads
    same_as_cv2(cv2, tmp_path / "v.j2c", data)
    jph = ht.jph_file(data, ncomp, H, W, colr=17 if ncomp == 1 else 16,
                      bpc=prec - 1)
    assert same_as_cv2(cv2, tmp_path / "v.jph", jph)


@pytest.mark.parametrize("styles", ["coc_ht", "coc_part1", "coc_vsc",
                                    "coc_part1_styles"])
def test_ht_in_one_component_only(cv2, tmp_path, styles):
    # the Part 1 components' packets are libopenjp2's own
    img = _img(seed=4)
    kw, mode = {
        "coc_ht": (dict(style=0, coc_styles={1: 0x40}), 0),
        "coc_part1": (dict(style=0x40, coc_styles={2: 0}), 0),
        "coc_vsc": (dict(style=0x40, coc_styles={0: 0x48, 2: 0}), 0),
        "coc_part1_styles": (dict(style=0x40, coc_styles={0: 0x09}), 9),
    }[styles]
    styles_of = [kw.get("coc_styles", {}).get(c, kw["style"])
                 for c in range(3)]
    theirs = ht.part1_packets(_planes(img), 3, mode)
    data = ht.ht_codestream(
        _planes(img), numres=3, passes=3, plane=1, **kw,
        packets_of=lambda t, l, r, c, p: None if styles_of[c] & 0x40
        else theirs[(r, c)])
    assert same_as_cv2(cv2, tmp_path / "v.j2c", data, img)


@pytest.mark.parametrize("style", [0x41, 0x42, 0x44, 0x48, 0x50, 0x60,
                                   0x7F, 0xC0, 0x80],
                         ids=lambda s: f"0x{s:02x}")
def test_style_bits_beside_ht(cv2, tmp_path, style):
    # OpenJPEG's HT decoder reads VSC (stripe-causal SigProp) and ignores
    # the others; the mixed style (0x80) is refused in COD
    img = _img(seed=style)
    for layers in (1, 2):
        data = ht.ht_codestream(_planes(img), numres=2, passes=3, plane=1,
                                style=style, layers=layers, layer_of=_layer)
        same_as_cv2(cv2, tmp_path / f"v{layers}.j2c", data)


def test_roi_is_refused_as_openjpeg_refuses_it(cv2, tmp_path):
    # "We do not support ROI in decoding HT codeblocks": an RGN on an HT
    # component fails the tile; on a Part 1 component beside HT ones it
    # is applied there
    img = _img(seed=5)
    data = ht.ht_codestream(_planes(img), numres=2, rgn=(0, 3))
    assert not same_as_cv2(cv2, tmp_path / "roi.j2c", data)
    data = ht.ht_codestream(_planes(img), numres=2, rgn=(2, 0))
    assert same_as_cv2(cv2, tmp_path / "roi0.j2c", data, img)
    data = ht.ht_codestream(_planes(img), numres=2, rgn=(2, 4), style=0x40,
                            coc_styles={2: 0})
    assert same_as_cv2(cv2, tmp_path / "roi_part1.j2c", data)


# ------------------------------------------------- refusals and cuts


def _refusals():
    img = _img(seed=6)
    p = _planes(img)
    out = {
        # more zero bit-planes than the band has, or an exponent bound
        # past them
        "zero_planes_past_mb": ht.ht_codestream(p, numres=2, zbp_offset=1),
        "exponent_past_planes": ht.ht_codestream(p, numres=2,
                                                 zbp_offset=-2),
        # a band of 31 bit-planes (guard bits 7)
        "mb_31": ht.ht_codestream(coeffs=[_coeffs(H, W, 1, amp=9)],
                                  size=(H, W), numres=1, reversible=False,
                                  expn=25, guard=7),
        "mb_30": ht.ht_codestream(coeffs=[_coeffs(H, W, 1, amp=9)],
                                  size=(H, W), numres=1, reversible=False,
                                  expn=24, guard=7),
        # a cleanup of zero passes' worth: the plane below the last
        "refine_at_plane_0": ht.ht_codestream(p, numres=2, passes=3,
                                              plane=1, zbp_offset=1),
    }
    base = ht.ht_codestream(p, numres=3, passes=3, plane=1, fallback=False)
    for pct in (20, 50, 80, 97):
        out[f"cut_{pct}"] = base[:len(base) * pct // 100]
    out["no_eoc"] = base[:-2]
    # the last two bytes of the first code-block's cleanup (Scup)
    sod = base.find(b"\xff\x93") + 2
    for name, scup in (("scup_0", 0), ("scup_1", 1), ("scup_max", 0xFFF)):
        data = bytearray(base)
        head = _first_cleanup(base, sod)
        data[head - 2] = (data[head - 2] & 0xF0) | (scup & 0xF)
        data[head - 1] = scup >> 4
        out[name] = bytes(data)
    return out


def _first_cleanup(data, sod):
    """Where the first non-empty packet's first cleanup segment ends: the
    packet header is read here with the writer's own layout (one block)."""
    # the first packet of a 3-resolution file is the LL band's one block:
    # its header read bit by bit (OpenJPEG's stuffing)
    bits = []
    i = sod
    prev = 0
    while len(bits) < 400:
        b = data[i]
        n = 7 if prev == 0xFF else 8
        bits += [(b >> k) & 1 for k in range(n - 1, -1, -1)]
        prev = b
        i += 1
    pos = 1                                  # present
    pos += 1                                 # inclusion (one leaf: '1')
    while bits[pos] == 0:                    # zero bit-planes: 0s then 1
        pos += 1
    pos += 1
    npass = 1
    if bits[pos]:                            # number of passes
        pos += 1
        if bits[pos]:
            pos += 1
            npass = 3 + (bits[pos] << 1 | bits[pos + 1])
            pos += 2
        else:
            npass = 2
            pos += 1
    else:
        pos += 1
    lblock = 3
    while bits[pos]:
        lblock += 1
        pos += 1
    pos += 1
    length = 0
    for _ in range(lblock):
        length = length << 1 | bits[pos]
        pos += 1
    if npass > 1:                            # the refinement segment's
        pos += lblock + (npass - 1).bit_length() - 1
    # header bytes: up to the byte boundary (a 0xFF ends with one more)
    nbits, i, prev = 0, sod, 0
    while nbits < pos:
        nbits += 7 if prev == 0xFF else 8
        prev = data[i]
        i += 1
    if prev == 0xFF:
        i += 1
    return i + length


_REFUSALS = ["zero_planes_past_mb", "exponent_past_planes", "mb_31", "mb_30",
             "refine_at_plane_0", "cut_20", "cut_50", "cut_80", "cut_97",
             "no_eoc", "scup_0", "scup_1", "scup_max"]


@pytest.fixture(scope="module")
def refusals():
    return _refusals()


def test_the_refusal_list_is_whole(refusals):
    assert sorted(refusals) == sorted(_REFUSALS)


@pytest.mark.parametrize("name", _REFUSALS)
def test_malformed_blocks_match_cv2(cv2, tmp_path, refusals, name):
    same_as_cv2(cv2, tmp_path / f"{name}.j2c", refusals[name])


@pytest.mark.parametrize("seed", range(3))
def test_corrupted_segments_match_cv2(cv2, tmp_path, seed):
    # 60 flips of one to three bytes in the code-block data a seed
    img = _img(seed=seed)
    base = ht.ht_codestream(_planes(img), numres=2, cblk=(4, 4), passes=3,
                            plane=1, fallback=False, layers=2,
                            layer_of=_layer)
    sod = base.find(b"\xff\x93") + 2
    rng = np.random.default_rng(seed)
    for i in range(60):
        data = bytearray(base)
        for _ in range(int(rng.integers(1, 4))):
            data[int(rng.integers(sod, len(data) - 2))] = int(
                rng.integers(256))
        same_as_cv2(cv2, tmp_path / f"f{i}.j2c", bytes(data))


# ------------------------------------------------------- CAP and CPF


def _tile_header(cs: bytes, marker: bytes) -> bytes:
    """The marker put in the first tile-part header (Psot grown)."""
    at = cs.find(b"\xff\x90")
    psot = struct.unpack(">I", cs[at + 6:at + 10])[0] + len(marker)
    return cs[:at + 6] + struct.pack(">I", psot) + cs[at + 10:at + 12] + \
        marker + cs[at + 12:]


def _caps():
    img = _img(seed=7)
    p = _planes(img)
    seg = ht._marker
    out = {
        "no_cap": dict(cap=b""),
        "cap_empty": dict(cap=seg(0xFF50, b"")),
        "cap_odd": dict(cap=seg(0xFF50, b"\x00\x02\x00\x00\x05")),
        "cap_ccap_magb": dict(cap=ht.cap_marker(b"\x00\x1f")),
        "cap_part2_bit": dict(cap=ht.cap_marker(pcap=1 << 30 | 1 << 14,
                                                ccap=b"\0\0\0\0")),
        "cap_twice": dict(cap=ht.cap_marker() + ht.cap_marker()),
        "cap_long": dict(cap=seg(0xFF50, bytes(range(200)))),
        "cpf": dict(cpf=ht.cpf_marker()),
        "cpf_empty": dict(cpf=seg(0xFF59, b"")),
        "cpf_words": dict(cpf=ht.cpf_marker((0x4000, 0x1234, 0xFFFF))),
        "rsiz_part1": dict(rsiz=0),
        "cap_after_qcd": dict(cap=b"", extra_main=ht.cap_marker()),
    }
    files = {k: ht.ht_codestream(p, numres=2, passes=3, plane=1, **kw)
             for k, kw in out.items()}
    base = ht.ht_codestream(p, numres=2, passes=3, plane=1)
    files["cap_in_tile_header"] = _tile_header(base, ht.cap_marker())
    files["cpf_in_tile_header"] = _tile_header(base, ht.cpf_marker())
    siz_end = 4 + struct.unpack(">H", base[4:6])[0]
    files["cap_before_siz"] = base[:2] + ht.cap_marker() + base[2:]
    files["cap_short_length"] = base[:siz_end] + b"\xff\x50\x00\x01" + \
        base[siz_end:]
    files["part1_with_cap"] = fx.openjpeg_encode(p[:3], numres=2)
    files["part1_with_cap"] = files["part1_with_cap"][:siz_end] + \
        ht.cap_marker() + ht.cpf_marker() + files["part1_with_cap"][siz_end:]
    return files, img


_CAPS = ["no_cap", "cap_empty", "cap_odd", "cap_ccap_magb", "cap_part2_bit",
         "cap_twice", "cap_long", "cpf", "cpf_empty", "cpf_words",
         "rsiz_part1", "cap_after_qcd", "cap_in_tile_header",
         "cpf_in_tile_header", "cap_before_siz", "cap_short_length",
         "part1_with_cap"]


@pytest.fixture(scope="module")
def caps():
    return _caps()


def test_the_cap_list_is_whole(caps):
    assert sorted(caps[0]) == sorted(_CAPS)


@pytest.mark.parametrize("name", _CAPS)
def test_cap_and_cpf_match_cv2(cv2, tmp_path, caps, name):
    # OpenJPEG skips CAP and CPF in the main header (its readers are
    # empty); elsewhere the marker's place is an error
    files, img = caps
    read = same_as_cv2(cv2, tmp_path / f"{name}.j2c", files[name])
    if read and name != "part1_with_cap":
        np.testing.assert_array_equal(read_image(
            str(tmp_path / f"{name}.j2c")), img)


# --------------------------------------------------------- JPH files


@pytest.mark.parametrize("compat", [b"jph ", b"jp2 jph ", b"", b"jpx "])
def test_jph_files_match_cv2(cv2, tmp_path, compat):
    img = _img(seed=8)
    cs = ht.ht_codestream(_planes(img), numres=3, passes=3, plane=1)
    data = ht.jph_file(cs, 3, H, W, compat=compat)
    assert data[20:24] == b"jph "
    assert same_as_cv2(cv2, tmp_path / "v.jph", data, img)


@pytest.mark.parametrize("name", ["v.jph", "v.j2c", "v.jp2", "v.png"])
def test_read_image_goes_by_signature_for_ht_files(cv2, tmp_path, name):
    # a JPH file or a raw codestream under any name
    img = _img(seed=11)
    cs = ht.ht_codestream(_planes(img), numres=2)
    for data in (cs, ht.jph_file(cs, 3, H, W)):
        (tmp_path / name).write_bytes(data)
        np.testing.assert_array_equal(read_image(str(tmp_path / name)), img)


def test_many_blocks_on_threads(cv2, tmp_path):
    # enough code-blocks for the decoder's threads; 5 levels, RCT
    img = _img(200, 260, seed=12)
    for k in (0, 1):
        data = ht.j2k_mid_file(img, k)
        assert same_as_cv2(cv2, tmp_path / f"v.{'jph' if k else 'j2c'}",
                           data, img)


def test_allocation_limits_name_the_file(tmp_path):
    # a 20000x20000 image of 4x4 code-blocks in one precinct: past the
    # decoder's allocation guard, refused before any sample is held (no
    # cv2: it would allocate gigabytes)
    side = 20000
    siz = struct.pack(">HIIIIIIIIH", 0, side, side, 0, 0, side, side, 0, 0,
                      3) + bytes([7, 1, 1]) * 3
    cs = b"\xff\x4f" + ht._marker(0xFF51, siz) + ht._marker(
        0xFF52, bytes([0, 0, 0, 1, 0, 0, 0, 0, 0x40, 1])) + ht._marker(
        0xFF5C, bytes([0x40, 8 << 3])) + ht._marker(
        0xFF90, struct.pack(">HIBB", 0, 15, 0, 1)) + b"\xff\x93\x00\xff\xd9"
    path = tmp_path / "big.j2c"
    path.write_bytes(cs)
    with pytest.raises(RuntimeError, match="big.j2c: .* more than 2\\^24 "
                                           "code-blocks, past what the port"):
        read_image(str(path))
