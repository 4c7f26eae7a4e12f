"""Oracles and writers for the AVIF tests (``tests/test_torch_avif.py``) and
sweep (``tests/torch_avif_sweep.py``), all from the opencv-python wheel's
bundled libraries through ctypes:

* ``libavif_planes(data)``: the Y, U and V planes libavif 1.4.2 (with its
  libaom 3.14.1) decodes, before any colour conversion, the stage oracle
  of the port's AV1 decoder;
* ``libaom_function(name, restype, *argtypes)``: one of libaom's own
  functions, found by its ELF symbol (the library keeps its symbol table)
  even where it is not exported: the 1D inverse transforms
  (``av1_idct16``, ``av1_iadst8``, ...);
* ``avif_image(kind, h, w, rng)``: the test contents (a crop of the
  committed 1297x840 view, noise, a flat colour, smooth ramps), and
  ``screen_image``: text-like glyphs, flat blocks and a ramp, which libaom
  codes with its screen content tools (palette, intra block copy);
* ``cv2_avif`` and ``pillow_avif``: files written by cv2 (its qualities and
  depths) and by Pillow (libaom's own options through ``advanced=``);
* ``alpha_parts``, ``item_props`` and ``build_items``: a Pillow RGBA
  file's colour and alpha items taken apart, and files of several items
  written back with hand-edited properties and references;
* ``libaom_film_grain``: libaom's own ``av1_add_film_grain`` by symbol on
  given planes (``aom_image_t`` and ``aom_film_grain_t`` laid out as
  libaom 3.14.1 lays them out), beside ``port_film_grain``, the codec's;
  ``grain_test_vectors`` (libaom's ``film_grain_test_vectors``),
  ``random_grain``, and ``with_grain``, an item's OBUs with its frame
  header's film grain fields rewritten (``grain_bits``);
* ``grid_avif``: grid images of tiles (``tile_item``, ``split_tiles``)
  that cv2's and Pillow's writers make, with a grid alpha;
* the colour stage's: ``libavif_encode`` (libavif's own encoder on given
  planes: 10- and 12-bit 4:2:2 and 4:4:4, 4:0:0 alpha frames, limited
  range), ``libavif_bgra`` (libavif's ``avifImageYUVToRGB`` as cv2 asks
  for it), ``libavif_symbol`` and ``libavif_table`` (libyuv's and
  libavif's functions and tables by ELF symbol), ``nclx``, ``with_colr``,
  ``alpha_file``, ``icc_profile`` and ``orientation_exif`` (hand-edited
  colr boxes, alpha items, ``prem``, Pillow's ICC and EXIF options).
"""

from __future__ import annotations

import ctypes
import functools
import glob
import io
import os
import struct

import numpy as np

from torch_make_av1_tables import Elf

HERE = os.path.dirname(os.path.abspath(__file__))
VIEW = os.path.join(HERE, "torch_images", "timing_arith_1297x840.jpg")
KINDS = ("photo", "noise", "flat", "smooth")


def _wheel_lib(pattern: str) -> str:
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    found = sorted(glob.glob(os.path.join(libs, pattern)))
    if not found:
        raise FileNotFoundError(f"no {pattern} under {libs}")
    return found[-1]


_AVIF = None


def _libavif():
    global _AVIF
    if _AVIF is None:
        lib = ctypes.CDLL(_wheel_lib("libavif-*.so*"))
        vp = ctypes.c_void_p
        lib.avifDecoderCreate.restype = vp
        lib.avifImageCreateEmpty.restype = vp
        lib.avifDecoderReadMemory.argtypes = [vp, vp, ctypes.c_char_p,
                                              ctypes.c_size_t]
        lib.avifDecoderDestroy.argtypes = [vp]
        lib.avifImageDestroy.argtypes = [vp]
        _AVIF = lib
    return _AVIF


def libavif_planes(data: bytes):
    """([Y, U, V] uint16 planes, depth, (subx, suby)) as libavif decodes the
    file's primary item; raises ValueError where libavif refuses it."""
    lib = _libavif()
    dec = lib.avifDecoderCreate()
    img = lib.avifImageCreateEmpty()
    try:
        res = lib.avifDecoderReadMemory(dec, img, data, len(data))
        if res != 0:
            raise ValueError(f"libavif refuses the file ({res})")
        # avifImage: width, height, depth, yuvFormat, yuvRange, chroma
        # sample position, yuvPlanes[3], yuvRowBytes[3]
        w, h, depth, fmt = struct.unpack("IIII", ctypes.string_at(img, 16))
        ptrs = struct.unpack("QQQ", ctypes.string_at(img + 24, 24))
        rows = struct.unpack("III", ctypes.string_at(img + 48, 12))
        sub = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: (1, 1)}[fmt]
        planes = []
        for p in range(3):
            sx, sy = sub if p else (0, 0)
            pw, ph = (w + sx) >> sx, (h + sy) >> sy
            nb = 2 if depth > 8 else 1
            raw = np.frombuffer(ctypes.string_at(ptrs[p], rows[p] * ph),
                                np.uint8).reshape(ph, rows[p])[:, :pw * nb]
            a = raw.copy().view("<u2") if nb == 2 else raw
            planes.append(a.astype(np.uint16))
        return planes, depth, sub
    finally:
        lib.avifImageDestroy(img)
        lib.avifDecoderDestroy(dec)


_AOM = None


def libaom_function(name: str, restype, *argtypes):
    """libaom's function ``name`` (a local symbol too) as a ctypes function."""
    global _AOM
    if _AOM is None:
        path = _wheel_lib("libaom-*.so*")
        elf = Elf(path)
        lib = ctypes.CDLL(path)
        syms = {}
        d = elf.data
        _, so, sz = elf.sections[".symtab"]
        _, sto, _ = elf.sections[".strtab"]
        for i in range(sz // 24):
            nm, info, _, _, val, _ = struct.unpack_from("<IBBHQQ", d,
                                                        so + 24 * i)
            if val and (info & 0xF) == 2:
                end = d.index(b"\0", sto + nm)
                syms[d[sto + nm:end].decode()] = val
        base = ctypes.cast(lib.aom_codec_version, ctypes.c_void_p).value - \
            syms["aom_codec_version"]
        _AOM = (lib, base, syms)
    lib, base, syms = _AOM
    return ctypes.CFUNCTYPE(restype, *argtypes)(base + syms[name])


_VIEW = None


def avif_image(kind: str, h: int, w: int, rng) -> np.ndarray:
    """(h, w, 3) uint8 BGR test content."""
    global _VIEW
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.broadcast_to(rng.integers(0, 256, 3, dtype=np.uint8),
                               (h, w, 3)).copy()
    if kind == "smooth":
        y, x = np.mgrid[:h, :w]
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         (x + y) * 127 // max(w + h - 2, 1)],
                        -1).astype(np.uint8)
    if _VIEW is None:
        import cv2
        _VIEW = cv2.imread(VIEW)
    y0 = int(rng.integers(0, _VIEW.shape[0] - h + 1))
    x0 = int(rng.integers(0, _VIEW.shape[1] - w + 1))
    return _VIEW[y0:y0 + h, x0:x0 + w].copy()


SCREEN_KINDS = ("text", "blocks", "ramp")


def screen_image(kind: str, h: int, w: int, rng) -> np.ndarray:
    """(h, w, 3) uint8 BGR content of the kinds that make libaom's encoder
    use its screen content tools: text-like rows of a few repeated glyphs
    (intra block copy and palette), 16x16 blocks of a few colours
    (palette), a smooth ramp (Pillow's default then turns the tools on for
    large images)."""
    if kind == "ramp":
        y, x = np.mgrid[:h, :w]
        return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                         np.full((h, w), 128)], -1).astype(np.uint8)
    ncol = int(rng.integers(2, 9))
    pal = rng.integers(0, 256, (ncol, 3), dtype=np.uint8)
    if kind == "blocks":
        idx = rng.integers(0, ncol, ((h + 15) // 16, (w + 15) // 16))
        return pal[np.kron(idx, np.ones((16, 16), int))[:h, :w]]
    img = np.empty((h, w, 3), np.uint8)
    img[:] = pal[0]
    glyphs = rng.integers(0, ncol, (8, 6, 5))
    for y in range(2, h - 7, 11):
        for x in range(2, w - 5, 7):
            img[y:y + 6, x:x + 5] = pal[glyphs[rng.integers(0, 8)]]
    return img


def cv2_avif(bgr: np.ndarray, quality=None, depth=None) -> bytes:
    """cv2's AVIF bytes of a BGR image (uint16 for depth 10 or 12)."""
    import cv2
    params = []
    if quality is not None:
        params += [cv2.IMWRITE_AVIF_QUALITY, quality]
    if depth is not None:
        params += [cv2.IMWRITE_AVIF_DEPTH, depth]
    ok, buf = cv2.imencode(".avif", bgr, params)
    assert ok
    return buf.tobytes()


def deepen(bgr: np.ndarray, rng) -> np.ndarray:
    """8-bit BGR → uint16 with random low bits (cv2's 10/12-bit input)."""
    return (bgr.astype(np.uint16) * 257 +
            rng.integers(0, 257, bgr.shape)).astype(np.uint16)


def pillow_avif(bgr: np.ndarray, **opts) -> bytes:
    """Pillow's AVIF bytes of a BGR (or BGRA) image with its save options
    (libaom's own through ``advanced={...}``)."""
    from PIL import Image
    img = bgr[..., [2, 1, 0, 3][:bgr.shape[2]]]
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(img)).save(buf, "AVIF", **opts)
    return buf.getvalue()


PILLOW_OPTIONS = {
    "444": dict(subsampling="4:4:4", quality=60),
    "tiles_2x1": dict(quality=50, advanced={"tile-columns": "1"}),
    "tiles_1x2": dict(quality=50, advanced={"tile-rows": "1"}),
    "tiles_4x2": dict(quality=50, advanced={"tile-columns": "2",
                                            "tile-rows": "1"}),
    "sb128": dict(quality=50, advanced={"sb-size": "128"}),
    "cdef": dict(quality=50, advanced={"enable-cdef": "1"}),
    "qm": dict(quality=50, advanced={"enable-qm": "1"}),
    "all": dict(quality=40, subsampling="4:4:4",
                advanced={"sb-size": "128", "enable-cdef": "1",
                          "enable-qm": "1", "tile-columns": "1",
                          "tile-rows": "1"}),
    "default": dict(),
}


# ---------------------------------------------------------- hand edits


def boxes(data: bytes, start: int, end: int):
    """(type, payload start, box start, box end) of the boxes in a span."""
    pos = start
    while pos < end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        yield kind, pos + 8, pos, pos + size
        pos += size


def find_box(data: bytes, path):
    """(box start, box end) of the box at a path of types from the top
    level, stepping over the version and flags of ``meta``."""
    start, end = 0, len(data)
    for kind in path:
        for k, ps, bs, be in boxes(data, start, end):
            if k == kind:
                start, end = ps + (4 if k == b"meta" else 0), be
                found = (bs, be)
                break
        else:
            raise KeyError(kind)
    return found


def insert_property(data: bytes, prop: bytes, essential: bool) -> bytes:
    """The file with a property box added at the end of ``ipco`` and
    associated with the primary item (cv2's files: one item, ipma version
    0 with 7-bit indices, iloc version 0 with 4-byte offsets, mdat last)."""
    d = bytearray(data)
    n_props = sum(1 for _ in boxes(data, *_payload(data, (b"meta", b"iprp",
                                                          b"ipco"))))
    ipco_end = find_box(data, (b"meta", b"iprp", b"ipco"))[1]
    ipma_s, ipma_e = find_box(data, (b"meta", b"iprp", b"ipma"))
    # ipma: header, version/flags, entry count, item id, association count
    count_at = ipma_s + 8 + 4 + 4 + 2
    assoc = bytes([(0x80 if essential else 0) | (n_props + 1)])
    d[count_at] += 1
    d[ipma_e:ipma_e] = assoc
    d[ipco_end:ipco_end] = prop
    grown = len(prop) + 1
    for path, extra, moved in (((b"meta",), grown, 0),
                               ((b"meta", b"iprp"), grown, 0),
                               ((b"meta", b"iprp", b"ipco"), len(prop), 0),
                               ((b"meta", b"iprp", b"ipma"), 1, len(prop))):
        bs = find_box(data, path)[0] + moved
        struct.pack_into(">I", d, bs, struct.unpack_from(">I", d, bs)[0] +
                         extra)
    return shift_iloc(bytes(d), grown)


def _payload(data: bytes, path):
    bs, be = find_box(data, path)
    return bs + 8, be


def shift_iloc(data: bytes, by: int) -> bytes:
    """cv2's iloc (version 0, 4-byte offsets and lengths, no base offset)
    with every extent offset moved by ``by``."""
    d = bytearray(data)
    bs, _ = find_box(data, (b"meta", b"iloc"))
    pos = bs + 8 + 4 + 2
    items = struct.unpack_from(">H", d, pos)[0]
    pos += 2
    for _ in range(items):
        pos += 4                                 # item id, data reference
        extents = struct.unpack_from(">H", d, pos)[0]
        pos += 2
        for _ in range(extents):
            off = struct.unpack_from(">I", d, pos)[0]
            struct.pack_into(">I", d, pos, off + by)
            pos += 8
    return bytes(d)


def iloc_length_at(data: bytes) -> int:
    """The offset of the first extent's length field in cv2's iloc."""
    bs, _ = find_box(data, (b"meta", b"iloc"))
    return bs + 8 + 4 + 2 + 2 + 4 + 2 + 4


# -------------------------------------------------------- box writing


def box(kind: bytes, payload: bytes, large: bool = False) -> bytes:
    if large:
        return struct.pack(">I4sQ", 1, kind, 16 + len(payload)) + payload
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def full_box(kind: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return box(kind, bytes([version]) + flags.to_bytes(3, "big") + payload)


def item_parts(data: bytes):
    """(the primary item's OBUs, its ispe, av1C and colr property boxes) of
    a file cv2 or Pillow wrote."""
    props = {}
    s, e = find_box(data, (b"meta", b"iprp", b"ipco"))
    for kind, ps, bs, be in boxes(data, s + 8, e):
        props.setdefault(kind, data[bs:be])
    s, e = find_box(data, (b"meta", b"iloc"))
    version = data[s + 8]
    assert version == 0 and data[s + 12:s + 14] == b"\x44\x00"
    off, length = struct.unpack_from(">II", data, s + 8 + 4 + 2 + 2 + 6)
    return data[off:off + length], props


def build_avif(obu: bytes, props: dict, iloc_version=0, offset_size=4,
               length_size=4, base_size=0, extents=1, idat=False,
               ipma_version=0, ipma_wide=False, infe_version=2,
               pitm_version=0, large_mdat=False) -> bytes:
    """An AVIF file around an item's OBUs written here, in the variants of
    ISO/IEC 23008-12 that libavif parses: iloc versions 0-2 and field sizes,
    the data in several extents, in mdat or in idat (construction method
    1), ipma versions 0 and 1 and its 15-bit indices, infe versions 2 and
    3, pitm versions 0 and 1, a 64-bit mdat size."""
    idn = 2 if iloc_version < 2 else 4
    cuts = [len(obu) * k // extents for k in range(extents + 1)]
    pieces = [(cuts[k], cuts[k + 1] - cuts[k]) for k in range(extents)]
    ftyp = box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miafMA1B")
    hdlr = full_box(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = full_box(b"pitm", pitm_version, 0,
                    (1).to_bytes(2 if pitm_version == 0 else 4, "big"))
    infe_id = (1).to_bytes(2 if infe_version == 2 else 4, "big")
    infe = full_box(b"infe", infe_version, 0, infe_id + bytes(2) + b"av01" +
                    b"Color\0")
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", 1) + infe)
    kinds = [k for k in (b"ispe", b"pixi", b"av1C", b"colr") if k in props]
    ipco = box(b"ipco", b"".join(props[k] for k in kinds))
    assoc = b""
    for i, k in enumerate(kinds):
        essential = 0x80 if k == b"av1C" else 0
        if ipma_wide:
            assoc += struct.pack(">H", (essential << 8) | (i + 1))
        else:
            assoc += bytes([essential | (i + 1)])
    n = len(assoc) // (2 if ipma_wide else 1)
    ipma = full_box(b"ipma", ipma_version, 1 if ipma_wide else 0,
                    struct.pack(">I", 1) + (1).to_bytes(
                        2 if ipma_version == 0 else 4, "big") + bytes([n]) +
                    assoc)
    iprp = box(b"iprp", ipco + ipma)

    def iloc(first):
        head = bytes([(offset_size << 4) | length_size,
                      (base_size << 4) | (4 if iloc_version else 0)])
        body = (1).to_bytes(idn, "big") + (1).to_bytes(idn, "big")
        if iloc_version:
            body += struct.pack(">H", 1 if idat else 0)
        body += struct.pack(">H", 0)
        body += (first if base_size else 0).to_bytes(base_size, "big")
        body += struct.pack(">H", extents)
        for k, (off, length) in enumerate(pieces):
            if iloc_version:
                body += (k + 1).to_bytes(4, "big")
            where = off + (0 if base_size else first)
            body += (where if offset_size else 0).to_bytes(offset_size, "big")
            # a length of no bytes is 0: the rest of the file or of idat
            body += (length if length_size else 0).to_bytes(length_size,
                                                            "big")
        return full_box(b"iloc", iloc_version, 0, head + body)
    extra = box(b"idat", obu) if idat else b""
    meta0 = full_box(b"meta", 0, 0, hdlr + pitm + iloc(0) + iinf + iprp +
                     extra)
    first = 0 if idat else len(ftyp) + len(meta0) + (16 if large_mdat else 8)
    meta = full_box(b"meta", 0, 0, hdlr + pitm + iloc(first) + iinf + iprp +
                    extra)
    assert len(meta) == len(meta0)
    mdat = box(b"mdat", b"" if idat else obu, large=large_mdat)
    return ftyp + meta + mdat


def obus(data: bytes):
    """[(type, header bytes, payload)] of an AV1 OBU stream with sizes."""
    out, pos = [], 0
    while pos < len(data):
        head = data[pos]
        n = 1 + ((head >> 2) & 1)
        size, shift, i = 0, 0, pos + n
        while True:
            size |= (data[i] & 0x7F) << shift
            shift += 7
            i += 1
            if not data[i - 1] & 0x80:
                break
        out.append(((head >> 3) & 15, data[pos:pos + n], data[i:i + size]))
        pos = i + size
    return out


def obu(kind: int, payload: bytes) -> bytes:
    """An OBU with its size field (no extension)."""
    size, n = b"", len(payload)
    while True:
        byte = n & 0x7F
        n >>= 7
        size += bytes([byte | (0x80 if n else 0)])
        if not n:
            break
    return bytes([(kind << 3) | 2]) + size + payload


def item_props(data: bytes, item_id: int):
    """An item's associated property boxes (whole boxes, in order) and
    whether each is essential, from a file with ipma version 0."""
    s, e = find_box(data, (b"meta", b"iprp", b"ipco"))
    props = [data[bs:be] for _, _, bs, be in boxes(data, s + 8, e)]
    s, _ = find_box(data, (b"meta", b"iprp", b"ipma"))
    assert data[s + 8] == 0 and not data[s + 11] & 1
    pos = s + 16
    for _ in range(struct.unpack_from(">I", data, s + 12)[0]):
        iid, n = struct.unpack_from(">HB", data, pos)
        assoc = [(bool(b >> 7), b & 0x7F) for b in data[pos + 3:pos + 3 + n]]
        pos += 3 + n
        if iid == item_id:
            return [(props[i - 1], ess) for ess, i in assoc]
    raise KeyError(item_id)


def alpha_parts(data: bytes):
    """(colour OBUs, colour properties, alpha OBUs, alpha properties) of a
    file Pillow wrote from RGBA: item 1 the colour, item 2 its alpha."""
    s, _ = find_box(data, (b"meta", b"iloc"))
    assert data[s + 8] == 0 and data[s + 12:s + 14] == b"\x44\x00"
    n = struct.unpack_from(">H", data, s + 14)[0]
    pos, obu_of = s + 16, {}
    for _ in range(n):
        iid, _, count = struct.unpack_from(">HHH", data, pos)
        assert count == 1
        off, length = struct.unpack_from(">II", data, pos + 6)
        obu_of[iid] = data[off:off + length]
        pos += 14
    return obu_of[1], item_props(data, 1), obu_of[2], item_props(data, 2)


def build_items(items, refs, primary: int = 1, pad: int = 0) -> bytes:
    """An AVIF file of several items: ``items`` is [(id, type, OBUs,
    [(property box, essential)])], ``refs`` [(type, from, [to])]; the
    property boxes shared by value, iloc version 0, ipma version 0, an
    iref of version 0, the items' data in mdat in their order; ``pad``
    bytes of a ``free`` box at the end of meta."""
    ftyp = box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miafMA1B")
    hdlr = full_box(b"hdlr", 0, 0, bytes(4) + b"pict" + bytes(12) + b"\0")
    pitm = full_box(b"pitm", 0, 0, struct.pack(">H", primary))
    infes = b"".join(full_box(b"infe", 2, 0, struct.pack(">HH", iid, 0) +
                              kind + b"\0") for iid, kind, _, _ in items)
    iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(items)) + infes)
    uniq = []
    for _, _, _, props in items:
        for prop, _ in props:
            if prop not in uniq:
                uniq.append(prop)
    ipco = box(b"ipco", b"".join(uniq))
    entries = b""
    for iid, _, _, props in items:
        entries += struct.pack(">HB", iid, len(props)) + bytes(
            (0x80 if ess else 0) | (uniq.index(prop) + 1)
            for prop, ess in props)
    ipma = full_box(b"ipma", 0, 0, struct.pack(">I", len(items)) + entries)
    iprp = box(b"iprp", ipco + ipma)
    iref = full_box(b"iref", 0, 0, b"".join(
        box(kind, struct.pack(">HH", src, len(dst)) +
            b"".join(struct.pack(">H", t) for t in dst))
        for kind, src, dst in refs)) if refs else b""

    def iloc(first):
        body, at = b"", first
        for iid, _, obu, _ in items:
            body += struct.pack(">HHHII", iid, 0, 1, at, len(obu))
            at += len(obu)
        return full_box(b"iloc", 0, 0, b"\x44\x00" +
                        struct.pack(">H", len(items)) + body)
    free = box(b"free", bytes(pad - 8)) if pad else b""
    meta0 = full_box(b"meta", 0, 0, hdlr + pitm + iloc(0) + iinf + iprp +
                     iref + free)
    first = len(ftyp) + len(meta0) + 8
    meta = full_box(b"meta", 0, 0, hdlr + pitm + iloc(first) + iinf + iprp +
                    iref + free)
    mdat = box(b"mdat", b"".join(obu for _, _, obu, _ in items))
    return ftyp + meta + mdat


# ---------------------------------------------------------- film grain

# libaom 3.14.1's aom_film_grain_t: 161 ints, then the uint16 random seed
GRAIN_SIZE = 648
_GRAIN_INTS = 161
_FMT = {(1, 1): 0x102, (1, 0): 0x105, (0, 0): 0x106}   # I420, I422, I444
_HIGHBITDEPTH = 0x800


def grain_fields(params: bytes) -> dict:
    """The named fields of an aom_film_grain_t."""
    v = struct.unpack("<161iH2x", params)
    names = (["apply_grain", "update_parameters"] +
             [f"y{i}" for i in range(28)] + ["num_y_points"] +
             [f"cb{i}" for i in range(20)] + ["num_cb_points"] +
             [f"cr{i}" for i in range(20)] + ["num_cr_points",
                                               "scaling_shift",
                                               "ar_coeff_lag"] +
             [f"ary{i}" for i in range(24)] + [f"arcb{i}" for i in range(25)]
             + [f"arcr{i}" for i in range(25)] +
             ["ar_coeff_shift", "cb_mult", "cb_luma_mult", "cb_offset",
              "cr_mult", "cr_luma_mult", "cr_offset", "overlap_flag",
              "clip_to_restricted_range", "bit_depth",
              "chroma_scaling_from_luma", "grain_scale_shift",
              "random_seed"])
    return dict(zip(names, v))


def grain_test_vectors():
    """libaom's 16 ``film_grain_test_vectors`` (its encoder's
    ``film-grain-test`` 1-16), as aom_film_grain_t bytes."""
    elf = Elf(_wheel_lib("libaom-*.so*"))
    raw = elf.table("film_grain_test_vectors", "u1", (16, GRAIN_SIZE))
    return [raw[i].tobytes() for i in range(16)]


def random_grain(rng, depth: int, subx: int, suby: int, mono: bool) -> bytes:
    """Random parameters of the ranges film_grain_params() codes, valid as
    libaom's reader checks them."""
    def points(n):
        xs = np.sort(rng.choice(256, n, replace=False))
        return [(int(x), int(rng.integers(0, 256))) for x in xs]
    ny = int(rng.integers(0, 15))
    csfl = 0 if mono else int(rng.random() < 0.25)
    ncb = ncr = 0
    if not (mono or csfl or (subx and suby and ny == 0)):
        ncb = int(rng.integers(0, 11))
        ncr = int(rng.integers(0, 11))
        if subx and suby and (ncb == 0) != (ncr == 0):
            ncr = ncb
    lag = int(rng.integers(0, 4))
    npos = 2 * lag * (lag + 1)
    ints = [1, 1]
    for n, cap in ((ny, 14), (ncb, 10), (ncr, 10)):
        flat = [c for pt in points(n) for c in pt]
        ints += flat + [0] * (2 * cap - len(flat)) + [n]
    ints += [int(rng.integers(8, 12)), lag]
    ary = [int(rng.integers(-128, 128)) for _ in range(npos)] if ny else []
    ints += ary + [0] * (24 - len(ary))
    for n in (ncb, ncr):
        ar = [int(rng.integers(-128, 128)) for _ in range(npos + (ny > 0))] \
            if (n or csfl) else []
        ints += ar + [0] * (25 - len(ar))
    ints += [int(rng.integers(6, 10))]
    for n in (ncb, ncr):
        ints += ([int(rng.integers(0, 256)), int(rng.integers(0, 256)),
                  int(rng.integers(0, 512))] if n else [0, 0, 0])
    ints += [int(rng.integers(0, 2)), int(rng.integers(0, 2)), depth, csfl,
             int(rng.integers(0, 4))]
    assert len(ints) == _GRAIN_INTS
    return struct.pack("<161iH2x", *ints, int(rng.integers(0, 65536)))


def with_depth(params: bytes, depth: int) -> bytes:
    """The parameters with their bit_depth field set."""
    d = bytearray(params)
    struct.pack_into("<I", d, 4 * 158, depth)
    return bytes(d)


def _aom_image(planes, w, h, depth, subx, suby, mono, mc, hbd):
    """An aom_image_t (libaom 3.14.1's layout) over padded planes."""
    img = bytearray(168)
    fmt = _FMT[(subx, suby)] | (_HIGHBITDEPTH if hbd else 0)
    struct.pack_into("<7i", img, 0, fmt, 2, 2, mc, int(mono), 0, 1)
    struct.pack_into("<11I", img, 28, w, h, depth, w, h, w, h,
                     subx, suby, 0, 0)
    struct.pack_into("<3Q3i", img, 64, *(p.ctypes.data for p in planes),
                     *(p.strides[0] for p in planes))
    struct.pack_into("<i", img, 112, 16 if hbd else 8)
    return (ctypes.c_char * 168).from_buffer(img)


def libaom_film_grain(params: bytes, planes, depth: int, subx: int,
                      suby: int, mono: bool = False, mc: int = 1,
                      hbd: bool = True):
    """libaom's own ``av1_add_film_grain`` (by symbol) on a frame: planes
    [Y, U, V] (uint16; uint8 for libaom's 8-bit path with ``hbd`` False) of
    a w x h frame, each allocated with even sides (the copy libaom makes
    reads them so) → the planes with grain, at the frame's sizes.  ``mc``
    is the frame's matrix coefficients (0, the identity, changes the
    chroma's restricted range)."""
    h, w = planes[0].shape
    we, he = w + (w & 1), h + (h & 1)
    dt = np.uint16 if hbd else np.uint8
    src, dst = [], []
    if mono:        # libaom's monochrome frame keeps 4:2:0 chroma planes
        subx = suby = 1
        planes = list(planes) + [np.zeros((he >> 1, we >> 1), dt)] * 2
    for p, a in enumerate(planes):
        sx, sy = (subx, suby) if p else (0, 0)
        pad = np.zeros((max(he >> sy, 1), max(we >> sx, 1)), dt)
        pad[:a.shape[0], :a.shape[1]] = a
        src.append(pad)
        dst.append(np.zeros_like(pad))
    fn = libaom_function("av1_add_film_grain", ctypes.c_int, ctypes.c_char_p,
                         ctypes.c_void_p, ctypes.c_void_p)
    simg = _aom_image(src, w, h, depth, subx, suby, mono, mc, hbd)
    dimg = _aom_image(dst, w, h, depth, subx, suby, mono, mc, hbd)
    if fn(params, ctypes.addressof(simg), ctypes.addressof(dimg)) != 0:
        raise ValueError("av1_add_film_grain refused its input")
    out = [d[:a.shape[0], :a.shape[1]].astype(np.uint16)
           for d, a in zip(dst, planes)]
    return out[:1] if mono else out


def port_film_grain(params: bytes, planes, subx: int, suby: int,
                    mono: bool = False, mc: int = 1):
    """The port's synthesis alone (``av1_film_grain`` of the codec) on the
    same frame."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    h, w = planes[0].shape
    we, he = w + (w & 1), h + (h & 1)
    pads = []
    for p, a in enumerate(planes):
        sx, sy = (subx, suby) if p else (0, 0)
        pad = np.zeros((max(he >> sy, 1), max(we >> sx, 1)), np.uint16)
        pad[:a.shape[0], :a.shape[1]] = a
        pads.append(pad)
    if mono:
        pads += [np.zeros((1, 1), np.uint16)] * 2
    lib.av1_film_grain(params, subx, suby, int(mono), int(mc == 0), w, h,
                       pads[0].ctypes.data, pads[0].shape[1],
                       pads[1].ctypes.data, pads[2].ctypes.data,
                       pads[1].shape[1])
    return [pd[:a.shape[0], :a.shape[1]] for pd, a in zip(pads, planes)]


def port_grain_params(obu: bytes):
    """(the frame's planes before its grain, the port's parsed grain
    parameters as aom_film_grain_t bytes, info) of an item's OBUs."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    planes, info = image_io.decode_av1(obu, grain=False)
    err = ctypes.create_string_buffer(256)
    handle = lib.av1_decode(obu, len(obu), 1, err, 256)
    out = ctypes.create_string_buffer(GRAIN_SIZE)
    lib.av1_grain_params(handle, out)
    lib.av1_free(handle)
    return planes, out.raw, info


def grain_dict(params: bytes) -> dict:
    """aom_film_grain_t bytes → the fields film_grain_params() codes, as
    lists: ``y``, ``cb``, ``cr`` the scaling points, ``ar_y``, ``ar_cb``,
    ``ar_cr`` the coefficients (those coded for these counts)."""
    f = grain_fields(params)
    lag = f["ar_coeff_lag"]
    npos = 2 * lag * (lag + 1)
    out = dict(apply=f["apply_grain"], seed=f["random_seed"],
               csfl=f["chroma_scaling_from_luma"],
               scaling_shift=f["scaling_shift"], lag=lag,
               ar_shift=f["ar_coeff_shift"], gss=f["grain_scale_shift"],
               overlap=f["overlap_flag"],
               clip=f["clip_to_restricted_range"])
    for key, n in (("y", "num_y_points"), ("cb", "num_cb_points"),
                   ("cr", "num_cr_points")):
        out[key] = [(f[f"{key}{2 * i}"], f[f"{key}{2 * i + 1}"])
                    for i in range(f[n])]
    out["ar_y"] = [f[f"ary{i}"] for i in range(npos)]
    nc = npos + (len(out["y"]) > 0)
    out["ar_cb"] = [f[f"arcb{i}"] for i in range(nc)]
    out["ar_cr"] = [f[f"arcr{i}"] for i in range(nc)]
    for c in ("cb", "cr"):
        out[c + "_mult"] = (f[c + "_mult"], f[c + "_luma_mult"],
                            f[c + "_offset"])
    return out


def grain_bits(g: dict, mono: bool, subx: int, suby: int) -> str:
    """film_grain_params() of a shown key frame as a string of bits, from
    ``grain_dict``'s fields (the counts are the lists' lengths, so a list
    may break the reader's rules)."""
    out = []

    def put(v, n):
        out.append(format(v & ((1 << n) - 1), f"0{n}b"))
    put(g["apply"], 1)
    if not g["apply"]:
        return "".join(out)
    put(g["seed"], 16)
    put(len(g["y"]), 4)
    for x, s in g["y"]:
        put(x, 8)
        put(s, 8)
    csfl = 0 if mono else g["csfl"]
    if not mono:
        put(csfl, 1)
    ncb = ncr = 0
    if not (mono or csfl or (subx and suby and not g["y"])):
        for key in ("cb", "cr"):
            put(len(g[key]), 4)
            for x, s in g[key]:
                put(x, 8)
                put(s, 8)
        ncb, ncr = len(g["cb"]), len(g["cr"])
    put(g["scaling_shift"] - 8, 2)
    put(g["lag"], 2)
    npos = 2 * g["lag"] * (g["lag"] + 1)
    if g["y"]:
        for c in g["ar_y"][:npos]:
            put(c + 128, 8)
    nc = npos + (len(g["y"]) > 0)
    for key, n in (("ar_cb", ncb), ("ar_cr", ncr)):
        if n or csfl:
            for c in g[key][:nc]:
                put(c + 128, 8)
    put(g["ar_shift"] - 6, 2)
    put(g["gss"], 2)
    for key, n in (("cb_mult", ncb), ("cr_mult", ncr)):
        if n:
            put(g[key][0], 8)
            put(g[key][1], 8)
            put(g[key][2], 9)
    put(g["overlap"], 1)
    put(g["clip"], 1)
    return "".join(out)


def _bits(data: bytes) -> str:
    return "".join(format(b, "08b") for b in data)


def _bytes(bits: str) -> bytes:
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def with_grain(stream: bytes, g) -> bytes:
    """An item's OBUs (one sequence header and one frame OBU, as libaom
    writes a still image) with the frame's film grain fields replaced by
    ``g`` (``grain_dict`` fields, or None for none), the sequence header's
    film_grain_params_present set to match."""
    _, params, info = port_grain_params(stream)
    mono, subx, suby = bool(info[5]), info[3], info[4]
    gbit, hbytes = info[24:26]
    had = False
    parts = obus(stream)
    out = b""
    for kind, head, payload in parts:
        if kind == 1:
            bits = _bits(payload)
            one = bits.rindex("1")           # trailing_one_bit
            had = bits[one - 1] == "1"
            bits = bits[:one - 1] + ("1" if g is not None else "0") + \
                bits[one:]
            payload = _bytes(bits)
        elif kind == 6:
            bits = _bits(payload[:hbytes])
            old = ""
            if had:
                old = grain_bits(grain_dict(params), mono, subx, suby)
                assert bits[gbit:gbit + len(old)] == old, "not re-encoded"
            new = grain_bits(g, mono, subx, suby) if g is not None else ""
            payload = _bytes(bits[:gbit] + new) + payload[hbytes:]
        out += head + _leb(len(payload)) + payload
    return out


def _leb(n: int) -> bytes:
    out = b""
    while True:
        byte = n & 0x7F
        n >>= 7
        out += bytes([byte | (0x80 if n else 0)])
        if not n:
            return out


# --------------------------------------------------------------- grids


def grid_payload(rows: int, cols: int, width: int, height: int,
                 flags: int = 0, version: int = 0) -> bytes:
    """An ImageGrid item's data (ISO/IEC 23008-12 6.6.2.3.2): 16-bit output
    sizes, or 32-bit with flags bit 0."""
    n = 4 if flags & 1 else 2
    return bytes([version, flags, rows - 1, cols - 1]) + \
        width.to_bytes(n, "big") + height.to_bytes(n, "big")


def ispe_box(width: int, height: int) -> bytes:
    return full_box(b"ispe", 0, 0, struct.pack(">II", width, height))


def split_tiles(img: np.ndarray, rows: int, cols: int, tw: int, th: int):
    """An image cut into rows x cols tiles of tw x th (the last row and
    column padded by repeating the edge, as an encoder pads a grid)."""
    img = img[:rows * th, :cols * tw]
    h, w = img.shape[:2]
    pad = np.pad(img, [(0, rows * th - h), (0, cols * tw - w)] +
                 [(0, 0)] * (img.ndim - 2), mode="edge")
    return [pad[r * th:(r + 1) * th, c * tw:(c + 1) * tw]
            for r in range(rows) for c in range(cols)]


def tile_item(data: bytes):
    """(OBUs, [(property box, essential)]) of a one-item file's primary
    item, to serve as a grid tile."""
    obu, props = item_parts(data)
    return obu, [(props[k], k == b"av1C")
                 for k in (b"ispe", b"pixi", b"av1C", b"colr") if k in props]


def grid_avif(tiles, rows: int, cols: int, width: int, height: int,
              grid_props=None, payload=None, dimg=None, alpha=None,
              pad: int = 512) -> bytes:
    """A grid image: item 1 the grid (``grid_props`` [(box, essential)],
    by default an ispe of the output size and the first tile's colr and
    pixi), items 2.. its tiles ([(OBUs, props)] from ``tile_item``) in
    ``dimg`` order (default the tiles' own); ``alpha`` another (tiles,
    rows, cols) grid made the colour's alpha item.  The ``pad`` bytes of
    free space in meta keep it past the 500 bytes of OpenCV's signature
    test, whose parse would otherwise read the grid's payload."""
    if grid_props is None:
        first = dict((p[4:8], p) for p, _ in tiles[0][1])
        grid_props = [(ispe_box(width, height), False)] + [
            (first[k], False) for k in (b"pixi", b"colr") if k in first]
    payload = payload or grid_payload(rows, cols, width, height)
    items = [(1, b"grid", payload, grid_props)]
    ids = list(range(2, 2 + len(tiles)))
    items += [(i, b"av01", obu, props) for i, (obu, props) in zip(ids, tiles)]
    refs = [(b"dimg", 1, ids if dimg is None else [ids[k] for k in dimg])]
    if alpha is not None:
        atiles, arows, acols = alpha
        aid = 2 + len(tiles)
        urn = b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0"
        auxc = full_box(b"auxC", 0, 0, urn)
        items.append((aid, b"grid", grid_payload(arows, acols, width, height),
                      [(ispe_box(width, height), False), (auxc, False)]))
        tids = list(range(aid + 1, aid + 1 + len(atiles)))
        items += [(i, b"av01", obu, props)
                  for i, (obu, props) in zip(tids, atiles)]
        refs += [(b"dimg", aid, tids), (b"auxl", aid, [1])]
    return build_items(items, refs, pad=pad)


# ------------------------------------------------------ image sequences


def pillow_sequence(bgr: np.ndarray, frames: int = 2, **opts) -> bytes:
    """Pillow's ``avis`` bytes of a BGR (or BGRA) image written ``frames``
    times over (``save_all=True``; libavif encodes in libaom's good-quality
    mode, whose ``speed`` and ``advanced`` options choose its tools)."""
    from PIL import Image
    img = Image.fromarray(np.ascontiguousarray(
        bgr[..., [2, 1, 0, 3][:bgr.shape[2]]]))
    buf = io.BytesIO()
    img.save(buf, "AVIF", save_all=True, append_images=[img] * (frames - 1),
             **opts)
    return buf.getvalue()


def _walk(data: bytes, start: int, end: int, path=()):
    for kind, s, bs, be in boxes(data, start, end):
        yield path + (kind,), s, be
        if kind in (b"moov", b"trak", b"mdia", b"minf", b"stbl", b"edts",
                    b"tref", b"dinf"):
            yield from _walk(data, s, be, path + (kind,))


def sequence_parts(data: bytes):
    """[(samples, sample entry property boxes {kind: box}, width, height,
    handler)] of each track of a Pillow ``avis`` file (one chunk a track,
    ``stsz`` sizes, ``stco`` offsets)."""
    tracks = []
    for path, s, e in _walk(data, 0, len(data)):
        kind = path[-1]
        if kind == b"trak":
            tracks.append(dict(props={}))
        t = tracks[-1] if tracks else None
        if kind == b"tkhd":
            at = s + 4 + (32 if data[s] == 1 else 20) + 52
            t["width"], t["height"] = (v >> 16 for v in struct.unpack_from(
                ">II", data, at))
        elif kind == b"hdlr" and path[-2] == b"mdia":
            t["handler"] = data[s + 8:s + 12]
        elif kind == b"stsz":
            n = struct.unpack_from(">I", data, s + 8)[0]
            t["sizes"] = struct.unpack_from(f">{n}I", data, s + 12)
        elif kind == b"stco":
            t["offset"] = struct.unpack_from(">I", data, s + 8)[0]
        elif kind == b"stsd":
            es = s + 8
            assert data[es + 4:es + 8] == b"av01"
            ee = es + struct.unpack_from(">I", data, es)[0]
            for pk, _, bs, be in boxes(data, es + 8 + 78, ee):
                t["props"][pk] = data[bs:be]
    out = []
    for t in tracks:
        off, samples = t["offset"], []
        for n in t["sizes"]:
            samples.append(data[off:off + n])
            off += n
        out.append((samples, t["props"], t["width"], t["height"],
                    t["handler"]))
    return out


def _track(tid: int, samples, props: dict, width: int, height: int,
           offsets, *, handler=b"pict", aux_for=0, co64=False, chunks=None,
           stss=(1,), edts=True, tkhd_size=None, entry=b"av01",
           duration=None, extra=(), prem_by=0) -> bytes:
    """A ``trak`` of samples laid out in chunks (samples a chunk; one chunk
    of all by default) at the chunks' ``offsets``; ``extra``: more property
    boxes after the sample entry's av1C, colr and pixi; ``prem_by``: the
    track a ``prem`` reference names."""
    chunks = chunks or [len(samples)]
    w, h = tkhd_size or (width, height)
    duration = 100 * len(samples) if duration is None else duration
    tkhd = full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, tid, 0,
                                               duration) +
                    bytes(8) + bytes(8) + struct.pack(
                        ">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0,
                        0x40000000) + struct.pack(">II", w << 16, h << 16))
    out = tkhd
    if aux_for or prem_by:
        out += box(b"tref", (box(b"auxl", struct.pack(">I", aux_for))
                             if aux_for else b"") +
                   (box(b"prem", struct.pack(">I", prem_by)) if prem_by
                    else b""))
    if edts:
        out += box(b"edts", full_box(b"elst", 0, 1, struct.pack(
            ">IIII", 1, 100 * len(samples), 0, 0x10000)))
    mdhd = full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                               100 * len(samples)) +
                    struct.pack(">HH", 0x55C4, 0))
    hdlr = full_box(b"hdlr", 0, 0, bytes(4) + handler + bytes(12) + b"\0")
    vse = bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(
        ">HHIIIH", width, height, 0x480000, 0x480000, 0, 1) + bytes(32) + \
        struct.pack(">Hh", 24, -1)
    stsd = full_box(b"stsd", 0, 0, struct.pack(">I", 1) + box(
        entry, vse + b"".join(props[k] for k in (b"av1C", b"colr", b"pixi")
                              if k in props) + b"".join(extra)))
    stts = full_box(b"stts", 0, 0, struct.pack(">III", 1, len(samples), 100))
    runs = []
    for k, n in enumerate(chunks):
        if not runs or runs[-1][1] != n:
            runs.append((k + 1, n))
    stsc = full_box(b"stsc", 0, 0, struct.pack(">I", len(runs)) + b"".join(
        struct.pack(">III", first, n, 1) for first, n in runs))
    stsz = full_box(b"stsz", 0, 0, struct.pack(">II", 0, len(samples)) +
                    b"".join(struct.pack(">I", len(x)) for x in samples))
    if co64:
        stco = full_box(b"co64", 0, 0, struct.pack(">I", len(offsets)) +
                        b"".join(struct.pack(">Q", o) for o in offsets))
    else:
        stco = full_box(b"stco", 0, 0, struct.pack(">I", len(offsets)) +
                        b"".join(struct.pack(">I", o) for o in offsets))
    stss_box = full_box(b"stss", 0, 0, struct.pack(">I", len(stss)) +
                        b"".join(struct.pack(">I", k) for k in stss)) \
        if stss is not None else b""
    stbl = box(b"stbl", stsd + stts + stsc + stsz + stco + stss_box)
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1) +
                                 full_box(b"url ", 0, 1, b"")))
    minf = box(b"minf", full_box(b"vmhd", 0, 1, bytes(8)) + dinf + stbl)
    return box(b"trak", out + box(b"mdia", mdhd + hdlr + minf))


def build_sequence(samples, props: dict, width: int, height: int, *,
                   major=b"avis", compat=(b"avif", b"avis", b"msf1", b"iso8",
                                          b"mif1", b"miaf", b"MA1B"),
                   meta=True, item_sample=0, moov=True, moov_first=False,
                   alpha=None, past_end=0, alpha_tkhd_size=None,
                   **track) -> bytes:
    """An image sequence written here as Pillow lays one out (ftyp, meta
    with a primary item whose extent is the sample ``item_sample``, moov,
    mdat), with the layouts libavif meets: another major brand or
    compatible brands, no meta or no moov, moov first, an alpha track
    (``alpha``: (samples, properties), an ``auxl`` to track 1; its tkhd's
    size ``alpha_tkhd_size``), a first chunk ``past_end`` bytes past the
    file's end, and the track options of ``_track`` (co64, chunks, stss,
    edts, tkhd_size, duration, prem_by)."""
    chunks = track.get("chunks") or [len(samples)]
    ftyp = box(b"ftyp", major + bytes(4) + b"".join(compat))
    parts = [samples] + ([alpha[0]] if alpha else [])
    payload = b"".join(b"".join(p) for p in parts)

    def layout(base):
        # the offsets of each track's chunks and each sample's
        offs, at = [], base
        for k, ss in enumerate(parts):
            cuts = chunks if k == 0 else [len(ss)]
            chunk_offs, i = [], 0
            for n in cuts:
                chunk_offs.append(at + (past_end if k == 0 else 0))
                at += sum(len(x) for x in ss[i:i + n])
                i += n
            offs.append(chunk_offs)
        return offs

    def build(base):
        offs = layout(base)
        sample_at = offs[0][0] + sum(len(x) for x in samples[:item_sample])
        m = b""
        if meta:
            props_item = dict(props)
            props_item[b"ispe"] = ispe_box(width, height)
            m = build_avif(samples[item_sample], props_item)
            # build_avif's meta, its extent moved to the sample
            s = len(box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miafMA1B"))
            size = struct.unpack_from(">I", m, s)[0]
            m = bytearray(m[s:s + size])
            i = m.index(b"iloc") + 4 + 4 + 2 + 2 + 2 + 2 + 2
            m[i:i + 4] = struct.pack(">I", sample_at)
            m = bytes(m)
        mv = b""
        if moov:
            mvhd = full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, 1000,
                                                       100 * len(samples)) +
                            struct.pack(">IH", 0x10000, 0x100) + bytes(10) +
                            struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0,
                                        0, 0, 0x40000000) + bytes(24) +
                            struct.pack(">I", 3))
            trak = _track(1, samples, props, width, height, offs[0], **track)
            if alpha:
                trak += _track(2, alpha[0], alpha[1], width, height, offs[1],
                               handler=b"auxv", aux_for=1,
                               tkhd_size=alpha_tkhd_size)
            mv = box(b"moov", mvhd + trak)
        head = ftyp + (mv + m if moov_first else m + mv)
        return head
    head = build(0)
    head = build(len(head) + 8)
    return head + box(b"mdat", payload)


def full_headers(stream: bytes, *, still: int = 1, timing: bool = False,
                 decoder_model: bool = False, ops=((0, None),),
                 frame_ids: bool = False, order_hint_bits: int = 7,
                 display_delay: bool = False, extension=None,
                 frame_kind: str = "0001", hints=(0,) * 8) -> bytes:
    """An item's OBUs of a reduced still-picture sequence header (cv2's and
    Pillow's still images) rewritten with a full one: the timing and
    decoder model info, the operating points ``ops`` ((idc, level or None
    for the original's)), frame ids, order hints, screen content tools and
    integer MVs chosen per frame; and the key frame's header rewritten as a
    full sequence's: show_existing_frame, frame_type, show_frame, the frame
    id and order hint, the decoder model's removal times, and
    disable_frame_end_update_cdf; ``frame_kind`` the bits of
    show_existing_frame, frame_type and show_frame (a shown key frame by
    default; others leave the rest of the header as a key frame's), or
    "intra_only" (a shown intra-only frame: error_resilient_mode and
    refresh_frame_flags written too; "intra_only_resilient" the same error
    resilient, its eight ref_order_hint[] ``hints``, which name slots no
    frame filled: libaom rebuilds each) or "hidden_key" (a key frame not
    shown, showable, refreshing slot 0, then a frame header OBU whose
    show_existing_frame shows it): frames ``frame_of_kind`` makes.  With
    ``extension`` (temporal id,
    spatial id) every OBU but the sequence header carries an extension
    header.  The file must have no film grain (its header ends at
    decode_av1's grain bit)."""
    _, _, info = port_grain_params(stream)
    gbit, hbytes = info[24:26]
    out = b""
    en_superres = allow_sct = 0
    for kind, head, payload in obus(stream):
        bits = _bits(payload)
        if kind == 1:
            assert bits[4] == "1", "not a reduced sequence header"
            level = bits[5:10]
            p = 10
            fwb = int(bits[p:p + 4], 2) + 1
            fhb = int(bits[p + 4:p + 8], 2) + 1
            p += 8 + fwb + fhb
            sizes = bits[10:p]
            tools = bits[p:p + 3]           # sb128, filter intra, edges
            en_superres = int(bits[p + 3])
            assert not en_superres
            rest = bits[p + 3:bits.rindex("1")]
            new = bits[:3] + str(still) + "0"
            new += "1" if timing else "0"
            if timing:
                new += format(1, "032b") + format(25, "032b") + "0"
                new += "1" if decoder_model else "0"
                if decoder_model:
                    new += format(9, "05b") + format(1, "032b") + \
                        format(9, "05b") + format(9, "05b")
            new += "1" if display_delay else "0"
            new += format(len(ops) - 1, "05b")
            for idc, lv in ops:
                lv = level if lv is None else format(lv, "05b")
                new += format(idc, "012b") + lv
                if int(lv, 2) > 7:
                    new += "0"
                if decoder_model:
                    new += "1" + "0" * 10 + "0" * 10 + "0"
                if display_delay:
                    new += "1" + format(3, "04b")
            new += sizes
            new += "1" + format(4, "04b") + format(2, "03b") if frame_ids \
                else "0"
            new += tools + "0000"
            if order_hint_bits:
                new += "1" + "00" + "1" + "1" + format(order_hint_bits - 1,
                                                       "03b")
            else:
                new += "0" + "1" + "1"
            payload = _bytes(new + rest + "1")
        elif kind == 6:
            p = 2
            allow_sct = int(bits[1])
            if allow_sct:
                p += 1
            if en_superres:
                p += 1
            if bits[p] == "1":
                p += 32
            p += 1
            if allow_sct:
                p += 1
            intra_only = frame_kind.startswith("intra_only")
            kind_bits = {"intra_only": "0101", "intra_only_resilient": "0101",
                         "hidden_key": "0000"}.get(frame_kind, frame_kind)
            shown = kind_bits[3] == "1"
            new = kind_bits                         # a shown key frame
            if timing and decoder_model and shown:
                new += "0" * 10                     # frame_presentation_time
            if frame_kind == "hidden_key":
                new += "1"                          # showable_frame
            if intra_only or frame_kind == "hidden_key":   # error resilient
                new += str(int(frame_kind == "intra_only_resilient"))
            # disable_cdf_update; allow_screen_content_tools and
            # force_integer_mv chosen per frame: the reduced header's values
            new += bits[:2] + (bits[2] if allow_sct else "")
            if frame_ids:
                new += "0" * 9
            new += "0" + "0" * order_hint_bits      # size override, hint
            if decoder_model:
                new += "1" + "0" * 10 * len(ops)
            if intra_only or frame_kind == "hidden_key":
                new += "00000001"                   # refresh_frame_flags
            if frame_kind == "intra_only_resilient" and order_hint_bits:
                new += "".join(format(h, f"0{order_hint_bits}b")
                               for h in hints)      # ref_order_hint[]
            new += bits[2 + allow_sct:p]            # sizes, render, intrabc
            if bits[0] == "0":
                new += "1"                          # no end update
            new += bits[p:gbit]
            payload = _bytes(new) + payload[hbytes:]
        if extension is not None and kind != 1:
            t, s = extension
            head = bytes([(kind << 3) | 6, (t << 5) | (s << 3)])
        else:
            head = bytes([(kind << 3) | 2])
        out += head + _leb(len(payload)) + payload
        if kind == 6 and frame_kind == "hidden_key":
            # show_existing_frame of slot 0 (frame_to_show_map_idx), the
            # presentation time and frame id where the header has them
            bits = "1" + "000"
            if timing and decoder_model:
                bits += "0" * 10
            if frame_ids:
                bits += "0" * 9
            out += bytes([(3 << 3) | 2]) + _leb(1) + _bytes(bits + "1")
    return out


def frame_of_kind(stream: bytes, kind: str) -> bytes:
    """cv2's still item OBUs as a full sequence (still_picture 0) whose
    frame is of another kind: "intra_only" (an intra-only frame first) or
    "hidden_key" (a hidden key frame a show_existing_frame header shows);
    cv2 reads both (``full_headers``)."""
    return full_headers(stream, still=0, frame_kind=kind)


def seq_fields(payload: bytes) -> dict:
    """The fields of a full sequence header without timing info (as
    libaom's encoder writes it) that a frame header's first bits depend
    on: the frame size bits, frame ids and their delta bits, order hint
    bits, the screen content and integer MV choices."""
    bits = _bits(payload)
    assert bits[4] == "0" and bits[5] == "0", "reduced or with timing info"
    delay = bits[6] == "1"
    n_ops = int(bits[7:12], 2) + 1
    p = 12
    for _ in range(n_ops):
        level = int(bits[p + 12:p + 17], 2)
        p += 17 + (level > 7)
        if delay:
            p += 1 + 4 * (bits[p] == "1")
    fwb, fhb = int(bits[p:p + 4], 2) + 1, int(bits[p + 4:p + 8], 2) + 1
    p += 8 + fwb + fhb
    frame_ids = bits[p] == "1"
    p += 1
    id_bits = delta_bits = 0
    if frame_ids:
        delta_bits = int(bits[p:p + 4], 2) + 2
        id_bits = int(bits[p + 4:p + 7], 2) + delta_bits + 1
        p += 7
    p += 7                                     # sb128 .. dual filter
    order_hint = bits[p] == "1"
    p += 1 + 2 * order_hint
    force_sct = 2 if bits[p] == "1" else int(bits[p + 1])
    p += 1 + (bits[p] == "0")
    force_imv = 2
    if force_sct:
        force_imv = 2 if bits[p] == "1" else int(bits[p + 1])
        p += 1 + (bits[p] == "0")
    hint_bits = int(bits[p:p + 3], 2) + 1 if order_hint else 0
    return dict(id_bits=id_bits, delta_bits=delta_bits, hint_bits=hint_bits,
                force_sct=force_sct, force_imv=force_imv, fwb=fwb, fhb=fhb)


def _inter_frame(stream: bytes, resilient=True, frame: int = -1
                      ) -> dict:
    """A frame OBU of several frames' OBUs (``libaom_encode_frames``', no
    film grain): the last (or the ``frame``-th of the frame OBUs), an inter
    frame, shown or not, error resilient where ``resilient`` (None: either):
    ``before`` and ``after`` (the OBUs around it), ``head`` (its OBU
    header), ``payload``, ``bits`` (its header's bits up to the film grain
    fields), ``hbytes`` (the header's bytes), ``seq`` (the sequence
    header's fields), ``info`` (decode_av1's of the stream cut after it),
    ``resilient``, ``order_hint``, ``primary`` (primary_ref_frame, 7 where
    none) and where its frame_size_override_flag, refresh_frame_flags,
    ref_order_hint[] (error resilient), ref_frame_idx[] and, after them,
    the frame's size start (``override``, ``refresh``, ``hints``, ``idx``,
    ``size``)."""
    parts = obus(stream)
    at = [i for i, (k, _, _) in enumerate(parts) if k == 6][frame]
    join = lambda ps: b"".join(h + _leb(len(x)) + x        # noqa: E731
                               for _, h, x in ps)
    _, _, info = port_grain_params(join(parts[:at + 1]))
    gbit, hbytes = info[24:26]
    seq = seq_fields([p for k, _, p in parts if k == 1][0])
    _, head, payload = parts[at]
    bits = _bits(payload[:hbytes])[:gbit]
    assert bits[:3] == "001", "not an inter frame"
    p = 5 if bits[3] == "1" else 6          # showable_frame where hidden
    er = bits[p - 1] == "1"
    assert resilient is None or er == resilient, "not a frame of that kind"
    p += 1
    sct = seq["force_sct"]
    if sct == 2:
        sct = int(bits[p])
        p += 1
    if sct and seq["force_imv"] == 2:
        p += 1
    override = p + seq["id_bits"]
    n = seq["hint_bits"]
    hint = int(bits[override + 1:override + 1 + n] or "0", 2)
    primary = 7 if er else int(bits[override + 1 + n:][:3], 2)
    refresh = override + 1 + n + (0 if er else 3)
    hints = refresh + 8
    # after the slots' order hints: frame_refs_short_signaling, then
    # ref_frame_idx[] with their delta frame ids
    idx = hints + (8 * n if er else 0) + (1 if n else 0)
    return dict(before=join(parts[:at]), after=join(parts[at + 1:]),
                head=head, payload=payload, bits=bits, hbytes=hbytes,
                seq=seq, info=info, resilient=er, order_hint=hint,
                primary=primary, override=override, refresh=refresh,
                hints=hints, idx=idx, size=idx + 7 * (3 + seq["delta_bits"]))


def _with_header(frame: dict, bits: str) -> bytes:
    """``_inter_frame``'s stream with the frame's header bits (up to
    its film grain fields) replaced."""
    payload = _bytes(bits) + frame["payload"][frame["hbytes"]:]
    return frame["before"] + frame["head"] + _leb(len(payload)) + payload + \
        frame["after"]


def _frame_size_bits(seq: dict, width: int, height: int) -> str:
    return format(width - 1, f"0{seq['fwb']}b") + format(
        height - 1, f"0{seq['fhb']}b")


def switch_last_frame(stream: bytes) -> bytes:
    """Several frames' OBUs (``libaom_encode_frames``' with
    error-resilient-mode, no film grain) with the last frame, an error
    resilient inter frame, made a switch frame (frame_type 3): its
    error_resilient_mode, frame_size_override_flag and refresh_frame_flags
    dropped (a switch frame implies them), its size written.  libaom
    decodes it as the inter frame it was."""
    f = _inter_frame(stream)
    bits, override, refresh = f["bits"], f["override"], f["refresh"]
    assert bits[override] == "0", "a frame size override"
    size = _frame_size_bits(f["seq"], *f["info"][:2])
    return _with_header(f, "0111" + bits[5:override] +
                        bits[override + 1:refresh] +
                        bits[refresh + 8:f["size"]] + size +
                        bits[f["size"]:])


def with_ref_order_hint(stream: bytes, slot: int, hint: int,
                        frame: int = -1) -> bytes:
    """Several frames' OBUs (``libaom_encode_frames``' with error resilient
    frames and order hints, no film grain) with the last (or the
    ``frame``-th) frame's ref_order_hint[slot] rewritten to ``hint``, an
    error resilient inter frame's: a slot whose order hint differs from the
    frame's own, which libaom's decoder rebuilds as a neutral-grey buffer
    of that order hint (set_planes_to_neutral_grey) that keeps the rest of
    what it last held."""
    f = _inter_frame(stream, frame=frame)
    n = f["seq"]["hint_bits"]
    assert n, "no order hints"
    at = f["hints"] + n * slot
    return _with_header(f, f["bits"][:at] + format(hint % (1 << n),
                                                   f"0{n}b") +
                        f["bits"][at + n:])


def ref_order_hints(stream: bytes, frame: int = -1) -> tuple:
    """The last (or the ``frame``-th) frame's ref_order_hint[] and
    ref_frame_idx[] (as ``with_ref_order_hint`` takes its stream)."""
    f = _inter_frame(stream, frame=frame)
    bits, seq, n = f["bits"], f["seq"], f["seq"]["hint_bits"]
    order = [int(bits[f["hints"] + n * i:][:n], 2) for i in range(8)]
    return order, frame_refs(stream, frame)["idx"]


def frame_refs(stream: bytes, frame: int = -1) -> dict:
    """Of the last (or the ``frame``-th) frame OBU, an inter frame:
    ``idx`` its ref_frame_idx[] (LAST .. ALTREF), ``refresh`` its
    refresh_frame_flags, ``primary`` its primary_ref_frame (7: none),
    ``resilient`` its error_resilient_mode, ``order_hint`` and ``shown``."""
    f = _inter_frame(stream, None, frame)
    bits, seq = f["bits"], f["seq"]
    assert bits[f["idx"] - 1] == "0" or not seq["hint_bits"], \
        "short signaled"
    idx = [int(bits[f["idx"] + i * (3 + seq["delta_bits"]):][:3], 2)
           for i in range(7)]
    return dict(idx=idx, refresh=int(bits[f["refresh"]:][:8], 2),
                primary=f["primary"], resilient=f["resilient"],
                order_hint=f["order_hint"], shown=bits[3] == "1")


def with_frame_size(stream: bytes, width: int, height: int) -> bytes:
    """Several frames' OBUs (``libaom_encode_frames``', no film grain) with
    the last frame given another size: written over the size an error
    resilient frame gives (frame_size_override_flag 1: libaom's
    ``resize``), or given one by frame_size_override_flag 1 (without error
    resilience after seven found_ref bits of 0).  Its references are then
    of another scale; where its mi grid is the same (each side within the
    same 8 samples), the tile data still decodes."""
    payload = [p for k, _, p in obus(stream) if k == 6][-1]
    resilient = _bits(payload[:1])[4] == "1"
    f = _inter_frame(stream, resilient)
    bits, override, at = f["bits"], f["override"], f["size"]
    size = _frame_size_bits(f["seq"], width, height)
    if bits[override] == "1":
        assert resilient, "a frame size from found_ref"
        return _with_header(f, bits[:at] + size + bits[at + len(size):])
    return _with_header(f, bits[:override] + "1" + bits[override + 1:at] +
                        ("" if resilient else "0" * 7) + size + bits[at:])


def short_signal_last_frame(stream: bytes) -> bytes:
    """Several frames' OBUs (``libaom_encode_frames``', no error
    resilience, no film grain) with the last frame's references
    short-signaled (frame_refs_short_signaling 1): its LAST and GOLDEN
    slots kept, the other five left to the decoder's set_frame_refs, which
    libaom's ``av1_set_frame_refs`` and the port's each work out from the
    slots' order hints."""
    _, _, info = port_grain_params(stream)
    gbit, hbytes = info[24:26]
    parts = obus(stream)
    seq = seq_fields([p for k, _, p in parts if k == 1][0])
    assert seq["hint_bits"], "no order hints"
    last = max(i for i, (k, _, _) in enumerate(parts) if k == 6)
    kind, head, payload = parts[last]
    bits = _bits(payload[:hbytes])[:gbit]
    assert bits[:5] == "00110", "not a shown inter frame"
    p = 6
    sct = seq["force_sct"]
    if sct == 2:
        sct = int(bits[p])
        p += 1
    if sct and seq["force_imv"] == 2:
        p += 1
    p += seq["id_bits"] + 1 + seq["hint_bits"] + 3 + 8
    assert bits[p] == "0", "short signaled already"
    idx = [bits[p + 1 + 3 * i:p + 4 + 3 * i] for i in range(7)]
    assert not seq["id_bits"], "frame ids"
    new = bits[:p] + "1" + idx[0] + idx[3] + bits[p + 22:]
    payload = _bytes(new) + payload[hbytes:]
    out = b"".join(parts[i][1] + _leb(len(parts[i][2])) + parts[i][2]
                   for i in range(last))
    return out + head + _leb(len(payload)) + payload


def hide_last_frame(stream: bytes) -> bytes:
    """Several frames' OBUs (``libaom_encode_frames``', no film grain)
    with the last frame, an inter frame, hidden (show_frame 0,
    showable_frame 1) and a frame header OBU after it whose
    show_existing_frame shows it, from the first slot its
    refresh_frame_flags names: libaom outputs that frame as the image."""
    _, _, info = port_grain_params(stream)
    gbit, hbytes = info[24:26]
    parts = obus(stream)
    seq = seq_fields([p for k, _, p in parts if k == 1][0])
    last = max(i for i, (k, _, _) in enumerate(parts) if k == 6)
    kind, head, payload = parts[last]
    bits = _bits(payload[:hbytes])[:gbit]
    assert bits[:4] == "0011", "not a shown inter frame"
    # after show_frame: error_resilient_mode, disable_cdf_update, the
    # screen content tools and integer MV choices, the frame id,
    # frame_size_override_flag, order_hint, primary_ref_frame
    p = 4
    er = bits[p] == "1"
    p += 2
    sct = seq["force_sct"]
    if sct == 2:
        sct = int(bits[p])
        p += 1
    if sct and seq["force_imv"] == 2:
        p += 1
    p += seq["id_bits"] + 1 + seq["hint_bits"] + (0 if er else 3)
    refresh = int(bits[p:p + 8], 2)
    assert refresh, "the last frame refreshes no slot"
    slot = next(i for i in range(8) if (refresh >> i) & 1)
    new = bits[:3] + "0" + "1" + bits[4:]
    payload = _bytes(new) + payload[hbytes:]
    show = "1" + format(slot, "03b") + "0" * seq["id_bits"]
    out = b"".join(parts[i][1] + _leb(len(parts[i][2])) + parts[i][2]
                   for i in range(last))
    out += head + _leb(len(payload)) + payload
    return out + obu(3, _bytes(show + "1"))


# ------------------------------------------------- inter prediction

_FILTER_PARAMS = None


def _filter_params(interp: int, n: int) -> int:
    """The address of libaom's InterpFilterParams of filter ``interp`` for
    a block side of n samples (av1_get_interp_filter_params_with_block_size:
    av1_interp_4tap at 4 or fewer, else av1_interp_filter_params_list)."""
    global _FILTER_PARAMS
    if _FILTER_PARAMS is None:
        libaom_function("aom_codec_version", ctypes.c_int)   # loads _AOM
        elf = Elf(_wheel_lib("libaom-*.so*"))
        base = _AOM[1]
        _FILTER_PARAMS = {k: base + elf.symbols[k][0] for k in (
            "av1_interp_4tap", "av1_interp_filter_params_list")}
    table = "av1_interp_4tap" if n <= 4 else "av1_interp_filter_params_list"
    return _FILTER_PARAMS[table] + 16 * interp


def libaom_convolve(src: np.ndarray, w: int, h: int, filter_x: int,
                    filter_y: int, subpel_x: int, subpel_y: int, depth: int,
                    kind: str = "2d") -> np.ndarray:
    """libaom's own single-reference convolution by symbol on a block:
    ``src`` (h + 7, w + 7) samples, the block at [3:-4, 3:-4]; ``kind``
    "2d" (av1_convolve_2d_sr_c, av1_highbd_convolve_2d_sr_c above 8 bits),
    "x" (av1_*convolve_x_sr_c: subpel_y must be 0) or "y"
    (av1_*convolve_y_sr_c: subpel_x must be 0); filters are InterpFilter,
    subpel positions in 1/16 → (h, w) uint16."""
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    s = np.ascontiguousarray(src.astype(dt))
    dst = np.zeros((h, w), dt)
    at = s.ctypes.data + (3 * s.shape[1] + 3) * s.itemsize
    # ConvolveParams: do_average, dst, dst_stride, round_0, round_1, plane,
    # is_compound, use_dist_wtd_comp_avg, fwd_offset, bck_offset
    round0 = 5 if depth == 12 else 3
    conv = struct.pack("<i4xQiiiiiiii", 0, 0, 0, round0, 14 - round0, 0, 0,
                       0, 0, 0)
    fx, fy = _filter_params(filter_x, w), _filter_params(filter_y, h)
    vp, i = ctypes.c_void_p, ctypes.c_int
    pre = "av1_highbd_convolve_" if hbd else "av1_convolve_"
    d = dst.ctypes.data
    if kind == "2d":
        args = [vp, i, vp, i, i, i, vp, vp, i, i, ctypes.c_char_p]
        call = [at, s.shape[1], d, w, w, h, fx, fy, subpel_x, subpel_y,
                conv]
    elif kind == "x":
        assert subpel_y == 0
        args = [vp, i, vp, i, i, i, vp, i, ctypes.c_char_p]
        call = [at, s.shape[1], d, w, w, h, fx, subpel_x, conv]
    else:
        assert subpel_x == 0
        args = [vp, i, vp, i, i, i, vp, i]
        call = [at, s.shape[1], d, w, w, h, fy, subpel_y]
    if hbd:
        args.append(i)
        call.append(depth)
    fn = libaom_function(f"{pre}{kind}_sr_c", None, *args)
    fn(*call)
    return dst.astype(np.uint16)


def port_convolve(src: np.ndarray, w: int, h: int, filter_x: int,
                  filter_y: int, subpel_x: int, subpel_y: int,
                  depth: int, compound: bool = False) -> np.ndarray:
    """The codec's inter predictor filter alone (``av1_inter_convolve``) on
    the block of ``libaom_convolve``'s ``src``: samples, or with
    ``compound`` a compound prediction's intermediate precision."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    s = np.ascontiguousarray(src.astype(np.uint16))
    dst = np.zeros((h, w), np.uint16)
    lib.av1_inter_convolve(s.ctypes.data + (3 * s.shape[1] + 3) * 2,
                           s.shape[1], dst.ctypes.data, w, w, h, filter_x,
                           filter_y, subpel_x, subpel_y, depth, int(compound))
    return dst


# ---------------------------------------------------- loop restoration

# libaom's radii of each self-guided set (av1_sgr_params: r0, r1)
SGR_RADII = [(2, 1)] * 10 + [(0, 1)] * 4 + [(2, 0)] * 2


def libaom_wiener(src: np.ndarray, taps, depth: int) -> np.ndarray:
    """libaom's own ``av1_wiener_convolve_add_src_c`` (8 bits) or
    ``av1_highbd_wiener_convolve_add_src_c`` by symbol on a block: ``src``
    (h + 7, w + 7) samples, the block at [3:-4, 3:-4] (the 8-tap filters
    read 3 before and 4 after it); ``taps`` the outer three taps of the
    vertical, then the horizontal filter → (h, w) uint16."""
    h, w = src.shape[0] - 7, src.shape[1] - 7
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    s = np.ascontiguousarray(src.astype(dt))
    dst = np.zeros((h, w), dt)
    kernels = []
    for t in taps:
        k = np.zeros(8, np.int16)
        k[0], k[1], k[2] = t
        k[6], k[5], k[4] = t
        k[3] = -2 * sum(t)
        kernels.append(k)
    round0 = 5 if depth == 12 else 3
    params = struct.pack("<ii", round0, 14 - round0)
    at = s.ctypes.data + (3 * s.shape[1] + 3) * s.itemsize
    vp, pd, i = ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_int
    if hbd:
        fn = libaom_function("av1_highbd_wiener_convolve_add_src_c", None, vp,
                             pd, vp, pd, vp, i, vp, i, i, i, ctypes.c_char_p,
                             i)
        fn(at >> 1, s.shape[1], dst.ctypes.data >> 1, w,
           kernels[1].ctypes.data, 16, kernels[0].ctypes.data, 16, w, h,
           params, depth)
    else:
        fn = libaom_function("av1_wiener_convolve_add_src_c", None, vp, pd,
                             vp, pd, vp, i, vp, i, i, i, ctypes.c_char_p)
        fn(at, s.shape[1], dst.ctypes.data, w, kernels[1].ctypes.data, 16,
           kernels[0].ctypes.data, 16, w, h, params)
    return dst.astype(np.uint16)


def libaom_selfguided(src: np.ndarray, sgr_set: int, xqd, depth: int
                      ) -> np.ndarray:
    """libaom's own ``av1_apply_selfguided_restoration_c`` by symbol on a
    block: ``src`` (h + 6, w + 6) samples, the block at [3:-3, 3:-3];
    ``xqd`` the unit's two coded weights → (h, w) uint16."""
    h, w = src.shape[0] - 6, src.shape[1] - 6
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    s = np.ascontiguousarray(src.astype(dt))
    dst = np.zeros((h, w), dt)
    tmp = np.zeros(1 << 20, np.int32)
    xq = (ctypes.c_int * 2)(*xqd)
    at = s.ctypes.data + (3 * s.shape[1] + 3) * s.itemsize
    vp, i = ctypes.c_void_p, ctypes.c_int
    fn = libaom_function("av1_apply_selfguided_restoration_c", i, vp, i, i,
                         i, i, vp, vp, i, vp, i, i)
    rc = fn(at >> 1 if hbd else at, w, h, s.shape[1], sgr_set, xq,
            dst.ctypes.data >> 1 if hbd else dst.ctypes.data, w,
            tmp.ctypes.data, depth, int(hbd))
    assert rc == 0
    return dst.astype(np.uint16)


def port_wiener(src: np.ndarray, taps, depth: int) -> np.ndarray:
    """The codec's Wiener filter alone (``av1_lr_wiener``) on the block of
    ``libaom_wiener``'s ``src``."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    h, w = src.shape[0] - 7, src.shape[1] - 7
    s = np.ascontiguousarray(src.astype(np.uint16))
    dst = np.zeros((h, w), np.uint16)
    t = np.asarray(taps, np.int8)
    lib.av1_lr_wiener(s.ctypes.data + (3 * s.shape[1] + 3) * 2, s.shape[1],
                      dst.ctypes.data, w, w, h, t.ctypes.data, depth)
    return dst


def port_selfguided(src: np.ndarray, sgr_set: int, xqd, depth: int
                    ) -> np.ndarray:
    """The codec's self-guided filter alone (``av1_lr_sgr``) on the block
    of ``libaom_selfguided``'s ``src``."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    h, w = src.shape[0] - 6, src.shape[1] - 6
    s = np.ascontiguousarray(src.astype(np.uint16))
    dst = np.zeros((h, w), np.uint16)
    x = np.asarray(xqd, np.int8)
    lib.av1_lr_sgr(s.ctypes.data + (3 * s.shape[1] + 3) * 2, s.shape[1],
                   dst.ctypes.data, w, w, h, sgr_set, x.ctypes.data, depth)
    return dst


# ------------------------------------------------------- colour stage


def libavif_encode(planes, depth: int, fmt: str, full: bool = True) -> bytes:
    """libavif 1.4.2's AVIF bytes (its encoder over libaom, at its default
    settings) of YUV planes given as they are (``fmt`` "444", "422", "420"
    or "400"; chroma planes at their own size; any depth libavif takes):
    the writer of 10- and 12-bit 4:2:2 and 4:4:4 colour and of 4:0:0
    alpha frames, full or limited range, that no writer here exposes.
    The nclx it writes says matrix 2 (unspecified)."""
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
    lib.avifEncoderCreate.restype = vp
    lib.avifEncoderWrite.argtypes = [vp, vp, vp]
    lib.avifEncoderDestroy.argtypes = [vp]
    lib.avifRWDataFree.argtypes = [vp]
    h, w = planes[0].shape
    fmt_code = {"444": 1, "422": 2, "420": 3, "400": 4}[fmt]
    img = lib.avifImageCreate(w, h, depth, fmt_code)
    # avifImage: width, height, depth, yuvFormat, yuvRange, ...
    ctypes.c_uint32.from_address(img + 16).value = 1 if full else 0
    lib.avifImageAllocatePlanes(img, 1)          # AVIF_PLANES_YUV
    ptrs = struct.unpack("QQQ", ctypes.string_at(img + 24, 24))
    rows = struct.unpack("III", ctypes.string_at(img + 48, 12))
    dtype = np.uint16 if depth > 8 else np.uint8
    for p, plane in enumerate(planes):
        ph = plane.shape[0]
        dst = np.ctypeslib.as_array((ctypes.c_uint8 * (rows[p] * ph))
                                    .from_address(ptrs[p])).reshape(ph, -1)
        row = np.ascontiguousarray(plane.astype(dtype)).view(np.uint8)
        dst[:, :row.shape[1]] = row
    enc = lib.avifEncoderCreate()
    out = ctypes.create_string_buffer(16)        # avifRWData
    res = lib.avifEncoderWrite(enc, img, ctypes.addressof(out))
    lib.avifEncoderDestroy(enc)
    lib.avifImageDestroy(img)
    assert res == 0, f"libavif's encoder failed ({res})"
    ptr, n = struct.unpack("QQ", out.raw)
    data = ctypes.string_at(ptr, n)
    lib.avifRWDataFree(ctypes.addressof(out))
    return data


def libavif_bgra(data: bytes, premultiplied: bool = False,
                 avoid_libyuv: bool = False) -> np.ndarray:
    """(H, W, 4) uint8 BGRA as libavif 1.4.2 converts the file's image for
    cv2 (``avifRGBImageSetDefaults``, 8 bits, BGRA: OpenCV's request for an
    image with alpha), through libyuv unless ``avoid_libyuv``; with
    ``premultiplied`` the RGB image is asked premultiplied (a premultiplied
    file's colour then left as coded)."""
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
    lib.avifImageYUVToRGB.argtypes = [vp, vp]
    dec = lib.avifDecoderCreate()
    img = lib.avifImageCreateEmpty()
    try:
        res = lib.avifDecoderReadMemory(dec, img, data, len(data))
        if res != 0:
            raise ValueError(f"libavif refuses the file ({res})")
        # avifRGBImage: width, height, depth, format, chromaUpsampling,
        # chromaDownsampling, avoidLibYUV, ignoreAlpha, alphaPremultiplied,
        # isFloat, maxThreads, pixels, rowBytes
        rgb = ctypes.create_string_buffer(128)
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), img)
        f = list(struct.unpack_from("11i", rgb.raw, 0))
        w, h = f[0], f[1]
        f[2], f[3], f[6], f[8] = 8, 4, int(avoid_libyuv), int(premultiplied)
        buf = np.zeros((h, w, 4), np.uint8)
        struct.pack_into("11i", rgb, 0, *f)
        struct.pack_into("QI", rgb, 48, buf.ctypes.data, w * 4)
        res = lib.avifImageYUVToRGB(img, ctypes.addressof(rgb))
        if res != 0:
            raise ValueError(f"libavif's conversion fails ({res})")
        return buf
    finally:
        lib.avifImageDestroy(img)
        lib.avifDecoderDestroy(dec)


_AVIF_ELF = None


def _avif_elf() -> Elf:
    global _AVIF_ELF
    if _AVIF_ELF is None:
        _AVIF_ELF = Elf(_wheel_lib("libavif-*.so*"))
    return _AVIF_ELF


def libavif_symbol(name: str) -> int:
    """The address of a function or table of the libavif that cv2's wheel
    bundles, found by its ELF symbol (libyuv 1924 is linked into it:
    ``ARGBUnattenuate``, ``I010AlphaToARGBMatrixFilter``,
    ``kYuvI601Constants``, ``fixed_invtbl8``, ...)."""
    elf = _avif_elf()
    base = ctypes.cast(_libavif().avifVersion, ctypes.c_void_p).value - \
        elf.functions["avifVersion"][0]
    return base + (elf.functions.get(name) or elf.symbols[name])[0]


def libavif_table(name: str, dtype, shape) -> np.ndarray:
    """A constant table of cv2's libavif by its ELF symbol."""
    return _avif_elf().table(name, dtype, shape)


def nclx(primaries: int, transfer: int, matrix: int, full: bool) -> bytes:
    """A ``colr`` box of colour type nclx."""
    return box(b"colr", b"nclx" + struct.pack(">HHHB", primaries, transfer,
                                              matrix, 0x80 if full else 0))


ICC_PROFILE = None


def icc_profile() -> bytes:
    """Pillow's sRGB ICC profile (ImageCms), the one a photo's EXIF-tagged
    JPEG carries into Pillow's ``info``."""
    global ICC_PROFILE
    if ICC_PROFILE is None:
        from PIL import ImageCms
        ICC_PROFILE = ImageCms.ImageCmsProfile(
            ImageCms.createProfile("sRGB")).tobytes()
    return ICC_PROFILE


def orientation_exif(value: int):
    """A Pillow Exif of one orientation tag, which Pillow's AVIF writer
    turns into an ``irot`` (3, 6) or ``imir`` (2) and drops."""
    from PIL import Image
    exif = Image.Exif()
    exif[0x0112] = value
    return exif


def with_colr(data: bytes, colrs) -> bytes:
    """A one-item file (cv2's or Pillow's RGB) written again with its colr
    boxes replaced by ``colrs`` (whole boxes, in order)."""
    obu, _ = item_parts(data)
    props = [(b, e) for b, e in item_props(data, 1) if b[4:8] != b"colr"]
    return build_items([(1, b"av01", obu, props + [(c, False)
                                                   for c in colrs])], [])


ALPHA_AUXC = full_box(b"auxC", 0, 0,
                      b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha\0")


def alpha_file(colour: bytes, alpha: bytes, prem: bool,
               extra_colour=(), extra_alpha=()) -> bytes:
    """An RGBA file of two one-item files' OBUs: ``colour``'s item with its
    properties (and ``extra_colour``), ``alpha``'s as its alpha item (its
    colr dropped, an alpha auxC added; and ``extra_alpha``), a ``prem``
    reference from the colour to the alpha where ``prem``."""
    cobu, _ = item_parts(colour)
    aobu, _ = item_parts(alpha)
    cprops = item_props(colour, 1) + list(extra_colour)
    aprops = [(b, e) for b, e in item_props(alpha, 1)
              if b[4:8] != b"colr"] + [(ALPHA_AUXC, False)] + \
        list(extra_alpha)
    refs = [(b"auxl", 2, [1])] + ([(b"prem", 1, [2])] if prem else [])
    return build_items([(1, b"av01", cobu, cprops),
                        (2, b"av01", aobu, aprops)], refs)


# ------------------------------------------- libaom's encoder, by hand

_AOM_ENC = None
# AV1E_SET_* control ids of libaom 3.14.1 (aomcx.h), which the library's
# encoder_ctrl_maps pairs with its ctrl_set_* functions
AOM_CONTROLS = {"cpu-used": 13, "cq-level": 25, "tile-columns": 33,
                "tile-rows": 34, "color-range": 52, "enable-cdef": 58,
                "enable-restoration": 59, "enable-superres": 102,
                "deltaq-mode": 107, "deltalf-mode": 108}


def _aom_encoder():
    global _AOM_ENC
    if _AOM_ENC is None:
        lib = ctypes.CDLL(_wheel_lib("libaom-*.so*"))
        lib.aom_codec_av1_cx.restype = ctypes.c_void_p
        lib.aom_codec_get_cx_data.restype = ctypes.c_void_p
        lib.aom_codec_error_detail.restype = ctypes.c_char_p
        lib.aom_img_alloc.restype = ctypes.c_void_p
        lib.aom_img_free.argtypes = [ctypes.c_void_p]
        lib.aom_codec_set_option.argtypes = [ctypes.c_void_p,
                                             ctypes.c_char_p, ctypes.c_char_p]
        _AOM_ENC = lib
    return _AOM_ENC


def aom_control_ids() -> dict:
    """{ctrl_set_* function name: control id} read out of the loaded
    libaom's ``encoder_ctrl_maps`` (the check behind ``AOM_CONTROLS``)."""
    libaom_function("aom_codec_version", ctypes.c_int)   # loads _AOM
    _, base, syms = _AOM
    names = {base + v: k for k, v in syms.items() if k.startswith("ctrl_")}
    elf = Elf(_wheel_lib("libaom-*.so*"))
    tab = base + elf.symbols["encoder_ctrl_maps"][0]
    out = {}
    for i in range(1024):
        cid, fn = struct.unpack("<i4xQ", ctypes.string_at(tab + 16 * i, 16))
        if cid == -1 or fn == 0:
            break
        out[names.get(fn, hex(fn))] = cid
    return out


# the controls of the inter tools (aomcx.h's AV1E_SET_*), each the id the
# library's encoder_ctrl_maps pairs with ctrl_set_<name with underscores>
AOM_INTER_CONTROLS = {
    "enable-obmc": 61, "enable-warped-motion": 96, "enable-global-motion": 95,
    "enable-ref-frame-mvs": 84, "enable-onesided-comp": 89,
    "enable-masked-comp": 88, "enable-dist-wtd-comp": 83,
    "enable-diff-wtd-comp": 92, "enable-interintra-comp": 90,
    "enable-interinter-wedge": 93, "enable-interintra-wedge": 94,
    "enable-smooth-interintra": 91, "enable-dual-filter": 86,
    "enable-reduced-reference-set": 125, "max-reference-frames": 124,
    "superblock-size": 56, "aq-mode": 40, "film-grain-test-vector": 112,
    "error-resilient-mode": 38}
# libaom's inter tools switched off (each is on by default): its
# good-quality encoder then writes single-reference inter frames with
# neither motion-field projection nor warped, global, OBMC or inter-intra
# prediction
INTER_TOOLS_OFF = {
    "enable-obmc": 0, "enable-warped-motion": 0, "enable-global-motion": 0,
    "enable-ref-frame-mvs": 0, "enable-onesided-comp": 0,
    "enable-masked-comp": 0, "enable-dist-wtd-comp": 0,
    "enable-diff-wtd-comp": 0, "enable-interintra-comp": 0,
    "enable-interinter-wedge": 0, "enable-interintra-wedge": 0,
    "enable-smooth-interintra": 0}
# aom_enc_frame_flags_t (aomcx.h): a frame coded error resilient
AOM_EFLAG_ERROR_RESILIENT = 1 << 28
# the controls of compound prediction (and so skip mode) among them
COMPOUND_TOOLS = ("enable-onesided-comp", "enable-masked-comp",
                  "enable-dist-wtd-comp", "enable-diff-wtd-comp",
                  "enable-interinter-wedge")


def libaom_encode(planes, depth: int, subx: int, suby: int, *,
                  usage: int = 2, superres=None, controls=None) -> bytes:
    """One frame's OBUs (a temporal unit: temporal delimiter, sequence
    header, frame) from libaom 3.14.1's own encoder (``aom_codec_av1_cx``,
    the library cv2's wheel bundles) driven here through its C API, with
    the options ``avifenc -a`` passes and Pillow's ``advanced`` refuses:
    ``superres`` = (mode, denominator, key-frame denominator) sets the
    config's ``rc_superres_*`` fields (mode 1 fixed, 2 random, 3 by q, 4
    auto); ``controls`` {name of ``AOM_CONTROLS``: int} (``deltaq-mode``,
    ``deltalf-mode``, ``cq-level``, ...).  ``usage`` 2 is all-intra (what
    libavif takes for a still image), 0 good quality (its sequences).
    planes: [Y, U, V] at their own sizes, any depth 8/10/12."""
    return libaom_encode_frames([planes], depth, subx, suby, usage=usage,
                                superres=superres, controls=controls)


def libaom_encode_frames(frames, depth: int, subx: int, suby: int, *,
                         usage: int = 0, superres=None, resize=None,
                         sframe_dist: int = 0, flags=None, mono=False,
                         lag: int = 0, controls=None) -> bytes:
    """``libaom_encode`` of several frames (each [Y, U, V]) with ``lag``
    frames of lookahead (0: none; libaom's own default, 35, lets it code a
    later frame first as a hidden ALTREF, a backward reference): their
    temporal units one after another, the first a key frame, the others
    (usage 0, good quality) inter frames; ``controls`` may also name
    ``AOM_INTER_CONTROLS`` (``INTER_TOOLS_OFF`` switches every inter
    tool off); ``resize`` = (mode, denominator,
    key-frame denominator) sets ``rc_resize_*`` (frames coded at another
    size than their references), ``sframe_dist`` the distance of switch
    frames, ``flags`` {frame index: its aom_enc_frame_flags_t}; ``mono``
    codes the luma alone (4:0:0; each frame may be [Y])."""
    lib = _aom_encoder()
    iface = ctypes.c_void_p(lib.aom_codec_av1_cx())
    h, w = frames[0][0].shape
    cfg = ctypes.create_string_buffer(4096)
    assert lib.aom_codec_enc_config_default(iface, cfg, usage) == 0
    # aom_codec_enc_cfg_t: g_usage, g_threads, g_profile, g_w, g_h,
    # g_limit, forced max w/h, g_bit_depth, g_input_bit_depth, timebase,
    # error resilient, pass, lag, dropframe, resize mode/den/kf den,
    # superres mode/den/kf den/qthresh/kf qthresh, rc_end_usage
    f = list(struct.unpack_from("<25I", cfg.raw, 0))
    f[2] = 2 if depth == 12 or (subx and not suby) else 1 if not subx else 0
    f[3], f[4], f[5] = w, h, len(frames)
    f[8] = f[9] = depth
    f[14] = lag
    if superres is not None:
        f[19], f[20], f[21] = superres
    if resize is not None:
        f[16], f[17], f[18] = resize
    f[24] = 3                                   # AOM_Q
    struct.pack_into("<25I", cfg, 0, *f)
    # kf_mode, kf_min_dist, kf_max_dist, sframe_dist, sframe_mode (1 by
    # default), large_scale_tile, monochrome
    assert struct.unpack_from("<I", cfg.raw, 4 * 50)[0] == 1
    struct.pack_into("<I", cfg, 4 * 49, sframe_dist)
    struct.pack_into("<I", cfg, 4 * 52, int(mono))
    ctx = ctypes.create_string_buffer(256)
    hbd = depth > 8
    res = lib.aom_codec_enc_init_ver(ctx, iface, cfg,
                                     0x40000 if hbd else 0, 25)
    assert res == 0, f"aom_codec_enc_init_ver: {res}"
    img = None
    try:
        for name, value in {"cq-level": 30, **(controls or {})}.items():
            cid = AOM_CONTROLS.get(name) or AOM_INTER_CONTROLS[name]
            res = lib.aom_codec_control(ctx, cid, ctypes.c_int(value))
            assert res == 0, f"{name}: {lib.aom_codec_error_detail(ctx)}"
        fmt = {(1, 1): 0x102, (1, 0): 0x105, (0, 0): 0x106}[(subx, suby)]
        img = lib.aom_img_alloc(None, fmt | (0x800 if hbd else 0), w, h, 16)
        ptrs = struct.unpack("<3Q", ctypes.string_at(img + 64, 24))
        strides = struct.unpack("<3i", ctypes.string_at(img + 88, 12))
        out = b""
        # the frames, then flushes (None) until the lookahead is drained
        flushes = 1 + min(lag, len(frames))
        for pts, planes in enumerate(list(frames) + [None] * flushes):
            if planes is not None:
                if mono:
                    c = np.full(((h + suby) >> suby, (w + subx) >> subx),
                                128 << (depth - 8))
                    planes = [planes[0], c, c]
                for p, a in enumerate(planes):
                    a = np.ascontiguousarray(
                        a.astype(np.uint16 if hbd else np.uint8))
                    for r in range(a.shape[0]):
                        ctypes.memmove(ptrs[p] + r * strides[p],
                                       a[r].ctypes.data, a[r].nbytes)
            frame = None if planes is None else ctypes.c_void_p(img)
            flag = (flags or {}).get(pts, 0) if planes is not None else 0
            res = lib.aom_codec_encode(ctx, frame, ctypes.c_int64(pts),
                                       ctypes.c_ulong(1), ctypes.c_long(flag))
            assert res == 0, lib.aom_codec_error_detail(ctx)
            it = ctypes.c_void_p(0)
            while True:
                pkt = lib.aom_codec_get_cx_data(ctx, ctypes.byref(it))
                if not pkt:
                    break
                if struct.unpack("<i", ctypes.string_at(pkt, 4))[0] == 0:
                    buf, n = struct.unpack("<QQ", ctypes.string_at(pkt + 8,
                                                                   16))
                    out += ctypes.string_at(buf, n)
        return out
    finally:
        if img:
            lib.aom_img_free(img)
        lib.aom_codec_destroy(ctx)


def av1c_box(depth: int, subx: int, suby: int, mono: bool = False,
             profile=None) -> bytes:
    """An av1C box (no config OBUs) of a stream's sequence header fields."""
    if profile is None:
        profile = 2 if depth == 12 or (subx and not suby) else \
            1 if not subx and not mono else 0
    return box(b"av1C", bytes([
        0x81, profile << 5, (int(depth > 8) << 6) | (int(depth == 12) << 5) |
        (int(mono) << 4) | (subx << 3) | (suby << 2), 0]))


def pixi_box(depth: int, channels: int = 3) -> bytes:
    return full_box(b"pixi", 0, 0, bytes([channels] + [depth] * channels))


def encoded_avif(planes, depth: int, subx: int, suby: int, *,
                 colr=None, **kw) -> bytes:
    """``libaom_encode``'s frame as a one-item AVIF (``build_avif``): ispe
    of the planes' size, pixi, av1C and an nclx (BT.601 full range unless
    ``colr``)."""
    h, w = planes[0].shape
    stream = libaom_encode(planes, depth, subx, suby, **kw)
    props = {b"ispe": ispe_box(w, h), b"pixi": pixi_box(depth),
             b"av1C": av1c_box(depth, subx, suby),
             b"colr": colr or nclx(1, 13, 6, True)}
    return build_avif(stream, props)


# ------------------------------------- libavif's own colour and scaling

# avifPixelFormat of 4:4:4, 4:2:2, 4:2:0 (subsampling x, y)
_FMT_CODE = {(0, 0): 1, (1, 0): 2, (1, 1): 3}


def libavif_image(planes, depth: int, subx: int = 1, suby: int = 1, *,
                  matrix: int = 6, primaries: int = 1, full: bool = True,
                  alpha=None, premultiplied: bool = False) -> int:
    """An avifImage (libavif 1.4.2's layout: width, height, depth,
    yuvFormat, yuvRange, ...; yuvPlanes at 24, yuvRowBytes at 48,
    alphaPlane at 64, alphaRowBytes at 72, alphaPremultiplied at 80,
    colorPrimaries, transfer and matrixCoefficients at 104) holding the
    given planes ([Y] alone: 4:0:0), with an alpha plane where ``alpha``
    is given.  Free it with ``_libavif().avifImageDestroy``."""
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifImageCreate.restype = vp
    lib.avifImageCreate.argtypes = [ctypes.c_uint32] * 3 + [ctypes.c_int]
    lib.avifImageAllocatePlanes.argtypes = [vp, ctypes.c_int]
    h, w = planes[0].shape
    fmt = 4 if len(planes) == 1 else _FMT_CODE[(subx, suby)]
    img = lib.avifImageCreate(w, h, depth, fmt)
    ctypes.c_uint32.from_address(img + 16).value = 1 if full else 0
    struct.pack_into("<3H", (ctypes.c_char * 6).from_address(img + 104), 0,
                     primaries, 13, matrix)
    lib.avifImageAllocatePlanes(img, 1 | (2 if alpha is not None else 0))
    dtype = np.uint16 if depth > 8 else np.uint8
    ptrs = struct.unpack("<3Q", ctypes.string_at(img + 24, 24))
    rows = struct.unpack("<3I", ctypes.string_at(img + 48, 12))
    fill = [(ptrs[p], rows[p], a) for p, a in enumerate(planes)]
    if alpha is not None:
        aptr, arow = struct.unpack("<QI", ctypes.string_at(img + 64, 12))
        fill.append((aptr, arow, alpha))
        ctypes.c_int.from_address(img + 80).value = int(premultiplied)
    for ptr, row, a in fill:
        ph = a.shape[0]
        dst = np.ctypeslib.as_array((ctypes.c_uint8 * (row * ph))
                                    .from_address(ptr)).reshape(ph, -1)
        src = np.ascontiguousarray(a.astype(dtype)).view(np.uint8)
        dst[:, :src.shape[1]] = src
    return img


def _image_planes(img: int):
    """([Y, U, V] or [Y], alpha or None) read back out of an avifImage."""
    w, h, depth, fmt = struct.unpack("<4I", ctypes.string_at(img, 16))
    ptrs = struct.unpack("<3Q", ctypes.string_at(img + 24, 24))
    rows = struct.unpack("<3I", ctypes.string_at(img + 48, 12))
    aptr, arow = struct.unpack("<QI", ctypes.string_at(img + 64, 12))
    sub = {1: (0, 0), 2: (1, 0), 3: (1, 1), 4: (1, 1)}[fmt]
    nb = 2 if depth > 8 else 1

    def plane(ptr, row, pw, ph):
        raw = np.frombuffer(ctypes.string_at(ptr, row * ph), np.uint8)
        raw = raw.reshape(ph, row)[:, :pw * nb].copy()
        return (raw.view("<u2") if nb == 2 else raw).astype(np.uint16)
    out = []
    for p in range(1 if fmt == 4 else 3):
        sx, sy = sub if p else (0, 0)
        out.append(plane(ptrs[p], rows[p], (w + sx) >> sx, (h + sy) >> sy))
    return out, (plane(aptr, arow, w, h) if aptr else None)


def libavif_yuv_to_rgb(planes, depth: int, subx: int = 1, suby: int = 1,
                       *, channels: int = 3, avoid_libyuv: bool = False,
                       **kw) -> np.ndarray:
    """(H, W, channels) uint8 BGR(A) as libavif 1.4.2's
    ``avifImageYUVToRGB`` converts the given planes for cv2 (8-bit BGR, or
    BGRA for an image with alpha; the chroma upsampling left automatic);
    ``kw`` as ``libavif_image``'s.  Raises ValueError where it fails."""
    lib = _libavif()
    vp = ctypes.c_void_p
    lib.avifRGBImageSetDefaults.argtypes = [vp, vp]
    lib.avifImageYUVToRGB.argtypes = [vp, vp]
    img = libavif_image(planes, depth, subx, suby, **kw)
    try:
        h, w = planes[0].shape
        rgb = ctypes.create_string_buffer(128)
        lib.avifRGBImageSetDefaults(ctypes.addressof(rgb), img)
        f = list(struct.unpack_from("11i", rgb.raw, 0))
        f[2], f[3], f[6] = 8, 4 if channels == 4 else 3, int(avoid_libyuv)
        buf = np.zeros((h, w, channels), np.uint8)
        struct.pack_into("11i", rgb, 0, *f)
        struct.pack_into("QI", rgb, 48, buf.ctypes.data, w * channels)
        res = lib.avifImageYUVToRGB(img, ctypes.addressof(rgb))
        if res != 0:
            raise ValueError(f"libavif's conversion fails ({res})")
        return buf
    finally:
        lib.avifImageDestroy(img)


def libavif_coefficients(matrix: int, primaries: int):
    """(kr, kg, kb) as libavif's own ``avifCalcYUVCoefficients`` (a local
    symbol) computes them for an image of these codes."""
    img = libavif_image([np.zeros((2, 2), np.uint16)] * 3, 8, 0, 0,
                        matrix=matrix, primaries=primaries)
    try:
        out = (ctypes.c_float * 3)()
        fn = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_void_p)(
            libavif_symbol("avifCalcYUVCoefficients"))
        fn(img, ctypes.addressof(out), ctypes.addressof(out) + 4,
           ctypes.addressof(out) + 8)
        return np.array(out[:], np.float32)
    finally:
        _libavif().avifImageDestroy(img)


def libavif_tables():
    """libavif's avifColorPrimariesTables ({code: 8 float32 chromaticities})
    and matrixCoefficientsTables ({code: (kr, kb)}), read by symbol."""
    elf = _avif_elf()
    n = int(elf.table("avifColorPrimariesTableSize", "<i4", (1,))[0])
    m = int(elf.table("avifMatrixCoefficientsTableSize", "<i4", (1,))[0])
    raw = elf.table("avifColorPrimariesTables", "u1", (48 * n,)).tobytes()
    prim = {struct.unpack_from("<H", raw, 48 * i)[0]:
            np.frombuffer(raw, "<f4", 8, 48 * i + 16) for i in range(n)}
    raw = elf.table("matrixCoefficientsTables", "u1", (24 * m,)).tobytes()
    mat = {struct.unpack_from("<H", raw, 24 * i)[0]:
           tuple(np.frombuffer(raw, "<f4", 2, 24 * i + 16))
           for i in range(m)}
    return prim, mat


def libavif_scale(planes, depth: int, subx: int, suby: int, width: int,
                  height: int, alpha=None):
    """libavif 1.4.2's ``avifImageScale`` (libyuv's ScalePlane,
    ScalePlane_12 or ScalePlane_16, box filter) of the planes (and alpha)
    to width x height → (planes, alpha); raises ValueError where it
    fails."""
    lib = _libavif()
    lib.avifImageScale.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                   ctypes.c_uint32, ctypes.c_void_p]
    img = libavif_image(planes, depth, subx, suby, alpha=alpha)
    try:
        diag = ctypes.create_string_buffer(1024)
        res = lib.avifImageScale(img, width, height, ctypes.addressof(diag))
        if res != 0:
            raise ValueError(f"avifImageScale fails ({res})")
        return _image_planes(img)
    finally:
        lib.avifImageDestroy(img)


def libyuv_scale_plane(plane: np.ndarray, width: int, height: int,
                       bits: int = 8, filtering: int = 3) -> np.ndarray:
    """libyuv 1924's ``ScalePlane`` (bits 8), ``ScalePlane_12`` or
    ``ScalePlane_16`` (uint16 samples) by symbol, filter mode 3 (box)
    unless given."""
    name = {8: "ScalePlane", 12: "ScalePlane_12", 16: "ScalePlane_16"}[bits]
    fn = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int)(libavif_symbol(name))
    dtype = np.uint8 if bits == 8 else np.uint16
    src = np.ascontiguousarray(plane.astype(dtype))
    dst = np.zeros((height, width), dtype)
    fn(src.ctypes.data, src.shape[1], src.shape[1], src.shape[0],
       dst.ctypes.data, width, width, height, filtering)
    return dst


# --------------------------------------- superres and delta LF by symbol


def libaom_upscale_rows(src: np.ndarray, width: int, upscaled: int,
                        denom: int, ss_x: int, depth: int, hbd: bool = True,
                        tile_sbs=None, sb_log2: int = 4) -> np.ndarray:
    """libaom's own ``av1_upscale_normative_rows`` (by symbol) on the rows
    of a plane: ``src`` holds the plane's coded samples up to its 8-aligned
    coded width, ``width`` and ``upscaled`` are the frame's luma widths,
    ``tile_sbs`` the tile columns' widths in superblocks (one column by
    default).  AV1_COMMON and SequenceHeader are laid out as libaom 3.14.1
    reads them there (width at 0x38, superres_upscaled_width 0x48, the
    denominator 0x50, mi_cols 0x218, seq_params 0x6088, tiles.cols 0x60a0,
    tiles.col_start_sb 0x60dc; mib_size_log2 0x24, bit_depth 0x48,
    use_highbitdepth 0x4c, subsampling_x 0x60): rows of ``upscaled``
    samples (its plane's)."""
    mi_cols = 2 * ((width + 7) >> 3)
    sb_cols = (mi_cols + (1 << sb_log2) - 1) >> sb_log2
    tile_sbs = tile_sbs or [sb_cols]
    assert sum(tile_sbs) == sb_cols
    cm = ctypes.create_string_buffer(0x7000)
    seq = ctypes.create_string_buffer(0x100)
    struct.pack_into("<i", cm, 0x38, width)
    struct.pack_into("<i", cm, 0x48, upscaled)
    struct.pack_into("<B", cm, 0x50, denom)
    struct.pack_into("<i", cm, 0x218, mi_cols)
    struct.pack_into("<Q", cm, 0x6088, ctypes.addressof(seq))
    struct.pack_into("<i", cm, 0x60a0, len(tile_sbs))
    starts = np.concatenate([[0], np.cumsum(tile_sbs)]).astype(np.int32)
    struct.pack_into(f"<{len(starts)}i", cm, 0x60dc, *starts)
    struct.pack_into("<i", seq, 0x24, sb_log2)
    struct.pack_into("<I", seq, 0x48, depth)
    struct.pack_into("<B", seq, 0x4c, int(hbd))
    struct.pack_into("<i", seq, 0x60, ss_x)
    rows, aligned = src.shape
    uw = (upscaled + ss_x) >> ss_x
    pad = 16
    dt = np.uint16 if hbd else np.uint8
    buf = np.zeros((rows, aligned + 2 * pad), dt)
    buf[:, pad:pad + aligned] = src
    dst = np.zeros((rows, uw + 2 * pad), dt)
    sp = buf.ctypes.data + pad * buf.itemsize
    dp = dst.ctypes.data + pad * dst.itemsize
    if hbd:             # libaom's CONVERT_TO_BYTEPTR
        sp, dp = sp >> 1, dp >> 1
    libaom_function("av1_rtcd", None)()     # its run-time CPU dispatch
    fn = libaom_function("av1_upscale_normative_rows", None, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int)
    fn(ctypes.addressof(cm), sp, buf.shape[1], dp, dst.shape[1],
       1 if ss_x else 0, rows)
    return dst[:, pad:pad + uw].astype(np.uint16)


def libaom_delta_lf(data: bytes, n: int, disable_update: bool = False):
    """n reduced delta loop filter levels as libaom's own
    ``read_delta_lflevel`` reads them (its ``.part.0``: the reader and the
    CDF; by symbol), from an ``aom_reader_init`` reader over data with one
    CDF at its default (``AOM_CDF4(28160, 32120, 32677)``, inverse form),
    adapting unless ``disable_update``."""
    reader = ctypes.create_string_buffer(256)
    init = libaom_function("aom_reader_init", ctypes.c_int, ctypes.c_void_p,
                           ctypes.c_char_p, ctypes.c_size_t)
    assert init(ctypes.addressof(reader), data, len(data)) == 0
    reader[0x38] = 0 if disable_update else 1     # allow_update_cdf
    cdf = (ctypes.c_uint16 * 5)(32768 - 28160, 32768 - 32120, 32768 - 32677,
                                0, 0)
    fn = libaom_function("read_delta_lflevel.part.0", ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_void_p)
    return [fn(ctypes.addressof(reader), ctypes.addressof(cdf))
            for _ in range(n)]


# ----------------------------------------------- the inter tools, by symbol

_VP, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _aom_address(name: str) -> int:
    """The loaded libaom's address of an object symbol."""
    libaom_function("aom_codec_version", ctypes.c_int)   # loads _AOM
    return _AOM[1] + Elf(_wheel_lib("libaom-*.so*")).symbols[name][0]


@functools.lru_cache(maxsize=None)
def _aom_init_tables():
    """libaom's run-time CPU dispatch and its wedge and inter-intra masks
    (av1_init_wedge_masks), as its decoder sets them up (once)."""
    for fn in ("aom_dsp_rtcd", "av1_rtcd", "av1_init_wedge_masks"):
        libaom_function(fn, None)()


def _hbd(a: np.ndarray) -> int:
    """libaom's CONVERT_TO_BYTEPTR of a uint16 array."""
    return a.ctypes.data >> 1


def _warp_params(mat, wmtype: int = 3) -> ctypes.Array:
    """libaom's WarpedMotionParams: wmmat[6], alpha, beta, gamma, delta,
    wmtype, invalid (36 bytes)."""
    buf = ctypes.create_string_buffer(36)
    struct.pack_into("<6i4hbb", buf, 0, *[int(v) for v in mat], 0, 0, 0, 0,
                     wmtype, 0)
    return buf


def _warp_out(buf):
    v = struct.unpack_from("<6i4h", buf.raw, 0)
    return list(v[:6]), list(v[6:10])


def libaom_shear(mat):
    """av1_get_shear_params on a model: (valid, mat, [alpha, beta, gamma,
    delta])."""
    buf = _warp_params(mat)
    ok = libaom_function("av1_get_shear_params", _I, _VP)(buf)
    return (ok,) + _warp_out(buf)


def port_shear(mat):
    lib = _port()
    m = np.array(mat, np.int32)
    sh = np.zeros(4, np.int16)
    ok = lib.av1_shear(m.ctypes.data, sh.ctypes.data)
    return ok, m.tolist(), sh.tolist()


# libaom's BLOCK_SIZE of a block's (width, height) in pixels
BLOCK_SIZES = [(4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16),
               (16, 32), (32, 16), (32, 32), (32, 64), (64, 32), (64, 64),
               (64, 128), (128, 64), (128, 128), (4, 16), (16, 4), (8, 32),
               (32, 8), (16, 64), (64, 16)]


def libaom_projection(pts, pts_ref, bsize: int, mvy: int, mvx: int,
                      mi_row: int, mi_col: int):
    """av1_find_projection: (valid, mat, shear) of n samples."""
    n = len(pts) // 2
    p1 = (ctypes.c_int * 16)(*pts)
    p2 = (ctypes.c_int * 16)(*pts_ref)
    buf = _warp_params([0, 0, 1 << 16, 0, 0, 1 << 16])
    fail = libaom_function("av1_find_projection", _I, _I, _VP, _VP, _I, _I,
                           _I, _VP, _I, _I)(n, p1, p2, bsize, mvy, mvx, buf,
                                            mi_row, mi_col)
    return (int(not fail),) + _warp_out(buf)


def port_projection(pts, pts_ref, bsize: int, mvy: int, mvx: int,
                    mi_row: int, mi_col: int):
    lib = _port()
    w, h = BLOCK_SIZES[bsize]
    p1 = np.array(pts, np.int32)
    p2 = np.array(pts_ref, np.int32)
    m = np.zeros(6, np.int32)
    sh = np.zeros(4, np.int16)
    ok = lib.av1_projection(len(pts) // 2, p1.ctypes.data, p2.ctypes.data,
                            w, h, mvy, mvx, mi_row, mi_col, m.ctypes.data,
                            sh.ctypes.data)
    return ok, m.tolist(), sh.tolist()


def libaom_select_samples(mv_row: int, mv_col: int, pts, pts_ref,
                          bsize: int):
    """av1_selectSamples: (count, the samples kept)."""
    n = len(pts) // 2
    mv = struct.pack("<hh", mv_row, mv_col)
    p1 = (ctypes.c_int * 16)(*pts)
    p2 = (ctypes.c_int * 16)(*pts_ref)
    k = libaom_function("av1_selectSamples", ctypes.c_uint8, ctypes.c_char_p,
                        _VP, _VP, _I, _I)(mv, p1, p2, n, bsize)
    return k, list(p1)[:2 * k], list(p2)[:2 * k]


def port_select_samples(mv_row: int, mv_col: int, pts, pts_ref,
                        bsize: int):
    lib = _port()
    w, h = BLOCK_SIZES[bsize]
    p1 = np.zeros(16, np.int32)
    p2 = np.zeros(16, np.int32)
    p1[:len(pts)], p2[:len(pts_ref)] = pts, pts_ref
    k = lib.av1_select_samples(mv_row, mv_col, p1.ctypes.data,
                               p2.ctypes.data, len(pts) // 2, w, h)
    return k, p1[:2 * k].tolist(), p2[:2 * k].tolist()


def libaom_mv_projection(row: int, col: int, num: int, den: int):
    """av1_get_mv_projection (its MV by value: row, col in one word)."""
    out = ctypes.create_string_buffer(4)
    ref = (row & 0xFFFF) | ((col & 0xFFFF) << 16)
    libaom_function("av1_get_mv_projection", None, _VP, ctypes.c_uint32, _I,
                    _I)(out, ref, num, den)
    return list(struct.unpack("<hh", out.raw))


def port_mv_projection(row: int, col: int, num: int, den: int):
    out = np.zeros(2, np.int32)
    _port().av1_mv_projection(row, col, num, den, out.ctypes.data)
    return out.tolist()


def libaom_warp(mat, shear, ref: np.ndarray, p_col: int, p_row: int,
                pw: int, ph: int, ssx: int, ssy: int, depth: int):
    """av1_warp_affine_c (av1_highbd_warp_affine_c above 8 bits) of the pw x
    ph block at (p_col, p_row) of a plane from ``ref`` (the reference
    plane), single reference → (ph, pw) uint16."""
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    r = np.ascontiguousarray(ref.astype(dt))
    pred = np.zeros((ph, pw), dt)
    m = (ctypes.c_int32 * 6)(*mat)
    round0 = 5 if depth == 12 else 3
    conv = struct.pack("<i4xQiiiiiiii", 0, 0, 0, round0, 14 - round0, 0, 0,
                       0, 0, 0)
    h16 = ctypes.c_int16
    if hbd:
        fn = libaom_function("av1_highbd_warp_affine_c", None, _VP, _VP, _I,
                             _I, _I, _VP, _I, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_char_p, h16, h16, h16, h16)
        fn(m, r.ctypes.data, r.shape[1], r.shape[0], r.shape[1],
           pred.ctypes.data, p_col, p_row, pw, ph, pw, ssx, ssy, depth, conv,
           *shear)
    else:
        fn = libaom_function("av1_warp_affine_c", None, _VP, _VP, _I, _I, _I,
                             _VP, _I, _I, _I, _I, _I, _I, _I,
                             ctypes.c_char_p, h16, h16, h16, h16)
        fn(m, r.ctypes.data, r.shape[1], r.shape[0], r.shape[1],
           pred.ctypes.data, p_col, p_row, pw, ph, pw, ssx, ssy, conv, *shear)
    return pred.astype(np.uint16)


def port_warp(mat, shear, ref: np.ndarray, p_col: int, p_row: int, pw: int,
              ph: int, ssx: int, ssy: int, depth: int, compound: bool = False):
    r = np.ascontiguousarray(ref.astype(np.uint16))
    pred = np.zeros((ph, pw), np.uint16)
    m = np.array(mat, np.int32)
    sh = np.array(shear, np.int16)
    _port().av1_warp(m.ctypes.data, sh.ctypes.data, r.ctypes.data,
                     r.shape[1], r.shape[0], r.shape[1], pred.ctypes.data,
                     p_col, p_row, pw, ph, pw, ssx, ssy, depth, int(compound))
    return pred


def libaom_obmc_blend(dst: np.ndarray, src: np.ndarray, direction: int,
                      depth: int) -> np.ndarray:
    """OBMC's blend as libaom runs it: av1_get_obmc_mask of the overlap
    (rows from above, direction 0; columns from the left, 1) and
    aom_blend_a64_vmask_c / hmask_c (their highbd forms above 8 bits) of
    src over dst (h, w)."""
    h, w = dst.shape
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    d = np.ascontiguousarray(dst.astype(dt))
    s = np.ascontiguousarray(src.astype(dt))
    mask = libaom_function("av1_get_obmc_mask", _VP, _I)(w if direction
                                                           else h)
    kind = "hmask" if direction else "vmask"
    args = [_VP, ctypes.c_uint32] * 3 + [_VP, _I, _I]
    if hbd:
        fn = libaom_function(f"aom_highbd_blend_a64_{kind}_c", None,
                             *args, _I)
        fn(_hbd(d), w, _hbd(d), w, _hbd(s), w, mask, w, h, depth)
    else:
        fn = libaom_function(f"aom_blend_a64_{kind}_c", None, *args)
        fn(d.ctypes.data, w, d.ctypes.data, w, s.ctypes.data, w, mask, w, h)
    return d.astype(np.uint16)


def port_obmc_blend(dst: np.ndarray, src: np.ndarray, direction: int
                    ) -> np.ndarray:
    h, w = dst.shape
    d = np.ascontiguousarray(dst.astype(np.uint16))
    s = np.ascontiguousarray(src.astype(np.uint16))
    _port().av1_obmc_blend(d.ctypes.data, w, s.ctypes.data, w, w, h,
                           direction)
    return d


def libaom_wedge_mask(bsize: int, neg: int, index: int) -> np.ndarray:
    """The mask libaom's av1_init_wedge_masks builds for a block size, sign
    and wedge index (av1_wedge_params_lookup[bsize].masks[neg][index])."""
    _aom_init_tables()
    w, h = BLOCK_SIZES[bsize]
    at = _aom_address("av1_wedge_params_lookup") + 32 * bsize
    n, _, _, masks = struct.unpack("<i4xQQQ", ctypes.string_at(at, 32))
    assert n == 16, (bsize, n)
    ptr, = struct.unpack("<Q", ctypes.string_at(masks + 8 * (16 * neg +
                                                             index), 8))
    return np.frombuffer(ctypes.string_at(ptr, w * h), np.uint8).reshape(h, w)


def port_wedge_mask(bsize: int, neg: int, index: int) -> np.ndarray:
    w, h = BLOCK_SIZES[bsize]
    out = np.zeros((h, w), np.uint8)
    _port().av1_wedge_mask(bsize, neg, index, out.ctypes.data)
    return out


def libaom_interintra_blend(intra: np.ndarray, inter: np.ndarray,
                            bsize: int, sx: int, sy: int, mode: int,
                            wedge: int, index: int, depth: int
                            ) -> np.ndarray:
    """combine_interintra's blend as libaom runs it: aom_blend_a64_mask_c
    (aom_highbd_blend_a64_mask_c above 8 bits) of the intra prediction
    over the inter one with the block's wedge mask (sign 0, subsampled to
    the plane) or the plane's smooth mask of the mode
    (smooth_interintra_mask_buf), both from av1_init_wedge_masks."""
    _aom_init_tables()
    h, w = intra.shape
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    a = np.ascontiguousarray(intra.astype(dt))
    b = np.ascontiguousarray(inter.astype(dt))
    d = np.zeros_like(a)
    bw = BLOCK_SIZES[bsize][0]
    if wedge:
        mask = libaom_wedge_mask(bsize, 0, index)
        mstride, subw, subh = bw, int(w * 2 == bw), int(h * 2 ==
                                                         BLOCK_SIZES[bsize][1])
    else:
        psz = BLOCK_SIZES.index((w, h))
        at = _aom_address("smooth_interintra_mask_buf") + \
            (mode * 22 + psz) * 1024
        mask = np.frombuffer(ctypes.string_at(at, w * h), np.uint8)
        mstride, subw, subh = w, 0, 0
    m = np.ascontiguousarray(mask)
    args = [_VP, ctypes.c_uint32] * 3 + [_VP, ctypes.c_uint32, _I, _I, _I,
                                         _I]
    if hbd:
        fn = libaom_function("aom_highbd_blend_a64_mask_c", None, *args, _I)
        fn(_hbd(d), w, _hbd(a), w, _hbd(b), w, m.ctypes.data, mstride, w, h,
           subw, subh, depth)
    else:
        fn = libaom_function("aom_blend_a64_mask_c", None, *args)
        fn(d.ctypes.data, w, a.ctypes.data, w, b.ctypes.data, w,
           m.ctypes.data, mstride, w, h, subw, subh)
    return d.astype(np.uint16)


def port_interintra_blend(intra: np.ndarray, inter: np.ndarray, bsize: int,
                          sx: int, sy: int, mode: int, wedge: int,
                          index: int) -> np.ndarray:
    h, w = intra.shape
    d = np.ascontiguousarray(intra.astype(np.uint16))
    b = np.ascontiguousarray(inter.astype(np.uint16))
    psz = BLOCK_SIZES.index((w, h))
    _port().av1_interintra_blend(d.ctypes.data, w, b.ctypes.data, w, bsize,
                                 psz, sx, sy, mode, wedge, index)
    return d


# ------------------------------------------------- compound prediction


def _conv_params(depth: int, dst16: int = 0, stride: int = 0,
                 average: int = 0, dist=None) -> ctypes.Array:
    """libaom's ConvolveParams of a compound prediction
    (get_conv_params_no_round with is_compound): do_average, dst (its
    CONV_BUF), dst_stride, round_0 (3; 5 at 12 bits), round_1 (7), plane,
    is_compound, use_dist_wtd_comp_avg, fwd_offset, bck_offset."""
    fwd, bck = dist or (8, 8)
    return ctypes.create_string_buffer(struct.pack(
        "<i4xQiiiiiiii", average, dst16, stride, 5 if depth == 12 else 3, 7,
        0, 1, int(dist is not None), fwd, bck))


_COMP_KINDS = {"2d": "2d", "x": "x", "y": "y", "copy": "2d_copy"}


def libaom_comp_convolve(src: np.ndarray, w: int, h: int, filter_x: int,
                         filter_y: int, subpel_x: int, subpel_y: int,
                         depth: int, kind: str = "2d", second=None,
                         dist=None) -> np.ndarray:
    """libaom's compound convolution by symbol
    (av1_dist_wtd_convolve_{2d,x,y,2d_copy}_c, their highbd forms above 8
    bits) of the block of ``src`` (as ``libaom_convolve``'s; "x" wants
    subpel_y 0, "y" subpel_x 0, "copy" both): the prediction's intermediate
    precision (its CONV_BUF, (h, w) uint16); with ``second`` = (src,
    subpel_x, subpel_y) of a second prediction, the two averaged (with
    ``dist`` = (fwd, bck), weighted) to samples."""
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    conv = np.zeros((h, w), np.uint16)
    out = np.zeros((h, w), dt)
    fx, fy = _filter_params(filter_x, w), _filter_params(filter_y, h)
    pre = "av1_highbd_dist_wtd_convolve_" if hbd else "av1_dist_wtd_convolve_"
    fn_args = {"2d": [_VP, _VP, _I, _I], "x": [_VP, _I], "y": [_VP, _I],
               "copy": []}[kind]
    fn = libaom_function(f"{pre}{_COMP_KINDS[kind]}_c", None, _VP, _I, _VP,
                         _I, _I, _I, *fn_args, _VP, *([_I] if hbd else []))

    def call(block, sx, sy, params):
        b = np.ascontiguousarray(block.astype(dt))
        at = b.ctypes.data + (3 * b.shape[1] + 3) * b.itemsize
        extra = {"2d": [fx, fy, sx, sy], "x": [fx, sx], "y": [fy, sy],
                 "copy": []}[kind]
        fn(at, b.shape[1], out.ctypes.data, w, w, h, *extra, params,
           *([depth] if hbd else []))
    call(src, subpel_x, subpel_y, _conv_params(depth, conv.ctypes.data, w))
    if second is None:
        return conv
    call(second[0], second[1], second[2], _conv_params(
        depth, conv.ctypes.data, w, 1, dist))
    return out.astype(np.uint16)


# ----------------------------------------- references of another size


def scale_src_shape(w: int, h: int, subpel_x: int, x_step: int,
                    subpel_y: int, y_step: int):
    """(rows, columns) of the source a scaled w x h block reads: from 3
    before its origin to 4 after its last position, each way."""
    return (((h - 1) * y_step + subpel_y) >> 10) + 8, \
        (((w - 1) * x_step + subpel_x) >> 10) + 8


def libaom_scale_convolve(src: np.ndarray, w: int, h: int, filter_x: int,
                          filter_y: int, subpel_x: int, x_step: int,
                          subpel_y: int, y_step: int, depth: int,
                          compound: bool = False) -> np.ndarray:
    """libaom's predictor from a scaled reference by symbol
    (av1_convolve_2d_scale_c, av1_highbd_convolve_2d_scale_c above 8 bits)
    on the block of ``src`` (``scale_src_shape``, the block's origin at
    [3, 3]): positions and steps at 1/1024 of a sample, filters
    InterpFilter (each side's 4-tap rule by the block's size) → (h, w)
    uint16 samples, or with ``compound`` the intermediate precision (its
    CONV_BUF: conv_params' dst, do_average 0)."""
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    s = np.ascontiguousarray(src.astype(dt))
    at = s.ctypes.data + (3 * s.shape[1] + 3) * s.itemsize
    dst = np.zeros((h, w), dt)
    conv = np.zeros((h, w), np.uint16)
    if compound:
        params = _conv_params(depth, conv.ctypes.data, w)
    else:
        round0 = 5 if depth == 12 else 3
        params = ctypes.create_string_buffer(struct.pack(
            "<i4xQiiiiiiii", 0, 0, 0, round0, 14 - round0, 0, 0, 0, 0, 0))
    fx, fy = _filter_params(filter_x, w), _filter_params(filter_y, h)
    args = [_VP, _I, _VP, _I, _I, _I, _VP, _VP, _I, _I, _I, _I, _VP]
    name = "av1_highbd_convolve_2d_scale_c" if hbd else \
        "av1_convolve_2d_scale_c"
    fn = libaom_function(name, None, *args, *([_I] if hbd else []))
    fn(at, s.shape[1], dst.ctypes.data, w, w, h, fx, fy, subpel_x, x_step,
       subpel_y, y_step, params, *([depth] if hbd else []))
    return conv if compound else dst.astype(np.uint16)


def port_scale_convolve(src: np.ndarray, w: int, h: int, filter_x: int,
                        filter_y: int, subpel_x: int, x_step: int,
                        subpel_y: int, y_step: int, depth: int,
                        compound: bool = False) -> np.ndarray:
    """The codec's predictor from a scaled reference alone
    (``av1_scale_convolve``) on ``libaom_scale_convolve``'s block."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    s = np.ascontiguousarray(src.astype(np.uint16))
    dst = np.zeros((h, w), np.uint16)
    lib.av1_scale_convolve(s.ctypes.data + (3 * s.shape[1] + 3) * 2,
                           s.shape[1], dst.ctypes.data, w, w, h, filter_x,
                           filter_y, subpel_x, x_step, subpel_y, y_step,
                           depth, int(compound))
    return dst


def libaom_scale_factors(ref_w: int, ref_h: int, w: int, h: int):
    """av1_setup_scale_factors_for_frame by symbol: (x scale, y scale at
    1/16384, x step, y step at 1/1024), the scales -1 where the sizes are
    not valid_ref_frame_size's."""
    sf = (ctypes.c_int * 4)(0, 0, 0, 0)
    libaom_function("av1_setup_scale_factors_for_frame", None, _VP, _I, _I,
                    _I, _I)(sf, ref_w, ref_h, w, h)
    return tuple(sf)


def port_scale_factors(ref_w: int, ref_h: int, w: int, h: int):
    """The codec's scale factors (``av1_scale_factors``): (the four of
    ``libaom_scale_factors``, whether the sizes are valid)."""
    from gsplat_tpu_torch.utils import image_io
    lib = image_io._load_avif_codec()
    out = (ctypes.c_int * 4)()
    ok = lib.av1_scale_factors(ref_w, ref_h, w, h, out)
    return tuple(out), bool(ok)


def libaom_scale_mv(mv_row: int, mv_col: int, x: int, y: int,
                    x_scale: int, y_scale: int):
    """av1_scale_mv by symbol: an MV at 1/16 of a sample at (x, y) in the
    frame as (row, col) at 1/1024 of a reference sample, by the scales at
    1/16384 (scaled_y(y·16 + row) − scaled_y(y·16), the same in x)."""
    mv = (ctypes.c_int16 * 2)(mv_row, mv_col)
    sf = (ctypes.c_int * 4)(x_scale, y_scale, 0, 0)
    r = libaom_function("av1_scale_mv", ctypes.c_uint64, _VP, _I, _I, _VP)(
        mv, x, y, sf)
    return struct.unpack("<ii", struct.pack("<Q", r))


def port_scaled_position(v: int, scale: int) -> int:
    """The codec's scaled_x (``av1_scaled_position``)."""
    from gsplat_tpu_torch.utils import image_io
    return image_io._load_avif_codec().av1_scaled_position(v, scale)


def libaom_comp_warp(mat, shear, ref: np.ndarray, p_col: int, p_row: int,
                     pw: int, ph: int, ssx: int, ssy: int, depth: int
                     ) -> np.ndarray:
    """av1_warp_affine_c (av1_highbd_warp_affine_c above 8 bits) of a
    compound prediction: the block's intermediate precision (its CONV_BUF,
    (ph, pw) uint16)."""
    hbd = depth > 8
    dt = np.uint16 if hbd else np.uint8
    r = np.ascontiguousarray(ref.astype(dt))
    pred = np.zeros((ph, pw), dt)
    conv = np.zeros((ph, pw), np.uint16)
    m = (ctypes.c_int32 * 6)(*mat)
    params = _conv_params(depth, conv.ctypes.data, pw)
    h16 = ctypes.c_int16
    head = [_VP, _VP, _I, _I, _I, _VP, _I, _I, _I, _I, _I, _I, _I]
    if hbd:
        libaom_function("av1_highbd_warp_affine_c", None, *head, _I, _VP,
                        h16, h16, h16, h16)(
            m, r.ctypes.data, r.shape[1], r.shape[0], r.shape[1],
            pred.ctypes.data, p_col, p_row, pw, ph, pw, ssx, ssy, depth,
            params, *shear)
    else:
        libaom_function("av1_warp_affine_c", None, *head, _VP, h16, h16, h16,
                        h16)(
            m, r.ctypes.data, r.shape[1], r.shape[0], r.shape[1],
            pred.ctypes.data, p_col, p_row, pw, ph, pw, ssx, ssy, params,
            *shear)
    return conv


def port_comp_average(p0: np.ndarray, p1: np.ndarray, depth: int,
                      dist=None) -> np.ndarray:
    """The codec's compound average (with ``dist`` = (fwd, bck), distance
    weights) of two intermediate-precision predictions."""
    h, w = p0.shape
    a = np.ascontiguousarray(p0.astype(np.uint16))
    b = np.ascontiguousarray(p1.astype(np.uint16))
    out = np.zeros((h, w), np.uint16)
    fwd, bck = dist or (8, 8)
    _port().av1_comp_average(out.ctypes.data, w, a.ctypes.data,
                             b.ctypes.data, w, w, h, fwd, bck, depth)
    return out


def libaom_mask_blend(p0: np.ndarray, p1: np.ndarray, mask: np.ndarray,
                      subw: int, subh: int, depth: int) -> np.ndarray:
    """aom_lowbd_blend_a64_d16_mask_c (aom_highbd_blend_a64_d16_mask_c above
    8 bits): two intermediate-precision predictions of a plane, (h, w),
    blended by a mask at the luma block's size (subsampled by subw,
    subh)."""
    h, w = p0.shape
    hbd = depth > 8
    a = np.ascontiguousarray(p0.astype(np.uint16))
    b = np.ascontiguousarray(p1.astype(np.uint16))
    m = np.ascontiguousarray(mask.astype(np.uint8))
    d = np.zeros((h, w), np.uint16 if hbd else np.uint8)
    u32 = ctypes.c_uint32
    args = [_VP, u32, _VP, u32, _VP, u32, _VP, u32, _I, _I, _I, _I, _VP]
    params = _conv_params(depth)
    if hbd:
        libaom_function("aom_highbd_blend_a64_d16_mask_c", None, *args, _I)(
            _hbd(d), w, a.ctypes.data, w, b.ctypes.data, w, m.ctypes.data,
            m.shape[1], w, h, subw, subh, params, depth)
    else:
        libaom_function("aom_lowbd_blend_a64_d16_mask_c", None, *args)(
            d.ctypes.data, w, a.ctypes.data, w, b.ctypes.data, w,
            m.ctypes.data, m.shape[1], w, h, subw, subh, params)
    return d.astype(np.uint16)


def port_mask_blend(p0: np.ndarray, p1: np.ndarray, mask: np.ndarray,
                    subw: int, subh: int, depth: int) -> np.ndarray:
    h, w = p0.shape
    a = np.ascontiguousarray(p0.astype(np.uint16))
    b = np.ascontiguousarray(p1.astype(np.uint16))
    m = np.ascontiguousarray(mask.astype(np.uint8))
    out = np.zeros((h, w), np.uint16)
    _port().av1_comp_mask_blend(out.ctypes.data, w, a.ctypes.data,
                                b.ctypes.data, w, m.ctypes.data, m.shape[1],
                                w, h, subw, subh, depth)
    return out


def libaom_diffwtd_mask(p0: np.ndarray, p1: np.ndarray, inverse: int,
                        depth: int) -> np.ndarray:
    """av1_build_compound_diffwtd_mask_d16_c: the difference-weighted mask
    (DIFFWTD_38, or DIFFWTD_38_INV) of two luma predictions."""
    h, w = p0.shape
    a = np.ascontiguousarray(p0.astype(np.uint16))
    b = np.ascontiguousarray(p1.astype(np.uint16))
    mask = np.zeros((h, w), np.uint8)
    libaom_function("av1_build_compound_diffwtd_mask_d16_c", None, _VP, _I,
                    _VP, _I, _VP, _I, _I, _I, _VP, _I)(
        mask.ctypes.data, inverse, a.ctypes.data, w, b.ctypes.data, w, h, w,
        _conv_params(depth), depth)
    return mask


def port_diffwtd_mask(p0: np.ndarray, p1: np.ndarray, inverse: int,
                      depth: int) -> np.ndarray:
    h, w = p0.shape
    a = np.ascontiguousarray(p0.astype(np.uint16))
    b = np.ascontiguousarray(p1.astype(np.uint16))
    mask = np.zeros((h, w), np.uint8)
    _port().av1_diffwtd_mask(mask.ctypes.data, inverse, a.ctypes.data,
                             b.ctypes.data, w, w, h, depth)
    return mask


def libaom_dist_weights(cur: int, first: int, second: int, bits: int):
    """av1_dist_wtd_comp_weight_assign of a compound block (compound_idx 0)
    whose references LAST and ALTREF have order hints first and second,
    in a frame of order hint cur (``bits`` OrderHintBits, 0: none): (fwd,
    bck).  Its AV1_COMMON and MB_MODE_INFO are laid out here at the
    offsets the library reads (remapped_ref_idx, ref_frame_map, cur_frame,
    seq_params' order hint fields; ref_frame, compound_idx)."""
    keep = [ctypes.create_string_buffer(16) for _ in range(3)]
    for buf, hint in zip(keep, (cur, first, second)):
        struct.pack_into("<i", buf, 4, hint)          # order_hint
    seq = ctypes.create_string_buffer(64)
    struct.pack_into("<ii", seq, 0x28, int(bits > 0), max(bits - 1, 0))
    cm = ctypes.create_string_buffer(0x6090)
    struct.pack_into("<7i", cm, 0xF0, 0, -1, -1, -1, -1, -1, 1)
    struct.pack_into("<QQ", cm, 0x1A0, ctypes.addressof(keep[1]),
                     ctypes.addressof(keep[2]))
    struct.pack_into("<Q", cm, 0xE8, ctypes.addressof(keep[0]))
    struct.pack_into("<Q", cm, 0x6088, ctypes.addressof(seq))
    mbmi = ctypes.create_string_buffer(0xB0)
    struct.pack_into("<bb", mbmi, 0x10, 1, 7)
    fwd, bck, use = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    libaom_function("av1_dist_wtd_comp_weight_assign", None, _VP, _VP, _VP,
                    _VP, _VP, _I)(cm, mbmi, ctypes.byref(fwd),
                                  ctypes.byref(bck), ctypes.byref(use), 1)
    assert use.value == 1
    return fwd.value, bck.value


def port_dist_weights(cur: int, first: int, second: int, bits: int):
    out = np.zeros(2, np.int32)
    _port().av1_dist_weights(cur, first, second, bits, out.ctypes.data)
    return tuple(out.tolist())


# libaom's functions of the reference contexts, each to the port's context
# it equals (av1_ref_contexts' out[2:9]: the single reference's bits 1-6,
# then LAST2 against LAST3 and GOLDEN)
REF_CONTEXT_FUNCTIONS = {
    "av1_get_pred_context_single_ref_p1": 0,
    "av1_get_pred_context_single_ref_p2": 1,
    "av1_get_pred_context_single_ref_p3": 2,
    "av1_get_pred_context_single_ref_p4": 3,
    "av1_get_pred_context_single_ref_p5": 4,
    "av1_get_pred_context_single_ref_p6": 5,
    "av1_get_pred_context_uni_comp_ref_p": 0,
    "av1_get_pred_context_uni_comp_ref_p1": 6,
    "av1_get_pred_context_uni_comp_ref_p2": 4,
    "av1_get_pred_context_comp_ref_p": 2,
    "av1_get_pred_context_comp_ref_p1": 3,
    "av1_get_pred_context_comp_ref_p2": 4,
    "av1_get_pred_context_comp_bwdref_p": 1,
    "av1_get_pred_context_comp_bwdref_p1": 5}


def libaom_ref_contexts(above, left, cur) -> list:
    """libaom's contexts of a block's references and filters by symbol:
    av1_get_reference_mode_context, av1_get_comp_reference_type_context,
    the fourteen av1_get_pred_context_*_ref_p* (in REF_CONTEXT_FUNCTIONS'
    order) and av1_get_pred_context_switchable_interp of each direction.
    above, left: None (unavailable) or the neighbour's (ref_frame[0],
    ref_frame[1], y filter, x filter); cur: the block's (ref_frame[0],
    ref_frame[1]).  The MACROBLOCKD and MB_MODE_INFOs are laid out here at
    the offsets the library reads; neighbors_ref_counts is filled as
    libaom's av1_collect_neighbors_ref_counts (inlined there) fills it."""
    def mbmi(r0, r1, fy=0, fx=0):
        b = ctypes.create_string_buffer(0xB0)
        struct.pack_into("<bb", b, 0x10, r0, r1)
        struct.pack_into("<HH", b, 0x14, fy, fx)       # interp_filters
        return b
    blocks = [mbmi(*cur), mbmi(*(above or (0, -1))),
              mbmi(*(left or (0, -1)))]
    # xd->mi: the block's pointer, left of it the left neighbour's, a
    # stride of 2 before it the above one's
    grid = (ctypes.c_void_p * 4)(None, ctypes.addressof(blocks[1]),
                                 ctypes.addressof(blocks[2]),
                                 ctypes.addressof(blocks[0]))
    xd = ctypes.create_string_buffer(0x3000)
    struct.pack_into("<i", xd, 0x8, 2)                      # mi_stride
    struct.pack_into("<Q", xd, 0x1EB8, ctypes.addressof(grid) + 24)
    struct.pack_into("<??", xd, 0x1EC0, above is not None, left is not None)
    struct.pack_into("<QQ", xd, 0x1EC8,
                     ctypes.addressof(blocks[2]) if left else 0,
                     ctypes.addressof(blocks[1]) if above else 0)
    counts = [0] * 8
    for nb in (above, left):
        if nb is not None and nb[0] > 0:
            counts[nb[0]] += 1
            if nb[1] > 0:
                counts[nb[1]] += 1
    struct.pack_into("<8B", xd, 0x298A, *counts)
    out = [libaom_function(name, _I, _VP)(xd) for name in (
        "av1_get_reference_mode_context",
        "av1_get_comp_reference_type_context", *REF_CONTEXT_FUNCTIONS)]
    interp = libaom_function("av1_get_pred_context_switchable_interp", _I,
                             _VP, _I)
    return out + [interp(xd, 0), interp(xd, 1)]


def port_ref_contexts(above, left, cur) -> list:
    """The codec's contexts of the same (``av1_ref_contexts``), in
    ``libaom_ref_contexts``' order."""
    out = np.zeros(11, np.int32)
    a = above or (0, -1, 0, 0)
    lf = left or (0, -1, 0, 0)
    _port().av1_ref_contexts(above is not None, a[0], a[1], a[2] | a[3] << 2,
                             left is not None, lf[0], lf[1],
                             lf[2] | lf[3] << 2, cur[0], cur[1],
                             out.ctypes.data)
    v = out.tolist()
    return v[:2] + [v[2 + k] for k in REF_CONTEXT_FUNCTIONS.values()] + \
        v[9:]


class _BitBuffer(ctypes.Structure):
    # aom_read_bit_buffer
    _fields_ = [("buf", ctypes.c_void_p), ("end", ctypes.c_void_p),
                ("offset", ctypes.c_uint32), ("data", ctypes.c_void_p),
                ("handler", ctypes.c_void_p)]


def libaom_refsubexpfin(data: bytes, n: int, ref: int):
    """aom_rb_read_signed_primitive_refsubexpfin with SUBEXPFIN_K (3):
    (value, bits read)."""
    buf = ctypes.create_string_buffer(data, len(data))
    rb = _BitBuffer(ctypes.addressof(buf), ctypes.addressof(buf) + len(data),
                    0, None, None)
    v = libaom_function("aom_rb_read_signed_primitive_refsubexpfin",
                        ctypes.c_int16, ctypes.POINTER(_BitBuffer),
                        ctypes.c_uint16, ctypes.c_uint16, ctypes.c_int16)(
        ctypes.byref(rb), n, 3, ref)
    return v, rb.offset


def port_refsubexpfin(data: bytes, n: int, ref: int):
    bits = ctypes.c_int(0)
    v = _port().av1_refsubexpfin(data, len(data), n, ref, ctypes.byref(bits))
    return v, bits.value


def _port():
    from gsplat_tpu_torch.utils import image_io
    return image_io._load_avif_codec()
