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
  written back with hand-edited properties and references.
"""

from __future__ import annotations

import ctypes
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


def build_items(items, refs, primary: int = 1) -> bytes:
    """An AVIF file of several items: ``items`` is [(id, type, OBUs,
    [(property box, essential)])], ``refs`` [(type, from, [to])]; the
    property boxes shared by value, iloc version 0, ipma version 0, an
    iref of version 0, the items' data in mdat in their order."""
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
    meta0 = full_box(b"meta", 0, 0, hdlr + pitm + iloc(0) + iinf + iprp +
                     iref)
    first = len(ftyp) + len(meta0) + 8
    meta = full_box(b"meta", 0, 0, hdlr + pitm + iloc(first) + iinf + iprp +
                    iref)
    mdat = box(b"mdat", b"".join(obu for _, _, obu, _ in items))
    return ftyp + meta + mdat
