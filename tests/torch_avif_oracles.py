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
  that cv2's and Pillow's writers make, with a grid alpha.
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
