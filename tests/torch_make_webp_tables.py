"""Writes the generated table block of
``gsplat_tpu_torch/csrc/webp_codec.cpp``: the constant tables of the VP8
(RFC 6386) and VP8L (RFC 9649) decoders, read out of the system
``libwebp.a``'s decoder objects.

    python tests/torch_make_webp_tables.py   # needs ar and the system
                                             # libwebp.a (libwebp-dev)

Each table is a symbol of a decoder object (``nm`` lists them as local
read-only data): ``ar p`` extracts the object, the ELF symbol table gives the
symbol's section, offset and size, and the bytes are read from there.  Each
table is then checked against the RFC's values for its first and last rows
before the block between the ``BEGIN GENERATED TABLES`` and ``END GENERATED
TABLES`` lines of the codec is replaced.  The codec builds from the committed
source alone; this script is needed only to regenerate the block.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys

import numpy as np

LIBWEBP = "/usr/lib/x86_64-linux-gnu/libwebp.a"
CODEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gsplat_tpu_torch", "csrc", "webp_codec.cpp")
BEGIN = "// BEGIN GENERATED TABLES"
END = "// END GENERATED TABLES"

# (C name, object, symbol, C type, numpy type, shape)
TABLES = [
    ("kDcTable", "libwebpdecode_la-quant_dec.o", "kDcTable", "uint8_t",
     np.uint8, (128,)),
    ("kAcTable", "libwebpdecode_la-quant_dec.o", "kAcTable", "uint16_t",
     np.uint16, (128,)),
    ("kCoeffsProba0", "libwebpdecode_la-tree_dec.o", "CoeffsProba0",
     "uint8_t", np.uint8, (4, 8, 3, 11)),
    ("kCoeffsUpdateProba", "libwebpdecode_la-tree_dec.o",
     "CoeffsUpdateProba", "uint8_t", np.uint8, (4, 8, 3, 11)),
    ("kBModesProba", "libwebpdecode_la-tree_dec.o", "kBModesProba",
     "uint8_t", np.uint8, (10, 10, 9)),
    ("kYModesIntra4", "libwebpdecode_la-tree_dec.o", "kYModesIntra4",
     "int8_t", np.int8, (18,)),
    ("kBands", "libwebpdecode_la-tree_dec.o", "kBands", "uint8_t", np.uint8,
     (17,)),
    ("kZigzag", "libwebpdecode_la-vp8_dec.o", "kZigzag", "uint8_t", np.uint8,
     (16,)),
    ("kCat3", "libwebpdecode_la-vp8_dec.o", "kCat3", "uint8_t", np.uint8,
     (4,)),
    ("kCat4", "libwebpdecode_la-vp8_dec.o", "kCat4", "uint8_t", np.uint8,
     (5,)),
    ("kCat5", "libwebpdecode_la-vp8_dec.o", "kCat5", "uint8_t", np.uint8,
     (6,)),
    ("kCat6", "libwebpdecode_la-vp8_dec.o", "kCat6", "uint8_t", np.uint8,
     (12,)),
    ("kCodeLengthCodeOrder", "libwebpdecode_la-vp8l_dec.o",
     "kCodeLengthCodeOrder", "uint8_t", np.uint8, (19,)),
    ("kCodeToPlane", "libwebpdecode_la-vp8l_dec.o", "kCodeToPlane",
     "uint8_t", np.uint8, (120,)),
]

# The RFCs' values: the first and last rows of each table (RFC 6386
# sections 13.5, 14.1, 13.4, 13.2, 11.5, 11.2, 13, 13.2; RFC 9649 sections
# 3.7.2.1.2, 4.2.2)
RFC_ROWS = {
    "kDcTable": ([4, 5, 6, 7, 8, 9, 10, 10],
                 [138, 140, 143, 145, 148, 151, 154, 157]),
    "kAcTable": ([4, 5, 6, 7, 8, 9, 10, 11],
                 [249, 254, 259, 264, 269, 274, 279, 284]),
    "kCoeffsProba0": ([128] * 11,
                      [238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128]),
    "kCoeffsUpdateProba": ([255] * 11, [255] * 11),
    "kBModesProba": ([231, 120, 48, 89, 115, 113, 120, 152, 112],
                     [112, 19, 12, 61, 195, 128, 48, 4, 24]),
    "kYModesIntra4": ([0, 1, -1, 2, -2, 3, 4, 6, -3],
                      [5, -4, -5, -6, 7, -7, 8, -8, -9]),
    "kBands": ([0, 1, 2, 3, 6, 4, 5, 6], [6, 6, 6, 6, 6, 6, 7, 0]),
    "kZigzag": ([0, 1, 4, 8, 5, 2, 3, 6], [9, 12, 13, 10, 7, 11, 14, 15]),
    "kCat3": ([173, 148, 140, 0], [173, 148, 140, 0]),
    "kCat4": ([176, 155, 140, 135, 0], [176, 155, 140, 135, 0]),
    "kCat5": ([180, 157, 141, 134, 130, 0], [180, 157, 141, 134, 130, 0]),
    "kCat6": ([254, 254, 243, 230, 196, 177],
              [153, 140, 133, 130, 129, 0]),
    "kCodeLengthCodeOrder": ([17, 18, 0, 1, 2, 3, 4, 5, 16, 6],
                             [7, 8, 9, 10, 11, 12, 13, 14, 15]),
    "kCodeToPlane": ([0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29],
                     [0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70]),
}


def _elf_symbol(obj: bytes, name: str) -> bytes:
    """The bytes of symbol ``name`` (any binding) of an ELF64 LE object."""
    shoff, = struct.unpack_from("<Q", obj, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", obj, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", obj, shoff + i * shentsize)
                for i in range(shnum)]
    for sh_name, sh_type, *_rest in sections:
        if sh_type != 2:                                 # SHT_SYMTAB
            continue
        symtab = _rest
        off, size, link, entsize = symtab[2], symtab[3], symtab[4], \
            symtab[7]
        stroff = sections[link][4]
        for k in range(size // entsize):
            st_name, _info, _other, shndx, value, st_size = \
                struct.unpack_from("<IBBHQQ", obj, off + k * entsize)
            end = obj.index(b"\x00", stroff + st_name)
            if obj[stroff + st_name:end].decode() == name:
                sec_off = sections[shndx][4]
                return obj[sec_off + value:sec_off + value + st_size]
    raise KeyError(f"{name}: not in the object")


def read_tables(lib: str = LIBWEBP) -> dict:
    """C name -> numpy array, each checked against RFC_ROWS."""
    objects, out = {}, {}
    for cname, member, symbol, _ctype, dtype, shape in TABLES:
        if member not in objects:
            objects[member] = subprocess.run(
                ["ar", "p", lib, member], check=True,
                capture_output=True).stdout
        raw = _elf_symbol(objects[member], symbol)
        arr = np.frombuffer(raw, dtype)
        if arr.size != int(np.prod(shape)):
            raise ValueError(f"{symbol}: {arr.size} values, expected "
                             f"{shape}")
        arr = arr.reshape(shape)
        first, last = RFC_ROWS[cname]
        flat = arr.reshape(-1)
        if list(flat[:len(first)]) != first or \
                list(flat[flat.size - len(last):]) != last:
            raise ValueError(f"{cname}: {flat[:len(first)].tolist()} ... "
                             f"{flat[-len(last):].tolist()} is not the RFC's")
        out[cname] = arr
    return out


def _c_array(arr: np.ndarray, indent: int = 4, lead: int = 0) -> str:
    """``arr`` as a C initializer; ``lead``: the characters before it on
    its first line."""
    pad = " " * indent
    if arr.ndim == 1:
        vals = [str(int(v)) for v in arr]
        one = "{" + ", ".join(vals) + "}"
        if max(indent, lead) + len(one) + 1 <= 79:
            return one
        lines, line = [], pad
        for v in vals:
            if len(line) + len(v) + 2 > 79:
                lines.append(line.rstrip())
                line = pad
            line += v + ", "
        lines.append(line.rstrip())
        return "{\n" + "\n".join(lines) + "\n" + " " * (indent - 4) + "}"
    inner = (",\n" + pad).join(_c_array(a, indent + 4) for a in arr)
    return "{\n" + pad + inner + "\n" + " " * (indent - 4) + "}"


def block(tables: dict) -> str:
    lines = [BEGIN,
             "// tests/torch_make_webp_tables.py: the system libwebp.a's "
             "decoder tables,",
             "// checked against the RFCs' first and last rows.  Do not edit."]
    for cname, _member, symbol, ctype, _dtype, shape in TABLES:
        head = f"const {ctype} {cname}{''.join(f'[{d}]' for d in shape)} = "
        lines.append(head + _c_array(tables[cname], lead=len(head)) + ";")
    lines.append(END)
    return "\n".join(lines)


def main():
    tables = read_tables()
    with open(CODEC) as f:
        src = f.read()
    start, end = src.index(BEGIN), src.index(END) + len(END)
    new = src[:start] + block(tables) + src[end:]
    if new != src:
        with open(CODEC, "w") as f:
            f.write(new)
    print(f"{CODEC}: {len(TABLES)} tables "
          f"({'rewritten' if new != src else 'unchanged'})")


if __name__ == "__main__":
    sys.exit(main())
