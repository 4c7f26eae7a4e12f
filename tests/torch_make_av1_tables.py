"""Writes the generated table block of
``gsplat_tpu_torch/csrc/avif_codec.cpp``: the constant tables of the AV1
intra decoder (the default CDFs, the quantizer lookups and matrices, the
default scans, the intra predictors' tables, film grain's Gaussian
sequence), read out of the libaom that
cv2's wheel bundles (``opencv_python.libs/libaom-*.so.3.*``).

    python tests/torch_make_av1_tables.py    # needs the opencv-python wheel

That library keeps its ELF symbol table: each big table is a named object
(``av1_default_coeff_base_multi_cdfs``, ``dc_qlookup_QTX``,
``iwt_matrix_ref``, ``default_scan_8x4``, film grain's
``gaussian_sequence``, ...) read from ``.rodata`` at the
symbol's address.  The few small mode CDFs that the compiler folded into
vector constants (angle delta, skip, delta q, transform depth, filter intra,
CfL) have no symbol: they are written here with the specification's values,
and each row's inverse CDF must occur in the library's bytes.

libaom stores a CDF as its inverse (32768 - c) with a trailing count, and a
transform block's coefficients column by column; the block holds the
specification's forms: CDFs ascending, ending in 32768 and a zero count, and
scans and quantizer matrices indexed ``row * width + column``.  Each table is
checked against the specification's first and last rows before the block
between the ``BEGIN GENERATED TABLES`` and ``END GENERATED TABLES`` lines of
the codec is replaced.  The codec builds from the committed source alone;
this script is needed only to regenerate the block.
"""

from __future__ import annotations

import glob
import os
import struct
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CODEC = os.path.join(ROOT, "gsplat_tpu_torch", "csrc", "avif_codec.cpp")
BEGIN = "// BEGIN GENERATED TABLES"
END = "// END GENERATED TABLES"


def find_libaom() -> str:
    import cv2
    libs = os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")
    found = sorted(glob.glob(os.path.join(libs, "libaom-*.so.3*")))
    if not found:
        sys.exit(f"no bundled libaom under {libs}")
    return found[-1]


class Elf:
    """The sections and symbols of a 64-bit little-endian ELF file."""

    def __init__(self, path: str):
        self.data = d = open(path, "rb").read()
        shoff, = struct.unpack_from("<Q", d, 0x28)
        shentsize, shnum, shstrndx = struct.unpack_from("<HHH", d, 0x3A)
        heads = [struct.unpack_from("<IIQQQQ", d, shoff + i * shentsize)
                 for i in range(shnum)]
        strtab = heads[shstrndx][4]
        self.sections = {}
        for name, _, _, addr, off, size in heads:
            end = d.index(b"\0", strtab + name)
            self.sections[d[strtab + name:end].decode()] = (addr, off, size)
        self.symbols = {}
        self.functions = {}
        if ".symtab" not in self.sections:
            sys.exit(f"{path} has no symbol table")
        _, so, sz = self.sections[".symtab"]
        _, sto, _ = self.sections[".strtab"]
        for i in range(sz // 24):
            nm, info, _, _, val, size = struct.unpack_from("<IBBHQQ", d,
                                                           so + 24 * i)
            if size and (info & 0xF) in (1, 2):
                end = d.index(b"\0", sto + nm)
                into = self.symbols if (info & 0xF) == 1 else self.functions
                into[d[sto + nm:end].decode()] = (val, size)

    def table(self, name: str, dtype, shape) -> np.ndarray:
        addr, size = self.symbols[name]
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        if n != size:
            sys.exit(f"{name}: {size} bytes, expected {n}")
        for sec in (".rodata", ".data.rel.ro", ".data"):
            base, off, ssize = self.sections[sec]
            if base <= addr < base + ssize:
                o = off + addr - base
                return np.frombuffer(self.data[o:o + n], dtype).reshape(shape)
        sys.exit(f"{name} lies in no data section")


def cdf_from_icdf(icdf: np.ndarray, nsym: int) -> np.ndarray:
    """libaom rows (inverse CDF, padded) → the spec's rows of nsym + 1."""
    rows = icdf.reshape(-1, icdf.shape[-1])
    out = np.zeros((rows.shape[0], nsym + 1), np.int64)
    out[:, :nsym] = 32768 - rows[:, :nsym].astype(np.int64)
    if (out[:, nsym - 1] != 32768).any() or (np.diff(out[:, :nsym]) < 0).any():
        raise SystemExit("not a CDF")
    return out.reshape(icdf.shape[:-1] + (nsym + 1,))


def spec_cdf(rows, nsym: int) -> np.ndarray:
    rows = np.asarray(rows, np.int64)
    out = np.zeros(rows.shape[:-1] + (nsym + 1,), np.int64)
    out[..., :nsym - 1] = rows
    out[..., nsym - 1] = 32768
    return out


# The small mode CDFs, with the specification's values (section 10.3)
ANGLE_DELTA = [
    [2180, 5032, 7567, 22776, 26989, 30217],
    [2301, 5608, 8801, 23487, 26974, 30330],
    [3780, 11018, 13699, 19354, 23083, 31286],
    [4581, 11226, 15147, 17138, 21834, 28397],
    [1737, 10927, 14509, 19588, 22745, 28823],
    [2664, 10176, 12485, 17650, 21600, 30495],
    [2240, 11096, 15453, 20341, 22561, 28917],
    [3605, 10428, 12459, 17676, 21244, 30655]]
SKIP = [[31671], [16515], [4576]]
DELTA_Q = [28160, 32120, 32677]
TX_8X8 = [[19968], [19968], [24320]]
TX_16X16 = [[12272, 30172], [12272, 30172], [18677, 30848]]
TX_32X32 = [[12986, 15180], [12986, 15180], [24302, 25602]]
TX_64X64 = [[5782, 11475], [5782, 11475], [16803, 22759]]
FILTER_INTRA_MODE = [8949, 12776, 17211, 29558]
FILTER_INTRA = [[4621], [6743], [5893], [7866], [12551], [9394], [12408],
                [14301], [12756], [22343], [16384], [16384], [16384],
                [16384], [16384], [16384], [12770], [10368], [20229],
                [18101], [16384], [16384]]
CFL_SIGN = [1418, 2123, 13340, 18405, 26972, 28343, 32294]
CFL_ALPHA = [
    [7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704,
     32708, 32712, 32716, 32720, 32724],
    [14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620, 32647,
     32668, 32672, 32676, 32680, 32684],
    [11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673, 32677,
     32681, 32685, 32689, 32693, 32697],
    [26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708, 32712,
     32716, 32720, 32724, 32728, 32732],
    [17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394, 32464,
     32516, 32560, 32576, 32593, 32622],
    [14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144, 32413,
     32520, 32594, 32622, 32656, 32660]]


# The screen content and inter-transform mode CDFs without a symbol
# (libaom's default_palette_*_cdf, default_intrabc_cdf and
# default_txfm_partition_cdf, folded into av1_init_mode_probs)
PALETTE_Y_MODE = [[[31676], [3419], [1261]], [[31912], [2859], [980]],
                  [[31823], [3400], [781]], [[32030], [3561], [904]],
                  [[32309], [7337], [1462]], [[32265], [4015], [1521]],
                  [[32450], [7946], [129]]]
PALETTE_UV_MODE = [[32461], [21488]]
PALETTE_Y_SIZE = [[7952, 13000, 18149, 21478, 25527, 29241],
                  [7139, 11421, 16195, 19544, 23666, 28073],
                  [7788, 12741, 17325, 20500, 24315, 28530],
                  [8271, 14064, 18246, 21564, 25071, 28533],
                  [12725, 19180, 21863, 24839, 27535, 30120],
                  [9711, 14888, 16923, 21052, 25661, 27875],
                  [14940, 20797, 21678, 24186, 27033, 28999]]
PALETTE_UV_SIZE = [[8713, 19979, 27128, 29609, 31331, 32272],
                   [5839, 15573, 23581, 26947, 29848, 31700],
                   [4426, 11260, 17999, 21483, 25863, 29430],
                   [3228, 9464, 14993, 18089, 22523, 27420],
                   [3768, 8886, 13091, 17852, 22495, 27207],
                   [2464, 8451, 12861, 21632, 25525, 28555],
                   [1269, 5435, 10433, 18963, 21700, 25865]]
INTRABC = [30531]
TXFM_SPLIT = [[28581], [23846], [20847], [24315], [18196], [12133], [18791],
              [10887], [11005], [27179], [20004], [11281], [26549], [19308],
              [14224], [28015], [21546], [14400], [28165], [22401], [16088]]


def check_blocks_in_library(elf: Elf, name: str, rows, pad: int):
    """A table without a symbol, laid out as libaom stores it (each row its
    inverse CDF padded to ``pad`` entries), occurs in the library's bytes:
    every 16-byte piece of it (the compiler keeps such tables as vector
    constants), or, for one or two rows, each row's value as an immediate
    of av1_init_mode_probs."""
    rows = np.asarray(rows, np.int64).reshape(-1, np.shape(rows)[-1])
    lay = np.zeros((rows.shape[0], pad), np.int64)
    lay[:, :rows.shape[1]] = 32768 - rows
    blob = lay.astype("<u2").tobytes()
    if len(blob) < 16:
        addr, off, _ = elf.sections[".text"]
        fn = elf.functions["av1_init_mode_probs"]
        code = elf.data[off + fn[0] - addr:off + fn[0] - addr + fn[1]]
        for row in lay:
            if row[:1].astype("<u2").tobytes() not in code:
                sys.exit(f"{name}: {list(32768 - row[:1])} is not in "
                         f"av1_init_mode_probs")
        return
    for i in range(0, len(blob) - 15, 16):
        if blob[i:i + 16] not in elf.data:
            sys.exit(f"{name}: bytes {i}-{i + 15} are not in the library")
    if blob[-16:] not in elf.data:
        sys.exit(f"{name}: its last bytes are not in the library")


def check_in_library(elf: Elf, name: str, rows):
    """Each row's inverse CDF (its first 8 values at most) occurs in the
    library's bytes, in .rodata or as immediates in .text."""
    for row in np.asarray(rows, np.int64).reshape(-1, np.shape(rows)[-1]):
        if (row == 16384).all() and len(row) == 1:
            continue
        pat = (32768 - row[:8]).astype("<u2").tobytes()
        if pat not in elf.data:
            sys.exit(f"{name}: row {list(row)} is not in the library")


# (first row, last row) of each table as the specification prints them
SPEC_ROWS = {
    "kKfYModeCdf": ([15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244,
                     24189, 28165, 29093, 30466, 32768, 0],
                    [7618, 8288, 9859, 10509, 15386, 18657, 22903, 28776, 29180,
                     31355, 31802, 32593, 32768, 0]),
    "kCoeffBaseCdf": ([4034, 8930, 12727, 32768, 0], None),
    "kCoeffBrCdf": ([14298, 20718, 24174, 32768, 0], None),
    "kCoeffBaseEobCdf": ([17837, 29055, 32768, 0], None),
    "kEobPt16Cdf": ([840, 1039, 1980, 4895, 32768, 0], None),
    "kTxbSkipCdf": ([31849, 32768, 0], None),
    "kPartitionW8Cdf": ([19132, 25510, 30392, 32768, 0], None),
    "kDcQLookup": ([4, 8, 8, 9, 10, 11, 12, 12], [21387]),
    "kPaletteYColorCdf": ([28710, 32768, 0], None),
    "kMvJointCdf": ([4096, 11264, 19328, 32768, 0], None),
    "kMvClassCdf": ([28672, 30976, 31858, 32320, 32551, 32656, 32740, 32757,
                     32762, 32767, 32768, 0], None),
    "kInterTxTypeSet3Cdf": ([16384, 32768, 0], [748, 32768, 0]),
    "kAcQLookup": ([4, 8, 9, 10, 11, 12, 13, 14], [29247]),
    "kGaussianSequence": ([56, 568, -180, 172, 124, -84, 172, -64],
                          [428, -484]),
}


def check_rows(name: str, arr: np.ndarray):
    if name not in SPEC_ROWS:
        return
    first, last = SPEC_ROWS[name]
    flat = arr.reshape(-1)
    if list(flat[:len(first)]) != first:
        sys.exit(f"{name}: first row {list(flat[:len(first)])} != {first}")
    if last is not None and list(flat[-len(last):]) != last:
        sys.exit(f"{name}: last row {list(flat[-len(last):])} != {last}")


# libaom's transform sizes in its TX_SIZE order: (width, height)
TX_DIMS = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (4, 8), (8, 4),
           (8, 16), (16, 8), (16, 32), (32, 16), (32, 64), (64, 32),
           (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16)]


def adjusted(w: int, h: int):
    return min(w, 32), min(h, 32)


def to_spec_layout(a: np.ndarray, w: int, h: int) -> np.ndarray:
    """libaom's column-major block (index col * h + row) → row-major."""
    return a.reshape(w, h).T.reshape(-1)


def scan_to_spec(scan: np.ndarray, w: int, h: int) -> np.ndarray:
    col, row = scan // h, scan % h
    return row * w + col


def collect(elf: Elf):
    t = {}
    i16, u16, u8, i8 = "<i2", "<u2", "u1", "i1"
    kf = elf.table("default_kf_y_mode_cdf", u16, (5, 5, 14))
    t["kKfYModeCdf"] = ("uint16_t", cdf_from_icdf(kf, 13))
    uv = elf.table("default_uv_mode_cdf", u16, (2, 13, 15))
    t["kUvModeCflNotAllowedCdf"] = ("uint16_t", cdf_from_icdf(uv[0], 13))
    t["kUvModeCflAllowedCdf"] = ("uint16_t", cdf_from_icdf(uv[1], 14))
    part = elf.table("default_partition_cdf", u16, (20, 11))
    t["kPartitionW8Cdf"] = ("uint16_t", cdf_from_icdf(part[0:4], 4))
    t["kPartitionW16Cdf"] = ("uint16_t", cdf_from_icdf(part[4:8], 10))
    t["kPartitionW32Cdf"] = ("uint16_t", cdf_from_icdf(part[8:12], 10))
    t["kPartitionW64Cdf"] = ("uint16_t", cdf_from_icdf(part[12:16], 10))
    t["kPartitionW128Cdf"] = ("uint16_t", cdf_from_icdf(part[16:20], 8))
    ext = elf.table("default_intra_ext_tx_cdf", u16, (3, 4, 13, 17))
    t["kIntraTxTypeSet1Cdf"] = ("uint16_t", cdf_from_icdf(ext[1, :2], 7))
    t["kIntraTxTypeSet2Cdf"] = ("uint16_t", cdf_from_icdf(ext[2, :3], 5))
    for name, rows, nsym in (
            ("kAngleDeltaCdf", ANGLE_DELTA, 7), ("kSkipCdf", SKIP, 2),
            ("kDeltaQCdf", DELTA_Q, 4), ("kTx8x8Cdf", TX_8X8, 2),
            ("kTx16x16Cdf", TX_16X16, 3), ("kTx32x32Cdf", TX_32X32, 3),
            ("kTx64x64Cdf", TX_64X64, 3),
            ("kFilterIntraModeCdf", FILTER_INTRA_MODE, 5),
            ("kFilterIntraCdf", FILTER_INTRA, 2),
            ("kCflSignCdf", CFL_SIGN, 8), ("kCflAlphaCdf", CFL_ALPHA, 16)):
        check_in_library(elf, name, rows)
        t[name] = ("uint16_t", spec_cdf(rows, nsym))
    # coefficient CDFs, at the four q contexts
    t["kTxbSkipCdf"] = ("uint16_t", cdf_from_icdf(elf.table(
        "av1_default_txb_skip_cdfs", u16, (4, 5, 13, 3)), 2))
    for n, sym in ((16, 5), (32, 6), (64, 7), (128, 8), (256, 9)):
        t[f"kEobPt{n}Cdf"] = ("uint16_t", cdf_from_icdf(elf.table(
            f"av1_default_eob_multi{n}_cdfs", u16, (4, 2, 2, sym + 1)), sym))
    for n, sym in ((512, 10), (1024, 11)):
        a = elf.table(f"av1_default_eob_multi{n}_cdfs", u16, (4, 2, 2,
                                                               sym + 1))
        t[f"kEobPt{n}Cdf"] = ("uint16_t", cdf_from_icdf(a[:, :, 0], sym))
    t["kEobExtraCdf"] = ("uint16_t", cdf_from_icdf(elf.table(
        "av1_default_eob_extra_cdfs", u16, (4, 5, 2, 9, 3)), 2))
    t["kDcSignCdf"] = ("uint16_t", cdf_from_icdf(elf.table(
        "av1_default_dc_sign_cdfs", u16, (4, 2, 3, 3)), 2))
    t["kCoeffBaseEobCdf"] = ("uint16_t", cdf_from_icdf(elf.table(
        "av1_default_coeff_base_eob_multi_cdfs", u16, (4, 5, 2, 4, 4)), 3))
    t["kCoeffBaseCdf"] = ("uint16_t", cdf_from_icdf(elf.table(
        "av1_default_coeff_base_multi_cdfs", u16, (4, 5, 2, 42, 5)), 4))
    t["kCoeffBrCdf"] = ("uint16_t", cdf_from_icdf(elf.table(
        "av1_default_coeff_lps_multi_cdfs", u16, (4, 5, 2, 21, 5)), 4))
    # quantizer lookups
    t["kDcQLookup"] = ("int16_t", np.stack([elf.table(
        n, i16, (256,)) for n in ("dc_qlookup_QTX", "dc_qlookup_10_QTX",
                                  "dc_qlookup_12_QTX")]))
    t["kAcQLookup"] = ("int16_t", np.stack([elf.table(
        n, i16, (256,)) for n in ("ac_qlookup_QTX", "ac_qlookup_10_QTX",
                                  "ac_qlookup_12_QTX")]))
    # quantizer matrices: libaom's order of the sizes it stores, each block
    # turned row-major
    qm = elf.table("iwt_matrix_ref", u8, (15, 2, 3344)).copy()
    off = 0
    offsets = []
    for w, h in TX_DIMS:
        if adjusted(w, h) != (w, h):
            offsets.append(-1)
            continue
        offsets.append(off)
        for lv in range(15):
            for p in range(2):
                qm[lv, p, off:off + w * h] = to_spec_layout(
                    qm[lv, p, off:off + w * h], w, h)
        off += w * h
    assert off == 3344
    t["kQuantizerMatrix"] = ("uint8_t", qm)
    t["kQmOffset"] = ("int16_t", np.array(offsets))
    # default scans, row-major positions, sizes in libaom's order (up to 32)
    scans, soff = [], []
    pos = 0
    for w, h in TX_DIMS:
        if max(w, h) > 32:
            soff.append(-1)
            continue
        s = elf.table(f"default_scan_{w}x{h}", i16, (w * h,))
        s = scan_to_spec(s.astype(np.int64), w, h)
        if sorted(s) != list(range(w * h)):
            sys.exit(f"default_scan_{w}x{h} is not a permutation")
        for kind in ("mrow", "mcol"):
            m = elf.table(f"{kind}_scan_{w}x{h}", i16, (w * h,))
            m = scan_to_spec(m.astype(np.int64), w, h)
            want = (list(range(w * h)) if kind == "mrow" else
                    [r * w + c for c in range(w) for r in range(h)])
            if list(m) != list(want):
                sys.exit(f"{kind}_scan_{w}x{h} is not the {kind} order")
        scans.append(s)
        soff.append(pos)
        pos += w * h
    t["kDefaultScan"] = ("int16_t", np.concatenate(scans))
    t["kDefaultScanOffset"] = ("int16_t", np.array(soff))
    # the coefficient base contexts' offsets, row-major, checked below
    nz = {}
    for w, h in TX_DIMS:
        name = f"av1_nz_map_ctx_offset_{w}x{h}"
        if name in elf.symbols and max(w, h) <= 32:
            nz[(w, h)] = to_spec_layout(elf.table(name, i8, (w * h,))
                                        .astype(np.int64), w, h)
    t["kDrIntraDerivative"] = ("uint16_t", elf.table("dr_intra_derivative",
                                                     u16, (90,)))
    t["kSmWeights"] = ("uint8_t", elf.table("smooth_weights", u8, (124,)))
    taps = elf.table("av1_filter_intra_taps", i8, (5, 8, 8))
    if taps[..., 7].any():
        sys.exit("av1_filter_intra_taps: an eighth tap")
    t["kFilterIntraTaps"] = ("int8_t", taps[..., :7])
    t["kModeToAngle"] = ("uint8_t", elf.table("mode_to_angle_map", u8, (13,)))
    # screen content tools: palette and intra block copy
    for name, rows, nsym, pad in (
            ("kPaletteYModeCdf", PALETTE_Y_MODE, 2, 3),
            ("kPaletteUvModeCdf", PALETTE_UV_MODE, 2, 3),
            ("kPaletteYSizeCdf", PALETTE_Y_SIZE, 7, 8),
            ("kPaletteUvSizeCdf", PALETTE_UV_SIZE, 7, 8),
            ("kIntrabcCdf", INTRABC, 2, 3),
            ("kTxfmSplitCdf", TXFM_SPLIT, 2, 3)):
        check_blocks_in_library(elf, name, rows, pad)
        t[name] = ("uint16_t", spec_cdf(rows, nsym))
    for plane in ("y", "uv"):
        icdf = elf.table(f"default_palette_{plane}_color_index_cdf", u16,
                         (7, 5, 9))
        out = np.zeros((7, 5, 9), np.int64)
        for k in range(7):      # k + 2 colours
            out[k, :, :k + 3] = cdf_from_icdf(icdf[k, :, :k + 3], k + 2)
        t[f"kPalette{plane.capitalize()}ColorCdf"] = ("uint16_t", out)
    t["kPaletteColorContext"] = ("int8_t", elf.table(
        "av1_palette_color_index_context_lookup", "<i4", (9,)))
    # the inter transform sets (intra block copy's blocks are inter blocks)
    ext = elf.table("default_inter_ext_tx_cdf", u16, (4, 4, 17))
    t["kInterTxTypeSet1Cdf"] = ("uint16_t", cdf_from_icdf(ext[1], 16))
    t["kInterTxTypeSet2Cdf"] = ("uint16_t", cdf_from_icdf(ext[2, :, :13], 12))
    t["kInterTxTypeSet3Cdf"] = ("uint16_t", cdf_from_icdf(ext[3, :, :3], 2))
    t["kExtTxInv"] = ("uint8_t", elf.table("av1_ext_tx_inv", "<i4", (6, 16)))
    t["kExtTxUsed"] = ("uint8_t", elf.table("av1_ext_tx_used", "<i4",
                                            (6, 16)))
    # the motion vector CDFs (nmv_context: joints, then per component
    # classes, class0_fp, fp, sign, class0_hp, hp, class0, bits); a DV reads
    # whole pels: the joints, signs, classes, class 0 bits and bits
    nmv = elf.table("default_nmv_context", u16, (143,))
    comp = [nmv[5 + 69 * c:5 + 69 * (c + 1)] for c in range(2)]
    t["kMvJointCdf"] = ("uint16_t", cdf_from_icdf(nmv[:5], 4))
    t["kMvClassCdf"] = ("uint16_t", np.stack([cdf_from_icdf(c[:12], 11)
                                              for c in comp]))
    t["kMvSignCdf"] = ("uint16_t", np.stack([cdf_from_icdf(c[27:30], 2)
                                             for c in comp]))
    t["kMvClass0Cdf"] = ("uint16_t", np.stack([cdf_from_icdf(c[36:39], 2)
                                               for c in comp]))
    t["kMvBitCdf"] = ("uint16_t", np.stack([cdf_from_icdf(
        c[39:69].reshape(10, 3), 2) for c in comp]))
    # film grain: the specification's Gaussian_Sequence (libaom's ints)
    t["kGaussianSequence"] = ("int16_t", elf.table("gaussian_sequence",
                                                   "<i4", (2048,)))
    for name, (_, arr) in t.items():
        check_rows(name, arr)
    return t, nz


def base_ctx_offset(w: int, h: int, row: int, col: int) -> int:
    """The specification's Coeff_Base_Ctx_Offset as the codec computes it."""
    sq = [[0, 1, 6, 6, 21], [1, 6, 6, 21, 21], [6, 6, 21, 21, 21],
          [6, 21, 21, 21, 21], [21, 21, 21, 21, 21]]
    r, c = min(row, 4), min(col, 4)
    if row == 0 and col == 0:
        return 0
    if w > h and c < 2:
        return 16
    if h > w and r < 2:
        return 11
    return sq[r][c]


def emit(name: str, ctype: str, arr: np.ndarray) -> str:
    arr = np.asarray(arr)
    dims = "".join(f"[{n}]" for n in arr.shape)

    def rec(a, ind):
        if a.ndim == 1:
            vals = [str(int(v)) for v in a]
            lines, cur = [], ind
            for v in vals:
                if len(cur) + len(v) + 2 > 79:
                    lines.append(cur.rstrip())
                    cur = ind
                cur += v + ", "
            lines.append(cur.rstrip())
            return "{\n" + "\n".join(lines) + "\n" + ind[:-2] + "}"
        return "{" + ", ".join(rec(x, ind + "  ") for x in a) + "}"
    return f"static const {ctype} {name}{dims} = {rec(arr, '  ')};\n"


def main():
    lib = find_libaom()
    elf = Elf(lib)
    tables, nz = collect(elf)
    for (w, h), a in nz.items():
        for p, v in enumerate(a):
            got = base_ctx_offset(w, h, p // w, p % w)
            if got != v:
                sys.exit(f"coefficient context offset {w}x{h} at {p}: "
                         f"{v}, the codec computes {got}")
    body = [f"// Read out of {os.path.basename(lib)} by "
            f"tests/torch_make_av1_tables.py.\n"]
    for name, (ctype, arr) in tables.items():
        body.append(emit(name, ctype, arr))
    src = open(CODEC).read()
    a, b = src.index(BEGIN), src.index(END)
    src = src[:a + len(BEGIN)] + "\n" + "".join(body) + src[b:]
    with open(CODEC, "w") as f:
        f.write(src)
    print(f"wrote {len(tables)} tables into {CODEC}; the coefficient "
          f"context offsets of {len(nz)} sizes match the codec's rule")


if __name__ == "__main__":
    main()
