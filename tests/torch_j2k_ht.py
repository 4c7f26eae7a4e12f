"""A test-side writer of JPEG 2000 codestreams with HT code-blocks (ITU-T
T.814, ISO/IEC 15444-15), its CAP and CPF markers and JPH files, for holding
the port's reader to cv2 (OpenJPEG 2.5.3 decodes HT).  It needs no other
HT encoder: it inverts the decoder, the context-VLC tables read from
``gsplat_tpu_torch/csrc/jpeg2000_codec.cpp`` (``kHtVlc0``,
``kHtVlc1``: T.814's code in OpenJPEG's layout), every other rule is the
decoding's, run backwards.  cv2 stays the oracle of every file it writes.

* ``ht_block(coef, cleanup_plane, passes)``: one code-block's segments from
  its integer coefficients: the cleanup pass (MagSgn, MEL, VLC), with
  ``passes`` 2 or 3 the SigProp and MagRef passes of the plane below.
* ``fdwt53`` / ``forward_rct``: the reversible transforms in numpy, for
  lossless files.
* ``ht_codestream(...)``: SOC, CAP, SIZ, COD (HT style), COC, QCD, CPF, RGN,
  tiles, layers, resolutions, precincts (LRCP or RLCP); the coefficients
  come from images (5/3) or are given (9/7, any values).
* ``jph_file``: the JP2 boxes under the brand ``jph `` (T.814 Annex D).
* ``part1_packets``: libopenjp2's Part 1 packets of the same image, for a
  component whose COC is not HT.
* ``main_markers``, ``join_markers``, ``mct``, ``mcc``, ``mco``, ``cbd``:
  Part 2 marker segments and main-header edits.
* ``j2k_mid_file(rgb, k)``: a view of chip_smoke's ``j2k_mid_ht`` leg.

Nothing under ``gsplat_tpu_torch/`` imports this module.
"""

import functools
import os
import re
import struct

import numpy as np

_CODEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "gsplat_tpu_torch", "csrc", "jpeg2000_codec.cpp")
M32 = 0xFFFFFFFF


def vlc_tables() -> tuple:
    """kHtVlc0 and kHtVlc1 as the codec's source states them."""
    src = open(_CODEC).read()
    out = []
    for name in ("kHtVlc0", "kHtVlc1"):
        body = re.search(name + r"\[1024\] = \{(.*?)\};", src, re.S).group(1)
        t = np.array([int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)],
                     np.int64)
        assert t.size == 1024
        out.append(t)
    return tuple(out)


@functools.cache
def _best():
    """For table, context, rho, u_off, which samples have E == U and
    whether U >= 2: the shortest codeword a decoder reads back as that
    quad → (codeword, length, e_k, e_1) arrays, length 0 where none."""
    shape = (2, 8, 16, 2, 16, 2)
    cw, ln, ek, e1 = (np.zeros(shape, np.int64) for _ in range(4))
    for t, tab in enumerate(vlc_tables()):
        for c in range(8):
            for v in range(128):
                e = int(tab[c * 128 + v])
                L, uoff, rho = e & 7, (e >> 3) & 1, (e >> 4) & 15
                k1, k = (e >> 8) & 15, (e >> 12) & 15
                code = v & ((1 << L) - 1)
                for eq in range(16):
                    for ug2 in range(2):
                        # a sample with e_k set has its top bit implied:
                        # set (e_1) exactly when its exponent is U
                        if k and not ug2:
                            continue
                        if (k1 ^ eq) & k & rho:
                            continue
                        at = (t, c, rho, uoff, eq, ug2)
                        if ln[at] == 0 or L < ln[at]:
                            cw[at], ln[at], ek[at], e1[at] = code, L, k, k1
    return cw, ln, ek, e1


def _bitlen(v: np.ndarray) -> np.ndarray:
    out = np.zeros(v.shape, np.int64)
    for b in range(40):
        out += (v >> b) > 0
    return out


def _pack(vals: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Codes (value, length) one after the other, LSB first → bits."""
    vals, lens = vals.ravel().astype(np.int64), lens.ravel().astype(np.int64)
    keep = lens > 0
    vals, lens = vals[keep], lens[keep]
    if not lens.size:
        return np.zeros(0, np.uint8)
    starts = np.cumsum(lens) - lens
    total = int(lens.sum())
    idx = np.arange(total) - np.repeat(starts, lens)
    return ((np.repeat(vals, lens) >> idx) & 1).astype(np.uint8)


def _windows(bits: np.ndarray, msb: bool = False) -> list:
    """Each bit position's next 8 bits as a byte (zeros past the end)."""
    b = np.concatenate([bits.astype(np.int64), np.zeros(8, np.int64)])
    n = len(bits)
    w = np.zeros(n, np.int64)
    for k in range(8):
        w |= b[k:k + n] << (7 - k if msb else k)
    return w.tolist()


def forward_bytes(bits: np.ndarray) -> bytes:
    """MagSgn and SigProp: LSB first; after a 0xFF byte the next byte holds
    7 bits and a 0 MSB."""
    win, out, pos, n = _windows(bits), bytearray(), 0, len(bits)
    while pos < n:
        byte = win[pos]
        out.append(byte)
        pos += 8
        if byte == 0xFF and pos < n:
            out.append(win[pos] & 0x7F)
            pos += 7
    return bytes(out)


def backward_bytes(bits: np.ndarray, nibble: bool) -> list:
    """VLC (nibble: its first unit the 4 bits above Scup's nibble) and
    MagRef: LSB first, in reading order; after a byte over 0x8F, 7 set
    bits make a byte of their own with a 0 MSB."""
    win, out, pos, n = _windows(np.concatenate([bits, [0]])), [], 0, len(bits)
    unstuff = True
    if nibble:
        v = win[0] & 0xF
        if v & 7 == 7:
            v, pos = 7, 3
        else:
            pos = 4
        out.append(v)
        unstuff = v > 8
    while pos < n:
        if unstuff and win[pos] & 0x7F == 0x7F:
            out.append(0x7F)
            pos += 7
            unstuff = False
        else:
            out.append(win[pos])
            pos += 8
            unstuff = win[pos - 8] > 0x8F
    return out


_MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def mel_bytes(events) -> bytes:
    """T.814's MEL coder (adaptive run lengths, MSB first; after 0xFF a
    7-bit byte); a run left open at the end is closed with a 1, padding
    is 1s, and a last 0xFF gets a 0x00 after it."""
    bits, k, run = [], 0, 0
    for ev in events:
        e = _MEL_EXP[k]
        if ev:
            bits.append(0)
            bits.extend((run >> (e - 1 - i)) & 1 for i in range(e))
            run = 0
            k = max(k - 1, 0)
        else:
            run += 1
            if run == 1 << e:
                bits.append(1)
                run = 0
                k = min(k + 1, 12)
    if run:
        bits.append(1)
    arr = np.array(bits + [1] * 8, np.uint8)
    win, out, pos = _windows(arr, msb=True), bytearray(), 0
    while pos < len(bits):
        if out and out[-1] == 0xFF:
            out.append(win[pos] >> 1)
            pos += 7
        else:
            out.append(win[pos])
            pos += 8
    if out and out[-1] == 0xFF:
        out.append(0)
    return bytes(out)


def _uvlc(u):
    """u >= 1 → (prefix value, prefix length, suffix value, suffix
    length), each LSB first."""
    u = np.asarray(u, np.int64)
    if (u > 36).any():
        raise ValueError("an exponent bound past T.814's u code")
    pv = np.select([u == 1, u == 2, u <= 4], [1, 2, 4], 0)
    pl = np.select([u == 1, u == 2], [1, 2], 3)
    sl = np.select([u <= 2, u <= 4], [0, 1], 5)
    sv = np.select([u <= 2, u <= 4], [0, u - 3], u - 5)
    return pv, pl, sv, sl


def _cleanup(mu: np.ndarray, neg: np.ndarray) -> tuple:
    """The cleanup pass of magnitudes mu (>= 0, at the cleanup plane) and
    signs → (MagSgn bits, MEL events, VLC bits)."""
    h, w = mu.shape
    H2, W4 = h + (h & 1), -(-w // 4) * 4
    m = np.zeros((H2, W4), np.int64)
    m[:h, :w] = mu
    s = np.zeros((H2, W4), np.int64)
    s[:h, :w] = neg
    sig = (m > 0).astype(np.int64)
    E = np.where(m > 0, _bitlen(2 * m - 1), 0)
    QH, QW = H2 // 2, W4 // 2
    # quad samples in T.814's order: (r0,c0), (r1,c0), (r0,c1), (r1,c1)
    def quads(a):
        return np.stack([a[0::2, 0::2], a[1::2, 0::2], a[0::2, 1::2],
                         a[1::2, 1::2]], -1)
    qs, qE, qm, qneg = quads(sig), quads(E), quads(m), quads(s)
    rho = qs[..., 0] | qs[..., 1] << 1 | qs[..., 2] << 2 | qs[..., 3] << 3
    Emax = qE.max(-1)
    # contexts
    ctx = np.zeros((QH, QW), np.int64)
    prev = rho[0, :-1]
    ctx[0, 1:] = ((prev & 1) | ((prev >> 1) & 1)) | ((prev >> 2) & 1) << 1 \
        | ((prev >> 3) & 1) << 2
    kappa = np.ones((QH, QW), np.int64)
    if QH > 1:
        A = np.zeros((QH - 1, W4 + 4), np.int64)
        A[:, 1:W4 + 1] = sig[1:-1:2]
        EA = np.zeros((QH - 1, W4 + 4), np.int64)
        EA[:, 1:W4 + 1] = E[1:-1:2]
        q2 = 2 * np.arange(QW)
        b0 = A[:, q2] | A[:, q2 + 1]
        b2 = A[:, q2 + 2] | A[:, q2 + 3]
        b1 = np.zeros((QH - 1, QW), np.int64)
        b1[:, 1:] = (qs[1:, :-1, 2] | qs[1:, :-1, 3])
        ctx[1:] = b0 | b1 << 1 | b2 << 2
        eab = np.maximum(np.maximum(EA[:, q2], EA[:, q2 + 1]),
                         np.maximum(EA[:, q2 + 2], EA[:, q2 + 3]))
        many = np.zeros((QH, QW), bool)
        many[1:] = np.array([bin(v).count("1") for v in range(16)])[
            rho[1:]] > 1
        kappa[1:] = np.where(many[1:], np.maximum(1, eab - 1), 1)
    U = np.maximum(Emax, kappa)
    uoff = (U > kappa).astype(np.int64)
    eq = ((qE == U[..., None]) & (qs > 0)).astype(np.int64)
    eqm = eq[..., 0] | eq[..., 1] << 1 | eq[..., 2] << 2 | eq[..., 3] << 3
    tab = np.zeros((QH, QW), np.int64)
    tab[1:] = 1
    cwt, lnt, ekt, e1t = _best()
    at = (tab, ctx, rho, uoff, eqm, (U >= 2).astype(np.int64))
    cw, ln, ek, e1 = cwt[at], lnt[at], ekt[at], e1t[at]
    exists = np.zeros((QH, QW), bool)
    exists[:, :] = (2 * np.arange(QW) < w)[None]
    coded = exists & ~((ctx == 0) & (rho == 0))
    if (coded & (ln == 0)).any():
        raise AssertionError("no codeword for a quad")
    cw, ln = np.where(coded, cw, 0), np.where(coded, ln, 0)
    ek, e1 = np.where(coded, ek, 0), np.where(coded, e1, 0)
    uoff = np.where(exists & (rho > 0), uoff, 0)
    # MagSgn
    ekb = np.stack([(ek >> n) & 1 for n in range(4)], -1)
    mn = np.where(qs > 0, U[..., None] - ekb, 0)
    v = np.where(qs > 0, 2 * (qm - 1) + qneg, 0)
    ms_bits = _pack(v & ((1 << mn) - 1), mn)
    # u per quad pair, MEL events
    u = U - kappa
    P = QW // 2
    u0, u1 = u[:, 0::2], u[:, 1::2]
    mode = uoff[:, 0::2] | uoff[:, 1::2] << 1
    first = np.zeros((QH, P), bool)
    first[0] = True
    m3 = mode == 3
    ev_u = first & m3 & (u0 >= 3) & (u1 >= 3)
    short = first & m3 & ~ev_u & (u0 >= 3)
    d0 = np.where(ev_u, u0 - 2, u0)
    d1 = np.where(ev_u, u1 - 2, u1)
    a0 = _uvlc(np.maximum(d0, 1))
    a1 = _uvlc(np.maximum(d1, 1))
    zero = np.zeros((QH, P), np.int64)
    # slots: codeword 0, codeword 1, then prefix 0, prefix 1 (or the bit
    # of a short second u), suffix 0, suffix 1
    one = mode == 1
    two = mode == 2
    vals = np.stack([
        cw[:, 0::2], cw[:, 1::2],
        np.select([one, two, m3], [a0[0], a1[0], a0[0]], 0),
        np.select([m3 & short, m3], [u1 - 1, a1[0]], 0),
        np.select([one, two, m3], [a0[2], a1[2], a0[2]], 0),
        np.select([m3 & ~short], [a1[2]], 0)], -1)
    lens = np.stack([
        ln[:, 0::2], ln[:, 1::2],
        np.select([one, two, m3], [a0[1], a1[1], a0[1]], 0),
        np.select([m3 & short, m3], [np.ones_like(zero), a1[1]], 0),
        np.select([one, two, m3], [a0[3], a1[3], a0[3]], 0),
        np.select([m3 & ~short], [a1[3]], 0)], -1)
    vlc_bits = _pack(vals, lens)
    evs = np.stack([(rho[:, 0::2] > 0).astype(np.int64),
                    (rho[:, 1::2] > 0).astype(np.int64),
                    ev_u.astype(np.int64)], -1)
    take = np.stack([ctx[:, 0::2] == 0,
                     (ctx[:, 1::2] == 0) & exists[:, 1::2],
                     first & m3], -1)
    events = evs[take].tolist()
    return ms_bits, events, vlc_bits


def _words(a: np.ndarray, ns: int, ng: int) -> list:
    """A (4 ns, 8 ng) bool array → per stripe, per group of 8 columns, the
    32-bit word of bit 4 * column + row; two zero words after each row."""
    b = a.reshape(ns, 4, ng, 8).transpose(0, 2, 3, 1).reshape(ns, ng, 32)
    w = (b.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.int64)
    return [list(map(int, r)) + [0, 0] for r in w.tolist()]


_PROP = (0x32, 0x74, 0xE8, 0xC0)


def _sigprop(sig, newsig, neg, h, w, causal):
    """The SigProp pass as the decoder scans it → (bits, whether every
    sample of newsig was coded)."""
    ns, ng = -(-h // 4), -(-w // 8)
    def pad(a):
        out = np.zeros((4 * ns, 8 * ng), bool)
        out[:h, :w] = a
        return out
    S, NEW, NEG = (_words(pad(a), ns, ng) for a in (sig, newsig, neg))
    mbrs = []
    for st in range(ns):
        sw, mb, prev = S[st], [0] * (ng + 2), 0
        for i in range(ng):
            m = sw[i] | prev >> 28 | (sw[i] << 4) & M32 | sw[i] >> 4 \
                | (sw[i + 1] << 28) & M32
            prev = sw[i]
            z = m | (m & 0x77777777) << 1 | (m & 0xEEEEEEEE) >> 1
            mb[i] = z & ~sw[i] & M32
        mbrs.append(mb)
    zero = [0] * (ng + 2)
    bits, missed = [], False
    for st in range(ns):
        cur_sig, cur_mbr = S[st], mbrs[st]
        rows = min(4, h - 4 * st)
        pattern = (0x11111111 * ((1 << rows) - 1)) & M32
        last = st + 1 == ns
        nxt_sig = zero if last else S[st + 1]
        nxt_mbr = list(zero) if last else mbrs[st + 1]
        if not last:
            prev = 0
            for i in range(ng):
                t = nxt_sig[i] | prev >> 28 | (nxt_sig[i] << 4) & M32 \
                    | nxt_sig[i] >> 4 | (nxt_sig[i + 1] << 28) & M32
                prev = nxt_sig[i]
                if not causal:
                    cur_mbr[i] |= (t & 0x11111111) << 3 & M32
                cur_mbr[i] &= ~cur_sig[i] & M32
        for i in range(ng):
            mbr = cur_mbr[i] & pattern
            new = 0
            coded = 0
            if mbr:
                for n in (0, 4):
                    inv = ~cur_sig[i] & pattern
                    end = min(n + 4, w - 8 * i)
                    for j in range(n, end):
                        if not (0xF << 4 * j) & mbr:
                            continue
                        for r in range(4):
                            sm = 1 << (4 * j + r)
                            if mbr & sm:
                                coded |= sm
                                b = 1 if NEW[st][i] & sm else 0
                                bits.append(b)
                                if b:
                                    new |= sm
                                    mbr |= (_PROP[r] << 4 * j) & M32 & inv
                    if new & (0xFFFF << 4 * n):
                        for j in range(n, end):
                            for r in range(4):
                                sm = 1 << (4 * j + r)
                                if new & sm:
                                    bits.append(1 if NEG[st][i] & sm else 0)
                    if n == 4:
                        t = new >> 28
                        t |= (t & 0xE) >> 1 | (t & 7) << 1
                        cur_mbr[i + 1] |= t & ~cur_sig[i + 1] & M32
            if NEW[st][i] & ~coded:
                missed = True
            new |= cur_sig[i]
            ux = (new & 0x88888888) >> 3
            tx = (ux | ux << 4 | ux >> 4) & M32
            if i > 0:
                nxt_mbr[i - 1] |= (ux << 28) & ~nxt_sig[i - 1] & M32
            nxt_mbr[i] |= tx & ~nxt_sig[i]
            nxt_mbr[i + 1] |= (ux >> 28) & ~nxt_sig[i + 1]
    return np.array(bits, np.uint8), not missed


def _magref_bits(sig, bit, h, w) -> np.ndarray:
    """MagRef: the plane's bit of each cleanup-significant sample, stripe
    by stripe, column by column, row by row."""
    ns, ng = -(-h // 4), -(-w // 8)
    s = np.zeros((4 * ns, 8 * ng), bool)
    b = np.zeros((4 * ns, 8 * ng), np.uint8)
    s[:h, :w], b[:h, :w] = sig, bit
    def order(a):
        return a.reshape(ns, 4, 8 * ng).transpose(0, 2, 1).ravel()
    return order(b)[order(s)]


def _isolated(coef: np.ndarray) -> bool:
    """Whether a sample of magnitude 1 has no nonzero 8-neighbour: the
    SigProp pass after a cleanup at plane 1 cannot reach it."""
    a = np.abs(np.asarray(coef, np.int64))
    nz = np.pad(a > 0, 1)
    h, w = a.shape
    near = np.zeros((h, w), bool)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy != 1 or dx != 1:
                near |= nz[dy:dy + h, dx:dx + w]
    return bool(((a == 1) & ~near).any())


def ht_block(coef: np.ndarray, plane: int = 0, passes: int = 1):
    """One HT code-block: integer coefficients, the cleanup pass's plane,
    1-3 passes → (segments, lossless: whether the passes carry every bit at
    and above the plane below the cleanup's).  The cleanup segment's
    MagSgn, MEL and VLC bytes are not fused."""
    coef = np.asarray(coef, np.int64)
    h, w = coef.shape
    mag, neg = np.abs(coef), coef < 0
    mu = mag >> plane
    ms_bits, events, vlc_bits = _cleanup(mu, neg)
    ms = forward_bytes(ms_bits)
    mel = mel_bytes(events)
    vlc = backward_bytes(vlc_bits, nibble=True)
    scup = len(mel) + len(vlc) + 1
    if scup > 4079:
        raise ValueError("a cleanup suffix past 4079 bytes")
    seg = ms + mel + bytes(vlc[:0:-1]) + bytes([(vlc[0] << 4) | (scup & 0xF),
                                                scup >> 4])
    lossless = not (mag & ((1 << plane) - 1)).any()
    if passes == 1:
        return [seg], lossless
    sig = mu > 0
    below = (mag >> (plane - 1)) & 1
    spb, all_coded = _sigprop(sig, (~sig) & (below > 0), neg, h, w,
                              causal=False)
    sp = forward_bytes(spb)
    mr = b""
    if passes == 3:
        mr = bytes(backward_bytes(_magref_bits(sig, below, h, w),
                                  nibble=False)[::-1])
    lossless = all_coded and passes == 3 and plane == 1
    return [seg, sp + mr], lossless


# ---------------------------------------------------------- transforms


def forward_rct(r, g, b):
    r, g, b = (np.asarray(a, np.int64) for a in (r, g, b))
    return (r + 2 * g + b) >> 2, b - g, r - g


def _fdwt53_axis(a: np.ndarray, cas: int) -> np.ndarray:
    """The 5/3 analysis along axis 0 of a segment whose first sample has
    parity cas → lows then highs (the inverse is OpenJPEG's)."""
    n = a.shape[0]
    x = a.astype(np.int64).copy()
    if n == 1:
        return x * 2 if cas else x
    if n == 0:
        return x
    idx = np.arange(n)

    def at(k):
        k = np.where(k < 0, -k, k)
        return np.where(k >= n, 2 * (n - 1) - k, k)
    hi = idx[(idx % 2) != cas]
    lo = idx[(idx % 2) == cas]
    x[hi] -= (x[at(hi - 1)] + x[at(hi + 1)]) >> 1
    x[lo] += (x[at(lo - 1)] + x[at(lo + 1)] + 2) >> 2
    return np.concatenate([x[lo], x[hi]])


def fdwt53(a: np.ndarray, levels: int, x0: int = 0, y0: int = 0):
    """A tile-component's samples → its coefficients in the decoder's
    layout (each resolution's bands beside its lower resolution)."""
    out = np.asarray(a, np.int64).copy()
    H, W = out.shape
    rx0, ry0, rx1, ry1 = x0, y0, x0 + W, y0 + H
    for _ in range(levels):
        w, h = rx1 - rx0, ry1 - ry0
        blk = out[:h, :w]
        blk = _fdwt53_axis(blk, ry0 % 2)
        blk = _fdwt53_axis(blk.T, rx0 % 2).T
        out[:h, :w] = blk
        rx0, ry0 = -(-rx0 // 2), -(-ry0 // 2)
        rx1, ry1 = -(-rx1 // 2), -(-ry1 // 2)
    return out


# ------------------------------------------------------------- tier 2


class _Bits:
    """OpenJPEG's packet header bits: MSB first, 7 bits after a 0xFF."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def put(self, b):
        if self.ct == 0:
            self._byteout()
        self.ct -= 1
        self.buf |= (b & 1) << self.ct

    def _byteout(self):
        self.out.append(self.buf)
        self.ct = 7 if self.buf == 0xFF else 8
        self.buf = 0

    def putn(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put(v >> i)

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    def __init__(self, w, h):
        self.levels = []
        lw, lh = w, h
        while True:
            self.levels.append((lw, lh))
            if lw * lh <= 1:
                break
            lw, lh = (lw + 1) // 2, (lh + 1) // 2
        self.value = [np.full(lw_ * lh_, 999, np.int64).tolist()
                      for lw_, lh_ in self.levels]
        self.low = [[0] * (lw_ * lh_) for lw_, lh_ in self.levels]
        self.known = [[False] * (lw_ * lh_) for lw_, lh_ in self.levels]

    def set(self, leaf, v):
        x, y = leaf % self.levels[0][0], leaf // self.levels[0][0]
        for li, (lw, _) in enumerate(self.levels):
            k = y * lw + x
            self.value[li][k] = min(self.value[li][k], v)
            x, y = x // 2, y // 2

    def encode(self, bio, leaf, threshold):
        x, y = leaf % self.levels[0][0], leaf // self.levels[0][0]
        path = []
        for li, (lw, _) in enumerate(self.levels):
            path.append((li, y * lw + x))
            x, y = x // 2, y // 2
        low = 0
        for li, k in reversed(path):
            if low > self.low[li][k]:
                self.low[li][k] = low
            else:
                low = self.low[li][k]
            while low < threshold:
                if low >= self.value[li][k]:
                    if not self.known[li][k]:
                        bio.put(1)
                        self.known[li][k] = True
                    break
                bio.put(0)
                low += 1
            self.low[li][k] = low


def _numpasses(bio, n):
    if n == 1:
        bio.put(0)
    elif n == 2:
        bio.putn(2, 2)
    elif n <= 5:
        bio.putn(3, 2)
        bio.putn(n - 3, 2)
    elif n <= 36:
        bio.putn(15, 4)
        bio.putn(n - 6, 5)
    else:
        bio.putn(0x1FF, 9)
        bio.putn(n - 37, 7)


def _floorlog2(v):
    return max(int(v).bit_length() - 1, 0)


def _ceildivpow2(a, b):
    return -(-a // (1 << b))


def tile_geometry(tx0, ty0, tx1, ty1, numres, cblk, precincts=None):
    """As the decoder lays a tile-component out: per resolution (x0, y0,
    x1, y1, pw, ph, bands), each band (bandno, x0, y0, x1, y1, precincts),
    each precinct a list of code-blocks (x0, y0, x1, y1) and its size in
    code-blocks."""
    res = []
    for r in range(numres):
        level = numres - 1 - r
        rx0, ry0 = _ceildivpow2(tx0, level), _ceildivpow2(ty0, level)
        rx1, ry1 = _ceildivpow2(tx1, level), _ceildivpow2(ty1, level)
        pdx, pdy = precincts[r] if precincts else (15, 15)
        tlx, tly = (rx0 >> pdx) << pdx, (ry0 >> pdy) << pdy
        brx = _ceildivpow2(rx1, pdx) << pdx
        bry = _ceildivpow2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (brx - tlx) >> pdx
        ph = 0 if ry0 == ry1 else (bry - tly) >> pdy
        if r == 0:
            cbgx0, cbgy0, cbgw, cbgh = tlx, tly, pdx, pdy
            bandnos = [0]
        else:
            cbgx0, cbgy0 = _ceildivpow2(tlx, 1), _ceildivpow2(tly, 1)
            cbgw, cbgh = pdx - 1, pdy - 1
            bandnos = [1, 2, 3]
        cbw, cbh = min(cblk[0], cbgw), min(cblk[1], cbgh)
        bands = []
        for bn in bandnos:
            if r == 0:
                bx0, by0, bx1, by1 = rx0, ry0, rx1, ry1
            else:
                xob, yob = bn & 1, bn >> 1
                bx0 = _ceildivpow2(tx0 - (xob << level), level + 1)
                by0 = _ceildivpow2(ty0 - (yob << level), level + 1)
                bx1 = _ceildivpow2(tx1 - (xob << level), level + 1)
                by1 = _ceildivpow2(ty1 - (yob << level), level + 1)
            precs = []
            for pn in range(pw * ph):
                cx0 = cbgx0 + (pn % pw) * (1 << cbgw)
                cy0 = cbgy0 + (pn // pw) * (1 << cbgh)
                px0, py0 = max(cx0, bx0), max(cy0, by0)
                px1, py1 = min(cx0 + (1 << cbgw), bx1), \
                    min(cy0 + (1 << cbgh), by1)
                tbx, tby = (px0 >> cbw) << cbw, (py0 >> cbh) << cbh
                bbx = _ceildivpow2(px1, cbw) << cbw
                bby = _ceildivpow2(py1, cbh) << cbh
                cw, ch = (bbx - tbx) >> cbw, (bby - tby) >> cbh
                blocks = []
                for k in range(max(cw, 0) * max(ch, 0)):
                    x0 = tbx + (k % cw) * (1 << cbw)
                    y0 = tby + (k // cw) * (1 << cbh)
                    blocks.append((max(x0, px0), max(y0, py0),
                                   min(x0 + (1 << cbw), px1),
                                   min(y0 + (1 << cbh), py1)))
                precs.append((max(cw, 0), max(ch, 0), blocks))
            bands.append((bn, bx0, by0, bx1, by1, precs))
        res.append((rx0, ry0, rx1, ry1, pw, ph, bands))
    return res


def _band_offset(res, r, bn):
    """Where band bn of resolution r sits in the tile-component's layout."""
    x = y = 0
    if bn & 1:
        x = res[r - 1][2] - res[r - 1][0]
    if bn & 2:
        y = res[r - 1][3] - res[r - 1][1]
    return x, y


def _marker(code, payload):
    return struct.pack(">HH", code, len(payload) + 2) + payload


def cap_marker(ccap=b"\x00\x00", pcap=1 << 14) -> bytes:
    """T.814's CAP: Pcap with bit 14 (Part 15 from the MSB's 1), then Ccap."""
    return _marker(0xFF50, struct.pack(">I", pcap) + ccap)


def cpf_marker(words=(0x4000,)) -> bytes:
    return _marker(0xFF59, b"".join(struct.pack(">H", v) for v in words))


def ht_codestream(planes=None, *, coeffs=None, size=None, numres=1,
                  cblk=(6, 6), tiles=None, layers=1, layer_of=None,
                  precincts=None, prog="LRCP", reversible=True, prec=8,
                  mct=0, guard=2, qstyle=2, expn=None, mant=0, style=0x40,
                  coc_styles=None, plane=0, passes=1, plane_of=None,
                  split=None, cap=None, cpf=None, extra_main=b"",
                  rgn=None, eph=False, sop=False, rsiz=0x4000,
                  fallback=True, extra_passes=0, zbp_offset=0,
                  packets_of=None, stats=None) -> bytes:
    """A raw codestream of HT code-blocks.

    ``planes``: the components' samples (unsigned, ``prec`` bits), coded
    losslessly through the 5/3 (``numres`` - 1 levels; ``mct`` 1 the RCT),
    or ``coeffs``: per tile a list of tile-component coefficient arrays in
    the decoder's layout (9/7 quantised indices, or anything), with
    ``size`` (h, w).  ``cblk`` log2 sizes; ``tiles`` (h, w); ``layers``
    and ``layer_of(tile, comp, res, band, block)`` the layer of a block's
    passes; ``plane`` / ``passes`` the cleanup plane and pass count (or
    ``plane_of(...)`` → (plane, passes)); with ``fallback`` a block whose
    passes would lose a bit at plane 0 is coded by a cleanup at plane 0;
    ``split`` a layer that takes the SigProp and MagRef passes T.814's
    way (one length for both); ``style`` COD's code-block style and
    ``coc_styles`` {comp: style} COCs; ``qstyle`` 0 (reversible), 1
    (derived) or 2 (expounded) with ``expn`` (per band or one) and
    ``mant``; ``cap`` / ``cpf`` their markers' bytes (None: a plain CAP,
    no CPF); ``extra_main`` bytes before the first SOT; ``rgn`` (comp,
    shift); ``extra_passes`` more passes claimed in each block's first
    contribution, their bytes none (T.814's placeholder passes, or passes
    past the first HT set), its lengths split as OpenJPEG reads them (the
    first pass, then the rest).  ``stats`` (a dict) gets the blocks by
    pass count; ``zbp_offset`` is added to every block's zero bit-planes
    (a malformed file); ``packets_of(tile, layer, res, comp, precinct)``
    gives a packet's bytes in place of the writer's (another encoder's
    Part 1 packets for a component whose COC is not HT), or None."""
    if planes is not None:
        planes = [np.asarray(p, np.int64) for p in planes]
        H, W = planes[0].shape
    else:
        H, W = size
    nc = len(planes) if planes is not None else len(coeffs[0])
    th, tw = tiles or (H, W)
    ntx, nty = -(-W // tw), -(-H // th)
    if reversible:
        qstyle = 0
    nb = 3 * (numres - 1) + 1
    gains = [0] + [1, 1, 2] * (numres - 1)
    if qstyle == 0:
        exps = [prec + g for g in gains] if expn is None else (
            list(expn) if np.ndim(expn) else [expn] * nb)
        sq = bytes([guard << 5]) + bytes(e << 3 for e in exps)
    elif qstyle == 1:
        e0 = expn if expn is not None else prec + 2
        sq = bytes([guard << 5 | 1]) + struct.pack(">H", e0 << 11 | mant)
        exps = [e0] + [max(e0 - (b - 1) // 3, 0) for b in range(1, nb)]
    else:
        exps = list(expn) if np.ndim(expn) else [
            expn if expn is not None else prec + 2] * nb
        sq = bytes([guard << 5 | 2]) + b"".join(
            struct.pack(">H", e << 11 | mant) for e in exps)
    mbs = [e + guard - 1 for e in exps]
    out = bytearray(b"\xff\x4f")
    siz = struct.pack(">HIIIIIIIIH", rsiz, W, H, 0, 0, tw, th, 0, 0, nc)
    siz += bytes([prec - 1, 1, 1]) * nc
    out += _marker(0xFF51, siz)
    out += cap_marker() if cap is None else cap
    scod = (1 if precincts else 0) | (2 if sop else 0) | (4 if eph else 0)
    prg = {"LRCP": 0, "RLCP": 1}[prog]
    spcod = bytes([numres - 1, cblk[0] - 2, cblk[1] - 2, style,
                   1 if reversible else 0])
    if precincts:
        spcod += bytes(py << 4 | px for px, py in precincts)
    out += _marker(0xFF52, bytes([scod, prg]) + struct.pack(">H", layers)
                   + bytes([mct]) + spcod)
    for c, sty in (coc_styles or {}).items():
        body = bytes([c, 1 if precincts else 0, numres - 1, cblk[0] - 2,
                      cblk[1] - 2, sty, 1 if reversible else 0])
        if precincts:
            body += bytes(py << 4 | px for px, py in precincts)
        out += _marker(0xFF53, body)
    out += _marker(0xFF5C, sq)
    if cpf is not None:
        out += cpf
    if rgn:
        out += _marker(0xFF5E, bytes([rgn[0], 0, rgn[1]]))
    out += extra_main
    styles = [(coc_styles or {}).get(c, style) for c in range(nc)]
    if stats is not None:
        stats.setdefault("passes", {1: 0, 2: 0, 3: 0})
    for t in range(ntx * nty):
        tx0, ty0 = (t % ntx) * tw, (t // ntx) * th
        tx1, ty1 = min(tx0 + tw, W), min(ty0 + th, H)
        if planes is not None:
            tp = [p[ty0:ty1, tx0:tx1] - (1 << (prec - 1)) for p in planes]
            if mct:
                tp[0], tp[1], tp[2] = forward_rct(tp[0] + (1 << (prec - 1)),
                                                  tp[1] + (1 << (prec - 1)),
                                                  tp[2] + (1 << (prec - 1)))
                tp[0] = tp[0] - (1 << (prec - 1))
            tcoef = [fdwt53(a, numres - 1, tx0, ty0) for a in tp]
        else:
            tcoef = [np.asarray(a, np.int64) for a in coeffs[t]]
        geo = tile_geometry(tx0, ty0, tx1, ty1, numres, cblk, precincts)
        # every block: (layer, P, segments, passes)
        blocks = {}
        for c in range(nc):
            for r, (rx0, ry0, rx1, ry1, pw, ph, bands) in enumerate(geo):
                for bi, (bn, bx0, by0, bx1, by1, precs) in enumerate(bands):
                    bidx = 0 if r == 0 else 3 * (r - 1) + bn
                    Mb = mbs[bidx]
                    ox, oy = _band_offset(geo, r, bn)
                    for pn, (cw, ch, cbs) in enumerate(precs):
                        for k, (x0, y0, x1, y1) in enumerate(cbs):
                            if x1 <= x0 or y1 <= y0:
                                continue
                            blk = tcoef[c][oy + y0 - by0:oy + y1 - by0,
                                           ox + x0 - bx0:ox + x1 - bx0]
                            if not blk.any():
                                continue
                            if np.abs(blk).max() >= 1 << Mb:
                                raise ValueError(
                                    f"a coefficient past the band's {Mb} "
                                    f"bit-planes")
                            key = (c, r, bi, pn, k)
                            pl, np_ = (plane_of(t, *key) if plane_of
                                       else (plane, passes))
                            if np_ > 1 and pl < 1:
                                np_ = 1
                            if fallback and np_ > 1 and pl == 1 \
                                    and _isolated(blk):
                                pl, np_ = 0, 1
                            segs, lossless = ht_block(blk, pl, np_)
                            if fallback and np_ > 1 and not lossless \
                                    and pl == 1:
                                pl, np_ = 0, 1
                                segs, _ = ht_block(blk, 0, 1)
                            if stats is not None:
                                stats["passes"][np_] += 1
                            lay = layer_of(t, *key) % layers if layer_of \
                                else 0
                            blocks[key] = [lay, max(Mb - 1 - pl + zbp_offset,
                                                    0), segs, np_]
        body = bytearray()
        state = {}      # per precinct: tag trees
        order = [(l, r) for l in range(layers) for r in range(numres)] \
            if prog == "LRCP" else \
            [(l, r) for r in range(numres) for l in range(layers)]
        for l, r in order:
            for c in range(nc):
                rx0, ry0, rx1, ry1, pw, ph, bands = geo[r]
                for pn in range(pw * ph):
                    pk = _packet(blocks, state, c, r, pn, bands, l, split,
                                 sop, eph, extra_passes)
                    if packets_of is not None:
                        other = packets_of(t, l, r, c, pn)
                        pk = pk if other is None else other
                    body += pk
        out += _marker(0xFF90, struct.pack(">HIBB", t, 12 + 2 + len(body),
                                           0, 1))
        out += b"\xff\x93" + body
    out += b"\xff\xd9"
    return bytes(out)


def _packet(blocks, state, c, r, pn, bands, layer, split, sop, eph, extra):
    bio = _Bits()
    present = any(v[0] == layer or (split is not None and layer == split
                                    and v[3] > 1)
                  for k, v in blocks.items() if k[0] == c and k[1] == r
                  and k[3] == pn)
    bio.put(1 if present else 0)
    bodies = []
    for bi, (bn, _, _, _, _, precs) in enumerate(bands):
        if bands[bi][3] <= bands[bi][1] or bands[bi][4] <= bands[bi][2]:
            continue
        cw, ch, cbs = precs[pn]
        if not present:
            continue
        key0 = (c, r, bi, pn)
        if key0 not in state:
            incl, imsb = _TagTree(cw, ch), _TagTree(cw, ch)
            info = [None] * len(cbs)
            for k in range(len(cbs)):
                b = blocks.get((c, r, bi, pn, k))
                incl.set(k, b[0] if b else 999)
                imsb.set(k, b[1] if b else 0)
            state[key0] = (incl, imsb, info)
        incl, imsb, info = state[key0]
        for k in range(len(cbs)):
            b = blocks.get((c, r, bi, pn, k))
            if info[k] is None:
                incl.encode(bio, k, layer + 1)
                if not b or b[0] != layer:
                    continue
                imsb.encode(bio, k, 999)
                segs, npass = b[2], b[3]
                if split is not None and npass > 1:
                    npass, lens = 1, [len(segs[0])]
                    later = segs[1]
                else:
                    lens, later = [len(s) for s in segs], None
                if extra:
                    npass += extra
                    lens = [len(segs[0]), sum(len(s) for s in segs[1:])]
                _numpasses(bio, npass)
                ns = [1, npass - 1]
                need = [max(len_.bit_length(), 1) - _floorlog2(n)
                        for len_, n in zip(lens, ns)]
                lblock = max(3, *need)
                bio.putn((1 << (lblock - 3)) - 1, lblock - 3)
                bio.put(0)
                info[k] = (later, lblock)
                for len_, n in zip(lens, ns):
                    bio.putn(len_, lblock + _floorlog2(n))
                bodies.append(b"".join(segs) if extra else
                              b"".join(segs[:len(lens)]))
            else:
                later, lblock = info[k]
                if later is None or layer != split:
                    bio.put(0)
                    continue
                # T.814: SigProp and MagRef, one segment, one length
                bio.put(1)
                _numpasses(bio, 2)
                need = max(len(later).bit_length(), 1) - 1
                inc = max(0, need - lblock)
                bio.putn((1 << inc) - 1, inc)
                bio.put(0)
                lblock += inc
                bio.putn(len(later), lblock + 1)
                info[k] = (None, lblock)
                bodies.append(later)
    head = bio.flush()
    if eph:
        head += b"\xff\x92"
    pre = b""
    if sop:
        pre = b"\xff\x91\x00\x04" + struct.pack(">H", state.setdefault(
            "sop", 0) & 0xFFFF)
        state["sop"] += 1
    return pre + head + b"".join(bodies)


def jph_file(codestream: bytes, numcomps: int, h: int, w: int, colr=16,
             extra=b"", bpc=7, compat=b"jph ") -> bytes:
    """T.814 Annex D: the JP2 box structure under the brand ``jph `` (its
    compatibility list ``compat``)."""
    import torch_make_image_fixtures as fx
    return fx.jp2_file(codestream, numcomps, h, w, colr=colr, extra=extra,
                       bpc=bpc, ftyp=b"jph \0\0\0\0" + compat)


def part1_packets(planes, numres, mode=0):
    """libopenjp2's Part 1 packets of the same coefficients (one layer,
    LRCP, 64x64 blocks, PLT) → {(res, comp): bytes}."""
    import torch_make_image_fixtures as fx

    cs = fx.openjpeg_encode(planes, numres=numres, cblk=(64, 64), mode=mode,
                            extra=["PLT=YES"])
    at = cs.find(b"\xff\x58")
    n = struct.unpack(">H", cs[at + 2:at + 4])[0]
    lens, v = [], 0
    for b in cs[at + 5:at + 2 + n]:
        v = v << 7 | (b & 0x7F)
        if not b & 0x80:
            lens.append(v)
            v = 0
    body = cs[cs.find(b"\xff\x93") + 2:]
    out, pos = {}, 0
    for k, n in enumerate(lens):
        out[(k // len(planes), k % len(planes))] = body[pos:pos + n]
        pos += n
    return out


# ------------------------------------------------ Part 2 marker edits


def main_markers(cs: bytes):
    """A codestream → its main header's markers [[code, body]] (SOC left
    out) and the bytes from the first SOT."""
    out, i = [], 2
    while True:
        code = int.from_bytes(cs[i:i + 2], "big")
        if code == 0xFF90:
            return out, cs[i:]
        n = int.from_bytes(cs[i + 2:i + 4], "big")
        out.append([code, bytearray(cs[i + 4:i + 2 + n])])
        i += 2 + n


def join_markers(ms, rest: bytes) -> bytes:
    out = bytearray(b"\xff\x4f")
    for code, body in ms:
        out += struct.pack(">HH", code, len(body) + 2) + bytes(body)
    return bytes(out + rest)


def seg(code: int, body: bytes) -> list:
    return [code, bytearray(body)]


_EL = {"i16": (0, ">H"), "i32": (1, ">i"), "f32": (2, ">f"), "f64": (3, ">d")}


def mct(index, kind, values, element="i32", zmct=0, ymct=0) -> list:
    """An MCT marker: ``kind`` 1 decorrelation, 2 offset."""
    et, f = _EL[element]
    body = struct.pack(">HHH", zmct, et << 10 | kind << 8 | index, ymct)
    body += b"".join(struct.pack(f, v) for v in values)
    return seg(0xFF74, body)


def mcc(index, deco, offset, n=3, zmcc=0, ymcc=0, coll=1, xmcc=1,
        comps=None, outs=None, wide=False, reversible=False) -> list:
    """An MCC marker of one array-decorrelation collection."""
    body = struct.pack(">HBHH", zmcc, index, ymcc, coll)
    fmt = ">H" if wide else ">B"
    for _ in range(coll):
        ins = list(range(n)) if comps is None else comps
        body += bytes([xmcc]) + struct.pack(">H", len(ins) | wide << 15)
        body += b"".join(struct.pack(fmt, v) for v in ins)
        o = list(range(n)) if outs is None else outs
        body += struct.pack(">H", len(o) | wide << 15)
        body += b"".join(struct.pack(fmt, v) for v in o)
        body += (reversible << 16 | offset << 8 | deco).to_bytes(3, "big")
    return seg(0xFF75, body)


def mco(*stages) -> list:
    return seg(0xFF77, bytes([len(stages), *stages]))


def cbd(defs, count=None) -> list:
    return seg(0xFF78, struct.pack(">H", len(defs) if count is None else
                                   count) + bytes(defs))


# ------------------------------------------------------ the mid views

def j2k_mid_file(rgb: np.ndarray, k: int, stats=None) -> bytes:
    """View k of chip_smoke's j2k_mid_ht leg, lossless: even k a raw
    codestream of HT code-blocks, 5/3 over 5 levels and the RCT, each
    block's cleanup pass alone at plane 0; odd k a JPH file whose blocks'
    cleanup passes sit at plane 1 with SigProp and MagRef finishing
    plane 0 (a block whose SigProp would miss a bit: a cleanup at plane
    0)."""
    h, w = rgb.shape[:2]
    planes = [rgb[..., i] for i in range(3)]
    if k % 2 == 0:
        return ht_codestream(planes, numres=6, mct=1, plane=0, passes=1,
                             stats=stats)
    cs = ht_codestream(planes, numres=6, mct=1, plane=1, passes=3,
                       stats=stats)
    return jph_file(cs, 3, h, w)
