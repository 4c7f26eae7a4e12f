// JPEG 2000 codec (ctypes ABI) for utils/image_io.py, which parses the JP2
// boxes itself and hands this file the codestream.
//
// Decoder: a codestream as OpenJPEG 2.5.3 (the copy cv2 5.0.0 links)
// decodes it, in its order and with its rules for what it refuses:
//   1. the main and tile-part headers (SIZ, COD, COC, QCD, QCC, RGN, POC,
//      PPM, PPT, TLM, PLM, PLT, CRG, COM; several tile-parts a tile; Part
//      15's CAP and CPF, which OpenJPEG skips; Part 2's CBD, MCT, MCC and
//      MCO as far as OpenJPEG reads them: CBD's precisions and signs, an
//      MCC offset array as the components' DC level shifts);
//   2. tier-2: packet headers in the five progression orders and POC, tag
//      trees, Lblock, SOP/EPH, precincts, code-word segments (an HT
//      code-block's as OpenJPEG numbers them);
//   3. tier-1: EBCOT's three passes with the MQ decoder, every code-block
//      style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM); HT code-blocks
//      (Part 15): the cleanup, SigProp and MagRef passes;
//   4. dequantisation (OpenJPEG's mid-point values, 5/3's truncating / 2,
//      9/7's float step sizes), RGN maxshift;
//   5. the 5/3 integer and 9/7 float inverse wavelet transforms, the
//      inverse RCT and ICT, the DC level shift and OpenJPEG's rounding.
// A few allocations past OpenJPEG's practical reach are refused with a
// message that starts "limit: ".
// The 9/7 path is float throughout, rounded where OpenJPEG's SSE code
// rounds: every product and sum below is one IEEE single operation, and
// FMA contraction is switched off (gcc on x86-64 emits none without
// -march, but an aarch64 gcc would fuse c * (a + b) + x by default).
//
// Encoder: the codestream OpenJPEG 2.5.3 writes for cv2's
// IMWRITE_JPEG2000_COMPRESSION_X1000 = x: one tile, 5 levels of the
// reversible 5/3 transform, 64x64 code-blocks, LRCP, one layer, no
// component transform, the MQ coder flushed as OpenJPEG flushes it.  At
// x = 1000 the layer holds every coding pass; below it, at rate 1000 / x
// (cv2's default x = 250), the passes OpenJPEG's rate allocation keeps:
// each pass's rate and weighted distortion from tier-1, then the
// threshold bisection over the rate-distortion slopes, sizing the packets
// as tier-2 writes them, against the byte budget.
//
// Built at first use with the system C++ compiler
// (ops/cuda_build.load_host_library).

#if defined(__clang__)
#pragma clang fp contract(off)
#elif defined(__GNUC__)
#pragma GCC optimize("fp-contract=off")
#endif

#include <cfloat>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <string>
#include <thread>
#include <vector>

namespace {

using u8 = uint8_t;
using u32 = uint32_t;
using i32 = int32_t;
using i64 = int64_t;

struct Fail {
    std::string msg;
};

[[noreturn]] void fail(const std::string& m) { throw Fail{m}; }

std::string fmt(const char* f, long long a = 0, long long b = 0,
                long long c = 0) {
    char buf[256];
    snprintf(buf, sizeof buf, f, a, b, c);
    return buf;
}

// runs fn(i) for i in [0, n) on up to 8 threads (code-blocks are
// independent); the first exception is rethrown here
template <class F>
void parallel_for(size_t n, F fn) {
    unsigned nt = std::thread::hardware_concurrency();
    nt = nt == 0 ? 1 : (nt > 8 ? 8 : nt);
    if (n < 2 * (size_t)nt) nt = 1;
    std::atomic<size_t> next{0};
    std::atomic<bool> failed{false};
    Fail first;
    std::atomic_flag lock = ATOMIC_FLAG_INIT;
    auto work = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= n || failed.load()) return;
            try {
                fn(i);
            } catch (const Fail& f) {
                while (lock.test_and_set()) {
                }
                if (!failed.exchange(true)) first = f;
                lock.clear();
                return;
            }
        }
    };
    if (nt == 1) {
        work();
    } else {
        std::vector<std::thread> pool;
        for (unsigned t = 1; t < nt; t++) pool.emplace_back(work);
        work();
        for (auto& t : pool) t.join();
    }
    if (failed.load()) throw first;
}

// ------------------------------------------------------------ integer math

inline i32 ceildiv(i32 a, i32 b) { return (i32)(((i64)a + b - 1) / b); }
inline u32 uceildiv(u32 a, u32 b) { return (u32)(((uint64_t)a + b - 1) / b); }
inline i32 ceildivpow2(i32 a, u32 b) { return (i32)(((i64)a + ((i64)1 << b) - 1) >> b); }
inline i32 ceildivpow2_64(i64 a, u32 b) { return (i32)((a + ((i64)1 << b) - 1) >> b); }
inline i32 floordivpow2(i32 a, u32 b) { return a >> b; }
inline u32 ufloorlog2(u32 a) {
    u32 l = 0;
    while (a > 1) {
        a >>= 1;
        l++;
    }
    return l;
}

// -------------------------------------------------------------- MQ coder

struct MQState {
    u32 qe;
    u8 nmps, nlps, sw;
};

const MQState kMQ[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// T1 contexts: 9 zero coding, 5 sign, 3 magnitude, run, uniform
constexpr int CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17,
              CTX_UNI = 18, NCTX = 19;

struct Ctx {
    u8 state, mps;
};

void reset_contexts(Ctx* ctx) {
    for (int i = 0; i < NCTX; i++) ctx[i] = {0, 0};
    ctx[CTX_UNI] = {46, 0};
    ctx[CTX_AGG] = {3, 0};
    ctx[CTX_ZC] = {4, 0};
}

// OpenJPEG's decoder (ISO 15444-1 C.3) over a segment followed by the
// synthetic 0xFF 0xFF it writes past each segment's end.
struct MQDec {
    const u8* bp;
    u32 a, c, ct;
    void bytein() {
        u32 l_c = bp[1];
        if (bp[0] == 0xFF) {
            if (l_c > 0x8F) {
                c += 0xFF00;
                ct = 8;
            } else {
                bp++;
                c += l_c << 9;
                ct = 7;
            }
        } else {
            bp++;
            c += l_c << 8;
            ct = 8;
        }
    }
    void init(const u8* p, u32 len) {
        bp = p;
        c = len == 0 ? 0xFFu << 16 : (u32)p[0] << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            ct--;
        } while (a < 0x8000);
    }
    int decode(Ctx& cx) {
        const MQState& s = kMQ[cx.state];
        int d;
        a -= s.qe;
        if ((c >> 16) < s.qe) {
            if (a < s.qe) {
                a = s.qe;
                d = cx.mps;
                cx.state = s.nmps;
            } else {
                a = s.qe;
                d = !cx.mps;
                if (s.sw) cx.mps = !cx.mps;
                cx.state = s.nlps;
            }
            renorm();
        } else {
            c -= s.qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) {
                    d = !cx.mps;
                    if (s.sw) cx.mps = !cx.mps;
                    cx.state = s.nlps;
                } else {
                    d = cx.mps;
                    cx.state = s.nmps;
                }
                renorm();
            } else {
                d = cx.mps;
            }
        }
        return d;
    }
    // raw (bypass) segments
    void raw_init(const u8* p) {
        bp = p;
        c = 0;
        ct = 0;
    }
    int raw() {
        if (ct == 0) {
            if (c == 0xFF) {
                if (*bp > 0x8F) {
                    c = 0xFF;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        ct--;
        return (c >> ct) & 1;
    }
};

// ---------------------------------------------------------------- tier-1

// per-coefficient flags: neighbour significance, neighbour signs, own state
constexpr u32 F_NW = 1, F_N = 2, F_NE = 4, F_W = 8, F_E = 16, F_SW = 32,
              F_S = 64, F_SE = 128, F_NNEG = 256, F_SNEG = 512,
              F_WNEG = 1024, F_ENEG = 2048, F_SIG = 4096, F_PI = 8192,
              F_MU = 16384, F_NEIGH = 255;

u8 g_zc[4][256];   // orientation (0 LL, 1 HL, 2 LH, 3 HH) x neighbour bits
u8 g_sc[256];      // sign context | xor bit << 7, indexed by flags >> 4 & 0xFF
// the encoder's distortion tables (OpenJPEG's lut_nmsedec_sig, _sig0, _ref,
// _ref0): the squared error a pass removes from a coefficient, in units of
// 2^-13, from its magnitude bits at and below the plane (7 bits, 6 below)
constexpr int NMSE_BITS = 7, NMSE_FRAC = 6;
i32 g_nmse_sig[1 << NMSE_BITS], g_nmse_sig0[1 << NMSE_BITS],
    g_nmse_ref[1 << NMSE_BITS], g_nmse_ref0[1 << NMSE_BITS];
bool g_luts = false;

void init_luts() {
    if (g_luts) return;
    for (int o = 0; o < 4; o++)
        for (int f = 0; f < 256; f++) {
            int h = !!(f & F_W) + !!(f & F_E);
            int v = !!(f & F_N) + !!(f & F_S);
            int d = !!(f & F_NW) + !!(f & F_NE) + !!(f & F_SW) + !!(f & F_SE);
            int n = 0;
            if (o == 1) {   // horizontally high-pass: vertical neighbours lead
                int t = h;
                h = v;
                v = t;
            }
            if (o != 3) {
                if (!h) {
                    if (!v) n = !d ? 0 : (d == 1 ? 1 : 2);
                    else n = v == 1 ? 3 : 4;
                } else if (h == 1) {
                    n = !v ? (!d ? 5 : 6) : 7;
                } else {
                    n = 8;
                }
            } else {
                int hv = h + v;
                if (!d) n = !hv ? 0 : (hv == 1 ? 1 : 2);
                else if (d == 1) n = !hv ? 3 : (hv == 1 ? 4 : 5);
                else if (d == 2) n = !hv ? 6 : 7;
                else n = 8;
            }
            g_zc[o][f] = (u8)(CTX_ZC + n);
        }
    // sign: bits (of flags >> 0): N,S,W,E significance and their signs
    for (int i = 0; i < 256; i++) {
        // i: bit0 N sig, bit1 S sig, bit2 W sig, bit3 E sig,
        //    bit4 N neg, bit5 S neg, bit6 W neg, bit7 E neg
        auto sg = [&](int sigbit, int negbit) {
            if (!(i & (1 << sigbit))) return 0;
            return (i & (1 << negbit)) ? -1 : 1;
        };
        int hc = sg(2, 6) + sg(3, 7);
        int vc = sg(0, 4) + sg(1, 5);
        hc = hc > 0 ? 1 : (hc < 0 ? -1 : 0);
        vc = vc > 0 ? 1 : (vc < 0 ? -1 : 0);
        int ctx, x;
        if (hc == 1) {
            x = 0;
            ctx = vc == 1 ? 13 : (vc == 0 ? 12 : 11);
        } else if (hc == 0) {
            ctx = vc == 0 ? 9 : 10;
            x = vc == -1 ? 1 : 0;
        } else {
            x = 1;
            ctx = vc == 1 ? 11 : (vc == 0 ? 12 : 13);
        }
        g_sc[i] = (u8)(ctx | (x << 7));
    }
    const double one = std::pow(2.0, NMSE_FRAC);
    auto fix13 = [&](double e) {
        int v = (int)(std::floor(e * one + 0.5) / one * 8192.0);
        return v > 0 ? v : 0;
    };
    for (int i = 0; i < (1 << NMSE_BITS); i++) {
        double t = i / one;
        g_nmse_sig[i] = fix13(t * t - (t - 1.5) * (t - 1.5));
        g_nmse_sig0[i] = fix13(t * t);
        double u = t - 1.0, v = (i & (1 << (NMSE_BITS - 1))) ? t - 1.5 : t - 0.5;
        g_nmse_ref[i] = fix13(u * u - v * v);
        g_nmse_ref0[i] = fix13(u * u);
    }
    g_luts = true;
}

inline int sc_index(u32 f) {
    return (!!(f & F_N)) | (!!(f & F_S)) << 1 | (!!(f & F_W)) << 2 |
           (!!(f & F_E)) << 3 | (!!(f & F_NNEG)) << 4 |
           (!!(f & F_SNEG)) << 5 | (!!(f & F_WNEG)) << 6 |
           (!!(f & F_ENEG)) << 7;
}

constexpr u32 STY_LAZY = 1, STY_RESET = 2, STY_TERMALL = 4, STY_VSC = 8,
              STY_PTERM = 16, STY_SEGSYM = 32, STY_HT = 64;

struct T1 {
    int w = 0, h = 0, fs = 0;          // fs: flags stride (w + 2)
    std::vector<i32> data;
    std::vector<u32> flags;            // (w + 2) x (h + 2)
    Ctx ctx[NCTX];
    MQDec mq;
    const u8* zc = nullptr;
    bool vsc = false;

    void setup(int w_, int h_) {
        w = w_;
        h = h_;
        fs = w + 2;
        data.assign((size_t)w * h, 0);
        flags.assign((size_t)(w + 2) * (h + 2), 0);
    }
    u32* fl(int x, int y) { return &flags[(size_t)(y + 1) * fs + x + 1]; }

    void set_sig(int x, int y, int neg) {
        u32* f = fl(x, y);
        f[0] |= F_SIG;
        f[-1] |= F_E | (neg ? F_ENEG : 0);
        f[1] |= F_W | (neg ? F_WNEG : 0);
        if (!((y & 3) == 0 && vsc)) {
            u32* n = f - fs;
            n[0] |= F_S | (neg ? F_SNEG : 0);
            n[-1] |= F_SE;
            n[1] |= F_SW;
        }
        u32* s = f + fs;
        s[0] |= F_N | (neg ? F_NNEG : 0);
        s[-1] |= F_NE;
        s[1] |= F_NW;
    }

    void decode_sign(int x, int y, i32 oph, bool raw) {
        int v;
        if (raw) {
            v = mq.raw();
        } else {
            u8 lu = g_sc[sc_index(*fl(x, y))];
            v = mq.decode(ctx[lu & 0x7F]) ^ (lu >> 7);
        }
        data[(size_t)y * w + x] = v ? -oph : oph;
        set_sig(x, y, v);
    }

    void sigpass(int bpno, bool raw) {
        i32 one = 1 << bpno, oph = one | (one >> 1);
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++)
                for (int y = k; y < k + 4 && y < h; y++) {
                    u32 f = *fl(x, y);
                    if ((f & (F_SIG | F_PI)) || !(f & F_NEIGH)) continue;
                    int v = raw ? mq.raw() : mq.decode(ctx[zc[f & F_NEIGH]]);
                    if (v) decode_sign(x, y, oph, raw);
                    *fl(x, y) |= F_PI;
                }
    }

    void refpass(int bpno, bool raw) {
        i32 poshalf = (1 << bpno) >> 1;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++)
                for (int y = k; y < k + 4 && y < h; y++) {
                    u32& f = *fl(x, y);
                    if ((f & (F_SIG | F_PI)) != F_SIG) continue;
                    int v;
                    if (raw) {
                        v = mq.raw();
                    } else {
                        int cx = (f & F_MU) ? CTX_MAG + 2
                                            : ((f & F_NEIGH) ? CTX_MAG + 1 : CTX_MAG);
                        v = mq.decode(ctx[cx]);
                    }
                    i32& d = data[(size_t)y * w + x];
                    d += (v ^ (d < 0)) ? poshalf : -poshalf;
                    f |= F_MU;
                }
    }

    void clnpass(int bpno, bool segsym) {
        i32 one = 1 << bpno, oph = one | (one >> 1);
        int full = h & ~3;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++) {
                int y0 = k;
                if (k < full && !*fl(x, k) && !*fl(x, k + 1) &&
                    !*fl(x, k + 2) && !*fl(x, k + 3)) {
                    if (!mq.decode(ctx[CTX_AGG])) continue;
                    int r = mq.decode(ctx[CTX_UNI]);
                    r = (r << 1) | mq.decode(ctx[CTX_UNI]);
                    decode_sign(x, k + r, oph, false);
                    for (int y = k + r + 1; y < k + 4; y++) {
                        if (mq.decode(ctx[zc[*fl(x, y) & F_NEIGH]]))
                            decode_sign(x, y, oph, false);
                    }
                    y0 = k + 4;
                }
                for (int y = y0; y < k + 4 && y < h; y++) {
                    u32 f = *fl(x, y);
                    if (f & (F_SIG | F_PI)) continue;
                    if (mq.decode(ctx[zc[f & F_NEIGH]]))
                        decode_sign(x, y, oph, false);
                }
                for (int y = k; y < k + 4 && y < h; y++) *fl(x, y) &= ~F_PI;
            }
        if (segsym) {
            for (int i = 0; i < 4; i++) mq.decode(ctx[CTX_UNI]);
        }
    }
};

// ------------------------------------------------ HT code-blocks (Part 15)
//
// The HT block decoder of ITU-T T.814 (ISO/IEC 15444-15) as OpenJPEG 2.5.3
// runs it (its ht_dec.c): the cleanup pass (MagSgn read forward from the
// segment's start; MEL forward and VLC backward in its Scup-byte suffix),
// then the SigProp pass in stripes of four rows and the MagRef pass read
// backward from the end of the second segment.  Each bit reader keeps
// OpenJPEG's buffering: its stuffing rules, the 0xFF (MagSgn, MEL) or 0x00
// (VLC, SigProp, MagRef) it feeds past the end, and the bit a stuffed byte's
// MSB ORs into the next byte.  A sample is kept sign-magnitude with its
// magnitude one bit up (bit 0 the half-bin) until the block's end, then
// turned into the integers Part 1's tier-1 hands on.
//
// kHtVlc0 (first quad row) and kHtVlc1 (the rows below) are T.814's
// context-VLC code (its Annex C tables), in OpenJPEG's layout: 8 contexts
// of 128 entries, indexed by (context << 7) | the next 7 VLC bits; an entry
// holds the codeword's length (bits 0-2), u_off (bit 3), rho (4-7), e_1
// (8-11) and e_k (12-15).
const uint16_t kHtVlc0[1024] = {
    0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee, 0x0014, 0xd8df, 0x0023, 0x10be,
    0x0043, 0xf5ff, 0x0083, 0x207e, 0x0055, 0x515f, 0x0023, 0x0035, 0x0043, 0x444e,
    0x0083, 0xc4ce, 0x0014, 0xcccf, 0x0023, 0xe2fe, 0x0043, 0x99ff, 0x0083, 0x0096,
    0x00c5, 0x313f, 0x0023, 0x00a5, 0x0043, 0x445e, 0x0083, 0xc8ce, 0x0014, 0x11df,
    0x0023, 0xf4fe, 0x0043, 0xfcff, 0x0083, 0x009e, 0x0055, 0x0077, 0x0023, 0x0035,
    0x0043, 0xf1ff, 0x0083, 0x88ae, 0x0014, 0x00b7, 0x0023, 0xf8fe, 0x0043, 0xe4ef,
    0x0083, 0x888e, 0x00c5, 0x111f, 0x0023, 0x00a5, 0x0043, 0x0066, 0x0083, 0xa8ee,
    0x0014, 0x54df, 0x0023, 0x10be, 0x0043, 0x22ef, 0x0083, 0x207e, 0x0055, 0x227f,
    0x0023, 0x0035, 0x0043, 0x444e, 0x0083, 0xc4ce, 0x0014, 0x11bf, 0x0023, 0xe2fe,
    0x0043, 0x00f7, 0x0083, 0x0096, 0x00c5, 0x223f, 0x0023, 0x00a5, 0x0043, 0x445e,
    0x0083, 0xc8ce, 0x0014, 0x00d7, 0x0023, 0xf4fe, 0x0043, 0xbaff, 0x0083, 0x009e,
    0x0055, 0x006f, 0x0023, 0x0035, 0x0043, 0xe6ff, 0x0083, 0x88ae, 0x0014, 0xa2af,
    0x0023, 0xf8fe, 0x0043, 0x00e7, 0x0083, 0x888e, 0x00c5, 0x222f, 0x0002, 0x00c5,
    0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0x00f7, 0x0002, 0xa2fe, 0x0044, 0x0056,
    0x0002, 0x009e, 0x0014, 0x00d7, 0x0002, 0x10be, 0x0084, 0x0066, 0x0002, 0x88ae,
    0x0024, 0x11df, 0x0002, 0xa8ee, 0x0044, 0x0036, 0x0002, 0x888e, 0x0014, 0x111f,
    0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0x88ff, 0x0002, 0xb8fe,
    0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0x00b7, 0x0002, 0xe4fe, 0x0084, 0x445e,
    0x0002, 0x00a6, 0x0024, 0x00e7, 0x0002, 0x54de, 0x0044, 0x222e, 0x0002, 0x003e,
    0x0014, 0x0077, 0x0002, 0x00c5, 0x0084, 0x207e, 0x0002, 0xc4ce, 0x0024, 0xf1ff,
    0x0002, 0xa2fe, 0x0044, 0x0056, 0x0002, 0x009e, 0x0014, 0x11bf, 0x0002, 0x10be,
    0x0084, 0x0066, 0x0002, 0x88ae, 0x0024, 0x22ef, 0x0002, 0xa8ee, 0x0044, 0x0036,
    0x0002, 0x888e, 0x0014, 0x227f, 0x0002, 0x00c5, 0x0084, 0x006e, 0x0002, 0x88ce,
    0x0024, 0xe4ef, 0x0002, 0xb8fe, 0x0044, 0x444e, 0x0002, 0x0096, 0x0014, 0xa2af,
    0x0002, 0xe4fe, 0x0084, 0x445e, 0x0002, 0x00a6, 0x0024, 0xd8df, 0x0002, 0x54de,
    0x0044, 0x222e, 0x0002, 0x003e, 0x0014, 0x515f, 0x0002, 0x0055, 0x0084, 0x0066,
    0x0002, 0x88de, 0x0024, 0x32ff, 0x0002, 0x11fe, 0x0044, 0x444e, 0x0002, 0x00ae,
    0x0014, 0x00b7, 0x0002, 0x317e, 0x0084, 0x515e, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e, 0x0014, 0x0077, 0x0002, 0x0055,
    0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0x00e7, 0x0002, 0xf1fe, 0x0044, 0x0036,
    0x0002, 0x00a6, 0x0014, 0x555f, 0x0002, 0x74fe, 0x0084, 0x113e, 0x0002, 0x20be,
    0x0024, 0x747f, 0x0002, 0xc4de, 0x0044, 0xf8ff, 0x0002, 0x0096, 0x0014, 0x222f,
    0x0002, 0x0055, 0x0084, 0x0066, 0x0002, 0x88de, 0x0024, 0x00f7, 0x0002, 0x11fe,
    0x0044, 0x444e, 0x0002, 0x00ae, 0x0014, 0x888f, 0x0002, 0x317e, 0x0084, 0x515e,
    0x0002, 0x00c6, 0x0024, 0xc8cf, 0x0002, 0x20ee, 0x0044, 0x111e, 0x0002, 0x009e,
    0x0014, 0x006f, 0x0002, 0x0055, 0x0084, 0x545e, 0x0002, 0x44ce, 0x0024, 0xd1df,
    0x0002, 0xf1fe, 0x0044, 0x0036, 0x0002, 0x00a6, 0x0014, 0x227f, 0x0002, 0x74fe,
    0x0084, 0x113e, 0x0002, 0x20be, 0x0024, 0x22bf, 0x0002, 0xc4de, 0x0044, 0x22ef,
    0x0002, 0x0096, 0x0014, 0x323f, 0x0003, 0xd4de, 0xf4fd, 0xfcff, 0x0014, 0x113e,
    0x0055, 0x888f, 0x0003, 0x32be, 0x0085, 0x00e7, 0x0025, 0x515e, 0xaafe, 0x727f,
    0x0003, 0x44ce, 0xf8fd, 0x44ef, 0x0014, 0x647e, 0x0045, 0xa2af, 0x0003, 0x00a6,
    0x555d, 0x99df, 0xf1fd, 0x0036, 0xf5fe, 0x626f, 0x0003, 0xd1de, 0xf4fd, 0xe6ff,
    0x0014, 0x717e, 0x0055, 0xb1bf, 0x0003, 0x88ae, 0x0085, 0xd5df, 0x0025, 0x444e,
    0xf2fe, 0x667f, 0x0003, 0x00c6, 0xf8fd, 0xe2ef, 0x0014, 0x545e, 0x0045, 0x119f,
    0x0003, 0x0096, 0x555d, 0xc8cf, 0xf1fd, 0x111e, 0xc8ee, 0x0067, 0x0003, 0xd4de,
    0xf4fd, 0xf3ff, 0x0014, 0x113e, 0x0055, 0x11bf, 0x0003, 0x32be, 0x0085, 0xd8df,
    0x0025, 0x515e, 0xaafe, 0x222f, 0x0003, 0x44ce, 0xf8fd, 0x00f7, 0x0014, 0x647e,
    0x0045, 0x989f, 0x0003, 0x00a6, 0x555d, 0x00d7, 0xf1fd, 0x0036, 0xf5fe, 0x446f,
    0x0003, 0xd1de, 0xf4fd, 0xb9ff, 0x0014, 0x717e, 0x0055, 0x00b7, 0x0003, 0x88ae,
    0x0085, 0xdcdf, 0x0025, 0x444e, 0xf2fe, 0x0077, 0x0003, 0x00c6, 0xf8fd, 0xe4ef,
    0x0014, 0x545e, 0x0045, 0x737f, 0x0003, 0x0096, 0x555d, 0xb8bf, 0xf1fd, 0x111e,
    0xc8ee, 0x323f, 0x0002, 0x00a5, 0x0084, 0x407e, 0x0002, 0x10de, 0x0024, 0x11df,
    0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae, 0x0014, 0xb2bf, 0x0002, 0x0096,
    0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00e7, 0x0002, 0xc8ee, 0x0044, 0x222e,
    0x0002, 0x888e, 0x0014, 0x0077, 0x0002, 0x00a5, 0x0084, 0x006e, 0x0002, 0x88ce,
    0x0024, 0x00f7, 0x0002, 0x91fe, 0x0044, 0x0036, 0x0002, 0xa2ae, 0x0014, 0xaaaf,
    0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be, 0x0024, 0xc4cf, 0x0002, 0x44ee,
    0x0044, 0xf4ff, 0x0002, 0x223e, 0x0014, 0x111f, 0x0002, 0x00a5, 0x0084, 0x407e,
    0x0002, 0x10de, 0x0024, 0x99ff, 0x0002, 0x72fe, 0x0044, 0x0056, 0x0002, 0xa8ae,
    0x0014, 0x00b7, 0x0002, 0x0096, 0x0084, 0x0066, 0x0002, 0x00c6, 0x0024, 0x00d7,
    0x0002, 0xc8ee, 0x0044, 0x222e, 0x0002, 0x888e, 0x0014, 0x444f, 0x0002, 0x00a5,
    0x0084, 0x006e, 0x0002, 0x88ce, 0x0024, 0xe2ef, 0x0002, 0x91fe, 0x0044, 0x0036,
    0x0002, 0xa2ae, 0x0014, 0x447f, 0x0002, 0xb8fe, 0x0084, 0x005e, 0x0002, 0x00be,
    0x0024, 0x009f, 0x0002, 0x44ee, 0x0044, 0x76ff, 0x0002, 0x223e, 0x0014, 0x313f,
    0x0003, 0x00c6, 0x0085, 0xd9ff, 0xf2fd, 0x647e, 0xf1fe, 0x99bf, 0x0003, 0xa2ae,
    0x0025, 0x66ef, 0xf4fd, 0x0056, 0xe2ee, 0x737f, 0x0003, 0x98be, 0x0045, 0x00f7,
    0xf8fd, 0x0066, 0x76fe, 0x889f, 0x0003, 0x888e, 0x0015, 0xd5df, 0x00a5, 0x222e,
    0x98de, 0x444f, 0x0003, 0xb2be, 0x0085, 0xfcff, 0xf2fd, 0x226e, 0x0096, 0x00b7,
    0x0003, 0xaaae, 0x0025, 0xd1df, 0xf4fd, 0x0036, 0xd4de, 0x646f, 0x0003, 0xa8ae,
    0x0045, 0xeaef, 0xf8fd, 0x445e, 0xe8ee, 0x717f, 0x0003, 0x323e, 0x0015, 0xc4cf,
    0x00a5, 0xfaff, 0x88ce, 0x313f, 0x0003, 0x00c6, 0x0085, 0x77ff, 0xf2fd, 0x647e,
    0xf1fe, 0xb3bf, 0x0003, 0xa2ae, 0x0025, 0x00e7, 0xf4fd, 0x0056, 0xe2ee, 0x0077,
    0x0003, 0x98be, 0x0045, 0xe4ef, 0xf8fd, 0x0066, 0x76fe, 0x667f, 0x0003, 0x888e,
    0x0015, 0x00d7, 0x00a5, 0x222e, 0x98de, 0x333f, 0x0003, 0xb2be, 0x0085, 0x75ff,
    0xf2fd, 0x226e, 0x0096, 0x919f, 0x0003, 0xaaae, 0x0025, 0x99df, 0xf4fd, 0x0036,
    0xd4de, 0x515f, 0x0003, 0xa8ae, 0x0045, 0xecef, 0xf8fd, 0x445e, 0xe8ee, 0x727f,
    0x0003, 0x323e, 0x0015, 0xb1bf, 0x00a5, 0xf3ff, 0x88ce, 0x111f, 0x0003, 0x54de,
    0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0xcccf, 0x0003, 0x91be, 0x0045, 0x22ef,
    0x0025, 0x222e, 0xf3fe, 0x888f, 0x0003, 0x00c6, 0x0085, 0x00f7, 0x0014, 0x115e,
    0xfcfe, 0xa8af, 0x0003, 0x00a6, 0x0035, 0xc8df, 0xf1fd, 0x313e, 0x66fe, 0x646f,
    0x0003, 0xc8ce, 0xf2fd, 0xf5ff, 0x0014, 0x0066, 0xf4fe, 0xbabf, 0x0003, 0x22ae,
    0x0045, 0x00e7, 0x0025, 0x323e, 0xeafe, 0x737f, 0x0003, 0xb2be, 0x0085, 0x55df,
    0x0014, 0x0056, 0x717e, 0x119f, 0x0003, 0x0096, 0x0035, 0xc4cf, 0xf1fd, 0x333e,
    0xe8ee, 0x444f, 0x0003, 0x54de, 0xf2fd, 0x111e, 0x0014, 0x647e, 0xf8fe, 0x99bf,
    0x0003, 0x91be, 0x0045, 0xe2ef, 0x0025, 0x222e, 0xf3fe, 0x667f, 0x0003, 0x00c6,
    0x0085, 0xe4ef, 0x0014, 0x115e, 0xfcfe, 0x989f, 0x0003, 0x00a6, 0x0035, 0x00d7,
    0xf1fd, 0x313e, 0x66fe, 0x226f, 0x0003, 0xc8ce, 0xf2fd, 0xb9ff, 0x0014, 0x0066,
    0xf4fe, 0x00b7, 0x0003, 0x22ae, 0x0045, 0xd1df, 0x0025, 0x323e, 0xeafe, 0x0077,
    0x0003, 0xb2be, 0x0085, 0xecef, 0x0014, 0x0056, 0x717e, 0x727f, 0x0003, 0x0096,
    0x0035, 0xb8bf, 0xf1fd, 0x333e, 0xe8ee, 0x545f, 0xf1fc, 0xd1de, 0xfafd, 0x00d7,
    0xf8fc, 0x0016, 0xfffd, 0x747f, 0xf4fc, 0x717e, 0xf3fd, 0xb3bf, 0xf2fc, 0xeaef,
    0xe8ee, 0x444f, 0xf1fc, 0x22ae, 0x0005, 0xb8bf, 0xf8fc, 0x00f7, 0xfcfe, 0x0077,
    0xf4fc, 0x115e, 0xf5fd, 0x757f, 0xf2fc, 0xd8df, 0xe2ee, 0x333f, 0xf1fc, 0xb2be,
    0xfafd, 0x88cf, 0xf8fc, 0xfbff, 0xfffd, 0x737f, 0xf4fc, 0x006e, 0xf3fd, 0x00b7,
    0xf2fc, 0x66ef, 0xf9fe, 0x313f, 0xf1fc, 0x009e, 0x0005, 0xbabf, 0xf8fc, 0xfdff,
    0xf6fe, 0x0067, 0xf4fc, 0x0026, 0xf5fd, 0x888f, 0xf2fc, 0xdcdf, 0xd4de, 0x222f,
    0xf1fc, 0xd1de, 0xfafd, 0xc4cf, 0xf8fc, 0x0016, 0xfffd, 0x727f, 0xf4fc, 0x717e,
    0xf3fd, 0x99bf, 0xf2fc, 0xecef, 0xe8ee, 0x0047, 0xf1fc, 0x22ae, 0x0005, 0x00a7,
    0xf8fc, 0xf7ff, 0xfcfe, 0x0057, 0xf4fc, 0x115e, 0xf5fd, 0x0097, 0xf2fc, 0xd5df,
    0xe2ee, 0x0037, 0xf1fc, 0xb2be, 0xfafd, 0x00c7, 0xf8fc, 0xfeff, 0xfffd, 0x667f,
    0xf4fc, 0x006e, 0xf3fd, 0xa8af, 0xf2fc, 0x00e7, 0xf9fe, 0x323f, 0xf1fc, 0x009e,
    0x0005, 0xb1bf, 0xf8fc, 0xe4ef, 0xf6fe, 0x545f, 0xf4fc, 0x0026, 0xf5fd, 0x0087,
    0xf2fc, 0x99df, 0xd4de, 0x111f,
};
const uint16_t kHtVlc1[1024] = {
    0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d, 0x0023, 0x444e, 0x0013, 0x00a5,
    0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x00d7, 0x0013, 0x00c5, 0x0043, 0x009e,
    0x0083, 0x0055, 0x0023, 0x222e, 0x0013, 0x0095, 0x0043, 0x007e, 0x0083, 0x10fe,
    0x0023, 0x0077, 0x0013, 0x0065, 0x0043, 0x88ce, 0x0083, 0x888d, 0x0023, 0x111e,
    0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035, 0x0023, 0x00e7, 0x0013, 0x00c5,
    0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x11ff, 0x0013, 0x0095, 0x0043, 0x003e,
    0x0083, 0x40ee, 0x0023, 0xa2af, 0x0013, 0x0065, 0x0043, 0x00de, 0x0083, 0x888d,
    0x0023, 0x444e, 0x0013, 0x00a5, 0x0043, 0x88ae, 0x0083, 0x0035, 0x0023, 0x44ef,
    0x0013, 0x00c5, 0x0043, 0x009e, 0x0083, 0x0055, 0x0023, 0x222e, 0x0013, 0x0095,
    0x0043, 0x007e, 0x0083, 0x10fe, 0x0023, 0x00b7, 0x0013, 0x0065, 0x0043, 0x88ce,
    0x0083, 0x888d, 0x0023, 0x111e, 0x0013, 0x00a5, 0x0043, 0x005e, 0x0083, 0x0035,
    0x0023, 0xc4cf, 0x0013, 0x00c5, 0x0043, 0x00be, 0x0083, 0x0055, 0x0023, 0x00f7,
    0x0013, 0x0095, 0x0043, 0x003e, 0x0083, 0x40ee, 0x0023, 0x006f, 0x0001, 0x0084,
    0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00d7, 0x0001, 0x0024, 0x0001, 0x0096,
    0x0001, 0x0045, 0x0001, 0x0077, 0x0001, 0x0084, 0x0001, 0x00c6, 0x0001, 0x0014,
    0x0001, 0x888f, 0x0001, 0x0024, 0x0001, 0x00f7, 0x0001, 0x0035, 0x0001, 0x222f,
    0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014, 0x0001, 0x00b7, 0x0001, 0x0024,
    0x0001, 0x00bf, 0x0001, 0x0045, 0x0001, 0x0067, 0x0001, 0x0084, 0x0001, 0x00a6,
    0x0001, 0x0014, 0x0001, 0x444f, 0x0001, 0x0024, 0x0001, 0x00e7, 0x0001, 0x0035,
    0x0001, 0x113f, 0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0014, 0x0001, 0x00cf,
    0x0001, 0x0024, 0x0001, 0x0096, 0x0001, 0x0045, 0x0001, 0x006f, 0x0001, 0x0084,
    0x0001, 0x00c6, 0x0001, 0x0014, 0x0001, 0x009f, 0x0001, 0x0024, 0x0001, 0x00ef,
    0x0001, 0x0035, 0x0001, 0x323f, 0x0001, 0x0084, 0x0001, 0x40fe, 0x0001, 0x0014,
    0x0001, 0x00af, 0x0001, 0x0024, 0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x005f,
    0x0001, 0x0084, 0x0001, 0x00a6, 0x0001, 0x0014, 0x0001, 0x007f, 0x0001, 0x0024,
    0x0001, 0x00df, 0x0001, 0x0035, 0x0001, 0x111f, 0x0001, 0x0024, 0x0001, 0x0056,
    0x0001, 0x0085, 0x0001, 0x00bf, 0x0001, 0x0014, 0x0001, 0x00f7, 0x0001, 0x00c6,
    0x0001, 0x0077, 0x0001, 0x0024, 0x0001, 0xf8ff, 0x0001, 0x0045, 0x0001, 0x007f,
    0x0001, 0x0014, 0x0001, 0x00df, 0x0001, 0x00a6, 0x0001, 0x313f, 0x0001, 0x0024,
    0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0x00b7, 0x0001, 0x0014, 0x0001, 0x44ef,
    0x0001, 0xa2ae, 0x0001, 0x0067, 0x0001, 0x0024, 0x0001, 0x51ff, 0x0001, 0x0045,
    0x0001, 0x0097, 0x0001, 0x0014, 0x0001, 0x00cf, 0x0001, 0x0036, 0x0001, 0x223f,
    0x0001, 0x0024, 0x0001, 0x0056, 0x0001, 0x0085, 0x0001, 0xb2bf, 0x0001, 0x0014,
    0x0001, 0x40ef, 0x0001, 0x00c6, 0x0001, 0x006f, 0x0001, 0x0024, 0x0001, 0x72ff,
    0x0001, 0x0045, 0x0001, 0x009f, 0x0001, 0x0014, 0x0001, 0x00d7, 0x0001, 0x00a6,
    0x0001, 0x444f, 0x0001, 0x0024, 0x0001, 0x222e, 0x0001, 0x0085, 0x0001, 0xa8af,
    0x0001, 0x0014, 0x0001, 0x00e7, 0x0001, 0xa2ae, 0x0001, 0x005f, 0x0001, 0x0024,
    0x0001, 0x44ff, 0x0001, 0x0045, 0x0001, 0x888f, 0x0001, 0x0014, 0x0001, 0xaaaf,
    0x0001, 0x0036, 0x0001, 0x111f, 0x0002, 0xf8fe, 0x0024, 0x0056, 0x0002, 0x00b6,
    0x0085, 0x66ff, 0x0002, 0x00ce, 0x0014, 0x111e, 0x0002, 0x0096, 0x0035, 0xa8af,
    0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6, 0x0045, 0xb3bf, 0x0002, 0xb2be,
    0x0014, 0xf5ff, 0x0002, 0x0066, 0x517e, 0x545f, 0x0002, 0xf2fe, 0x0024, 0x222e,
    0x0002, 0x22ae, 0x0085, 0x44ef, 0x0002, 0x00c6, 0x0014, 0xf4ff, 0x0002, 0x0076,
    0x0035, 0x447f, 0x0002, 0x40de, 0x0024, 0x323e, 0x0002, 0x009e, 0x0045, 0x00d7,
    0x0002, 0x88be, 0x0014, 0xfaff, 0x0002, 0x115e, 0xf1fe, 0x444f, 0x0002, 0xf8fe,
    0x0024, 0x0056, 0x0002, 0x00b6, 0x0085, 0xc8ef, 0x0002, 0x00ce, 0x0014, 0x111e,
    0x0002, 0x0096, 0x0035, 0x888f, 0x0002, 0x00f6, 0x0024, 0x313e, 0x0002, 0x00a6,
    0x0045, 0x44df, 0x0002, 0xb2be, 0x0014, 0xa8ff, 0x0002, 0x0066, 0x517e, 0x006f,
    0x0002, 0xf2fe, 0x0024, 0x222e, 0x0002, 0x22ae, 0x0085, 0x00e7, 0x0002, 0x00c6,
    0x0014, 0xe2ef, 0x0002, 0x0076, 0x0035, 0x727f, 0x0002, 0x40de, 0x0024, 0x323e,
    0x0002, 0x009e, 0x0045, 0xb1bf, 0x0002, 0x88be, 0x0014, 0x73ff, 0x0002, 0x115e,
    0xf1fe, 0x333f, 0x0001, 0x0084, 0x0001, 0x20ee, 0x0001, 0x00c5, 0x0001, 0xc4cf,
    0x0001, 0x0044, 0x0001, 0x32ff, 0x0001, 0x0015, 0x0001, 0x888f, 0x0001, 0x0084,
    0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x00af, 0x0001, 0x0044, 0x0001, 0x22ef,
    0x0001, 0x00a6, 0x0001, 0x005f, 0x0001, 0x0084, 0x0001, 0x444e, 0x0001, 0x00c5,
    0x0001, 0xcccf, 0x0001, 0x0044, 0x0001, 0x00f7, 0x0001, 0x0015, 0x0001, 0x006f,
    0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025, 0x0001, 0x009f, 0x0001, 0x0044,
    0x0001, 0x00df, 0x0001, 0x30fe, 0x0001, 0x222f, 0x0001, 0x0084, 0x0001, 0x20ee,
    0x0001, 0x00c5, 0x0001, 0xc8cf, 0x0001, 0x0044, 0x0001, 0x11ff, 0x0001, 0x0015,
    0x0001, 0x0077, 0x0001, 0x0084, 0x0001, 0x0066, 0x0001, 0x0025, 0x0001, 0x007f,
    0x0001, 0x0044, 0x0001, 0x00e7, 0x0001, 0x00a6, 0x0001, 0x0037, 0x0001, 0x0084,
    0x0001, 0x444e, 0x0001, 0x00c5, 0x0001, 0x00b7, 0x0001, 0x0044, 0x0001, 0x00bf,
    0x0001, 0x0015, 0x0001, 0x003f, 0x0001, 0x0084, 0x0001, 0x0056, 0x0001, 0x0025,
    0x0001, 0x0097, 0x0001, 0x0044, 0x0001, 0x00d7, 0x0001, 0x30fe, 0x0001, 0x111f,
    0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6, 0x00c5, 0xf3ff, 0x0002, 0xfcfe,
    0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0xd8df, 0x0002, 0xf8fe, 0x0044, 0x0066,
    0x0002, 0x207e, 0x0085, 0x99ff, 0x0002, 0x00e6, 0x00f5, 0x0036, 0x0002, 0x00a6,
    0x0015, 0x009f, 0x0002, 0xf2fe, 0x0044, 0x0076, 0x0002, 0x44ce, 0x00c5, 0x76ff,
    0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae, 0x0055, 0xc8cf, 0x0002, 0xf4fe,
    0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0xe4ef, 0x0002, 0x54de, 0x00f5, 0x111e,
    0x0002, 0x0096, 0x0015, 0x222f, 0x0002, 0xa8ee, 0x0044, 0x888e, 0x0002, 0x00d6,
    0x00c5, 0xfaff, 0x0002, 0xfcfe, 0x0025, 0x003e, 0x0002, 0x00b6, 0x0055, 0x11bf,
    0x0002, 0xf8fe, 0x0044, 0x0066, 0x0002, 0x207e, 0x0085, 0x22ef, 0x0002, 0x00e6,
    0x00f5, 0x0036, 0x0002, 0x00a6, 0x0015, 0x227f, 0x0002, 0xf2fe, 0x0044, 0x0076,
    0x0002, 0x44ce, 0x00c5, 0xd5ff, 0x0002, 0xf1fe, 0x0025, 0x444e, 0x0002, 0x00ae,
    0x0055, 0x006f, 0x0002, 0xf4fe, 0x0044, 0x445e, 0x0002, 0x10be, 0x0085, 0x11df,
    0x0002, 0x54de, 0x00f5, 0x111e, 0x0002, 0x0096, 0x0015, 0x515f, 0x0003, 0x00f6,
    0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xd4df, 0x0003, 0xa2ae, 0x0055, 0x76ff,
    0x0024, 0x223e, 0x00b6, 0xaaaf, 0x0003, 0x00e6, 0x0014, 0xf5ff, 0x0044, 0x0066,
    0x0085, 0xcccf, 0x0003, 0x009e, 0x00c5, 0x44ef, 0x0024, 0x0036, 0xf8fe, 0x317f,
    0x0003, 0xe8ee, 0x0014, 0xf1ff, 0x0044, 0x0076, 0x00a5, 0xc4cf, 0x0003, 0x227e,
    0x0055, 0xd1df, 0x0024, 0x444e, 0xf4fe, 0x515f, 0x0003, 0x00d6, 0x0014, 0xe2ef,
    0x0044, 0x445e, 0x0085, 0x22bf, 0x0003, 0x0096, 0x00c5, 0xc8df, 0x0024, 0x222e,
    0xf2fe, 0x226f, 0x0003, 0x00f6, 0x0014, 0x111e, 0x0044, 0x888e, 0x00a5, 0xb1bf,
    0x0003, 0xa2ae, 0x0055, 0x33ff, 0x0024, 0x223e, 0x00b6, 0xa8af, 0x0003, 0x00e6,
    0x0014, 0xb9ff, 0x0044, 0x0066, 0x0085, 0xa8bf, 0x0003, 0x009e, 0x00c5, 0xe4ef,
    0x0024, 0x0036, 0xf8fe, 0x646f, 0x0003, 0xe8ee, 0x0014, 0xfcff, 0x0044, 0x0076,
    0x00a5, 0xc8cf, 0x0003, 0x227e, 0x0055, 0xeaef, 0x0024, 0x444e, 0xf4fe, 0x747f,
    0x0003, 0x00d6, 0x0014, 0xfaff, 0x0044, 0x445e, 0x0085, 0xb2bf, 0x0003, 0x0096,
    0x00c5, 0x44df, 0x0024, 0x222e, 0xf2fe, 0x313f, 0x00f3, 0xfafe, 0xf1fd, 0x0036,
    0x0004, 0x32be, 0x0075, 0x11df, 0x00f3, 0x54de, 0xf2fd, 0xe4ef, 0x00d5, 0x717e,
    0xfcfe, 0x737f, 0x00f3, 0xf3fe, 0xf8fd, 0x111e, 0x0004, 0x0096, 0x0055, 0xb1bf,
    0x00f3, 0x00ce, 0x00b5, 0xd8df, 0xf4fd, 0x0066, 0xb9fe, 0x545f, 0x00f3, 0x76fe,
    0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x009f, 0x00f3, 0x00ae, 0xf2fd, 0xf7ff,
    0x00d5, 0x0046, 0xf5fe, 0x747f, 0x00f3, 0x00e6, 0xf8fd, 0x0016, 0x0004, 0x0086,
    0x0055, 0x888f, 0x00f3, 0x00c6, 0x00b5, 0xe2ef, 0xf4fd, 0x115e, 0xa8ee, 0x113f,
    0x00f3, 0xfafe, 0xf1fd, 0x0036, 0x0004, 0x32be, 0x0075, 0xd1df, 0x00f3, 0x54de,
    0xf2fd, 0xfbff, 0x00d5, 0x717e, 0xfcfe, 0x447f, 0x00f3, 0xf3fe, 0xf8fd, 0x111e,
    0x0004, 0x0096, 0x0055, 0x727f, 0x00f3, 0x00ce, 0x00b5, 0x22ef, 0xf4fd, 0x0066,
    0xb9fe, 0x444f, 0x00f3, 0x76fe, 0xf1fd, 0x0026, 0x0004, 0x00a6, 0x0075, 0x11bf,
    0x00f3, 0x00ae, 0xf2fd, 0xffff, 0x00d5, 0x0046, 0xf5fe, 0x323f, 0x00f3, 0x00e6,
    0xf8fd, 0x0016, 0x0004, 0x0086, 0x0055, 0x006f, 0x00f3, 0x00c6, 0x00b5, 0xb8bf,
    0xf4fd, 0x115e, 0xa8ee, 0x222f,
};

inline u32 rd_le32(const u8* p) {
    return (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) | ((u32)p[3] << 24);
}

inline u32 popcount32(u32 v) { return (u32)__builtin_popcount(v); }
inline u32 clz32(u32 v) { return v ? (u32)__builtin_clz(v) : 32u; }

// MEL: forward, MSB first, a 0xFF byte's successor loses its MSB; the
// suffix's last byte has its low nibble (Scup's) read as 0xF; 0xFF past it
struct HtMel {
    const u8* data;
    uint64_t tmp;
    int bits, size;
    bool unstuff;
    int k, num_runs;
    uint64_t runs;
};

void mel_read(HtMel& m) {
    if (m.bits > 32) return;
    u32 val = 0xFFFFFFFFu;
    if (m.size > 4) {
        val = rd_le32(m.data);
        m.data += 4;
        m.size -= 4;
    } else if (m.size > 0) {
        int i = 0;
        while (m.size > 1) {
            u32 v = *m.data++;
            u32 msk = ~(0xFFu << i);
            val = (val & msk) | (v << i);
            --m.size;
            i += 8;
        }
        u32 v = *m.data++;
        v |= 0xF;
        u32 msk = ~(0xFFu << i);
        val = (val & msk) | (v << i);
        --m.size;
    }
    int bits = 32 - (int)m.unstuff;
    u32 t = val & 0xFF;
    bool unstuff = (val & 0xFF) == 0xFF;
    bits -= (int)unstuff;
    t = t << (8 - (int)unstuff);
    t |= (val >> 8) & 0xFF;
    unstuff = ((val >> 8) & 0xFF) == 0xFF;
    bits -= (int)unstuff;
    t = t << (8 - (int)unstuff);
    t |= (val >> 16) & 0xFF;
    unstuff = ((val >> 16) & 0xFF) == 0xFF;
    bits -= (int)unstuff;
    t = t << (8 - (int)unstuff);
    t |= (val >> 24) & 0xFF;
    m.unstuff = ((val >> 24) & 0xFF) == 0xFF;
    m.tmp |= (uint64_t)t << (64 - bits - m.bits);
    m.bits += bits;
}

// false: a 0xFF then a byte over 0x8F among the first bytes OpenJPEG
// reads one at a time (up to the data's next 4-byte boundary)
bool mel_init(HtMel& m, const u8* buf, int lcup, int scup) {
    m.data = buf + lcup - scup;
    m.bits = 0;
    m.tmp = 0;
    m.unstuff = false;
    m.size = scup - 1;
    m.k = 0;
    m.num_runs = 0;
    m.runs = 0;
    int num = 4 - (int)((uintptr_t)m.data & 3);
    for (int i = 0; i < num; ++i) {
        if (m.unstuff && m.data[0] > 0x8F) return false;
        uint64_t d = m.size > 0 ? *m.data : 0xFF;
        if (m.size == 1) d |= 0xF;
        m.data += m.size-- > 0;
        int d_bits = 8 - (int)m.unstuff;
        m.tmp = (m.tmp << d_bits) | d;
        m.bits += d_bits;
        m.unstuff = (d & 0xFF) == 0xFF;
    }
    m.tmp <<= (64 - m.bits);
    return true;
}

void mel_decode(HtMel& m) {
    static const int mel_exp[13] = {0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5};
    if (m.bits < 6) mel_read(m);
    while (m.bits >= 6 && m.num_runs < 8) {
        int eval = mel_exp[m.k];
        int run;
        if (m.tmp & (1ull << 63)) {
            run = (1 << eval) - 1;
            m.k = m.k + 1 < 12 ? m.k + 1 : 12;
            m.tmp <<= 1;
            m.bits -= 1;
            run = run << 1;
        } else {
            run = (int)(m.tmp >> (63 - eval)) & ((1 << eval) - 1);
            m.k = m.k - 1 > 0 ? m.k - 1 : 0;
            m.tmp <<= eval + 1;
            m.bits -= eval + 1;
            run = (run << 1) + 1;
        }
        int at = m.num_runs * 7;
        m.runs &= ~((uint64_t)0x3F << at);
        m.runs |= (uint64_t)run << at;
        m.num_runs++;
    }
}

int mel_get_run(HtMel& m) {
    if (m.num_runs == 0) mel_decode(m);
    int t = (int)(m.runs & 0x7F);
    m.runs >>= 7;
    m.num_runs--;
    return t;
}

// VLC and MagRef: backward, LSB first; a byte whose predecessor is over 0x8F
// and whose low 7 bits are all set gives 7 bits; 0x00 past the start
struct HtRev {
    const u8* data;
    uint64_t tmp;
    u32 bits;
    int size;
    bool unstuff;
};

void rev_read(HtRev& v) {
    if (v.bits > 32) return;
    u32 val = 0;
    if (v.size > 3) {
        val = rd_le32(v.data - 3);
        v.data -= 4;
        v.size -= 4;
    } else if (v.size > 0) {
        int i = 24;
        while (v.size > 0) {
            u32 b = *v.data--;
            val |= b << i;
            --v.size;
            i -= 8;
        }
    }
    u32 tmp = val >> 24;
    u32 bits = 8u - ((v.unstuff && (((val >> 24) & 0x7F) == 0x7F)) ? 1u : 0u);
    bool unstuff = (val >> 24) > 0x8F;
    tmp |= ((val >> 16) & 0xFF) << bits;
    bits += 8u - ((unstuff && (((val >> 16) & 0x7F) == 0x7F)) ? 1u : 0u);
    unstuff = ((val >> 16) & 0xFF) > 0x8F;
    tmp |= ((val >> 8) & 0xFF) << bits;
    bits += 8u - ((unstuff && (((val >> 8) & 0x7F) == 0x7F)) ? 1u : 0u);
    unstuff = ((val >> 8) & 0xFF) > 0x8F;
    tmp |= (val & 0xFF) << bits;
    bits += 8u - ((unstuff && ((val & 0x7F) == 0x7F)) ? 1u : 0u);
    unstuff = (val & 0xFF) > 0x8F;
    v.tmp |= (uint64_t)tmp << v.bits;
    v.bits += bits;
    v.unstuff = unstuff;
}

// the VLC stream: from the upper nibble of the suffix's second-last byte
void rev_init(HtRev& v, const u8* data, int lcup, int scup) {
    v.data = data + lcup - 2;
    v.size = scup - 2;
    u32 d = *v.data--;
    v.tmp = d >> 4;
    v.bits = 4 - ((v.tmp & 7) == 7);
    v.unstuff = (d | 0xF) > 0x8F;
    int num = 1 + (int)((uintptr_t)v.data & 3);
    int tnum = num < v.size ? num : v.size;
    for (int i = 0; i < tnum; ++i) {
        uint64_t b = *v.data--;
        u32 d_bits = 8 - ((v.unstuff && ((b & 0x7F) == 0x7F)) ? 1 : 0);
        v.tmp |= b << v.bits;
        v.bits += d_bits;
        v.unstuff = b > 0x8F;
    }
    v.size -= tnum;
    rev_read(v);
}

// the MagRef stream: from the last byte of the second segment
void rev_init_mrp(HtRev& m, const u8* data, int lcup, int len2) {
    m.data = data + lcup + len2 - 1;
    m.size = len2;
    m.unstuff = true;
    m.bits = 0;
    m.tmp = 0;
    int num = 1 + (int)((uintptr_t)m.data & 3);
    for (int i = 0; i < num; ++i) {
        uint64_t d = (m.size-- > 0) ? *m.data-- : 0;
        u32 d_bits = 8 - ((m.unstuff && ((d & 0x7F) == 0x7F)) ? 1 : 0);
        m.tmp |= d << m.bits;
        m.bits += d_bits;
        m.unstuff = d > 0x8F;
    }
    rev_read(m);
}

u32 rev_fetch(HtRev& v) {
    if (v.bits < 32) {
        rev_read(v);
        if (v.bits < 32) rev_read(v);
    }
    return (u32)v.tmp;
}

u32 rev_advance(HtRev& v, u32 n) {
    v.tmp >>= n;
    v.bits -= n;
    return (u32)v.tmp;
}

// MagSgn and SigProp: forward, LSB first, a 0xFF byte's successor gives 7
// bits; X (0xFF for MagSgn, 0 for SigProp) past the end
struct HtFwd {
    const u8* data;
    uint64_t tmp;
    u32 bits;
    bool unstuff;
    int size;
    u32 X;
};

void frwd_read(HtFwd& f) {
    u32 val;
    if (f.size > 3) {
        val = rd_le32(f.data);
        f.data += 4;
        f.size -= 4;
    } else if (f.size > 0) {
        int i = 0;
        val = f.X != 0 ? 0xFFFFFFFFu : 0;
        while (f.size > 0) {
            u32 v = *f.data++;
            u32 m = ~(0xFFu << i);
            val = (val & m) | (v << i);
            --f.size;
            i += 8;
        }
    } else {
        val = f.X != 0 ? 0xFFFFFFFFu : 0;
    }
    u32 bits = 8u - (f.unstuff ? 1u : 0u);
    u32 t = val & 0xFF;
    bool unstuff = (val & 0xFF) == 0xFF;
    t |= ((val >> 8) & 0xFF) << bits;
    bits += 8u - (unstuff ? 1u : 0u);
    unstuff = ((val >> 8) & 0xFF) == 0xFF;
    t |= ((val >> 16) & 0xFF) << bits;
    bits += 8u - (unstuff ? 1u : 0u);
    unstuff = ((val >> 16) & 0xFF) == 0xFF;
    t |= ((val >> 24) & 0xFF) << bits;
    bits += 8u - (unstuff ? 1u : 0u);
    f.unstuff = ((val >> 24) & 0xFF) == 0xFF;
    f.tmp |= (uint64_t)t << f.bits;
    f.bits += bits;
}

void frwd_init(HtFwd& f, const u8* data, int size, u32 X) {
    f.data = data;
    f.tmp = 0;
    f.bits = 0;
    f.unstuff = false;
    f.size = size;
    f.X = X;
    int num = 4 - (int)((uintptr_t)data & 3);
    for (int i = 0; i < num; ++i) {
        uint64_t d = f.size-- > 0 ? *f.data++ : f.X;
        f.tmp |= d << f.bits;
        f.bits += 8u - (f.unstuff ? 1u : 0u);
        f.unstuff = (d & 0xFF) == 0xFF;
    }
    frwd_read(f);
}

u32 frwd_fetch(HtFwd& f) {
    if (f.bits < 32) {
        frwd_read(f);
        if (f.bits < 32) frwd_read(f);
    }
    return (u32)f.tmp;
}

void frwd_advance(HtFwd& f, u32 n) {
    f.tmp >>= n;
    f.bits -= n;
}

// u for a quad pair, kappa 1 (the rows below add their E term later);
// returns the bits used.  mode: the pair's u_off bits; in the first row
// both set read a MEL event first (mode 4 when it is 1: each u past 2),
// and with the event 0 a first u past 2 leaves the second one bit
u32 decode_uvlc(u32 vlc, u32 mode, u32* u, bool first) {
    // per 3-bit prefix: prefix length (2 bits), suffix length (3), u_pfx (3)
    static const u8 dec[8] = {
        3 | (5 << 2) | (5 << 5), 1 | (0 << 2) | (1 << 5),
        2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5),
        3 | (1 << 2) | (3 << 5), 1 | (0 << 2) | (1 << 5),
        2 | (0 << 2) | (2 << 5), 1 | (0 << 2) | (1 << 5)};
    u32 consumed = 0;
    if (mode == 0) {
        u[0] = u[1] = 1;
    } else if (mode <= 2) {
        u32 d = dec[vlc & 0x7];
        vlc >>= d & 0x3;
        consumed += d & 0x3;
        u32 sl = (d >> 2) & 0x7;
        consumed += sl;
        d = (d >> 5) + (vlc & ((1U << sl) - 1));
        u[0] = (mode == 1) ? d + 1 : 1;
        u[1] = (mode == 1) ? 1 : d + 1;
    } else if (first && mode == 3 && (dec[vlc & 0x7] & 0x3) > 2) {
        u32 d1 = dec[vlc & 0x7];
        vlc >>= d1 & 0x3;
        consumed += d1 & 0x3;
        u[1] = (vlc & 1) + 1 + 1;
        ++consumed;
        vlc >>= 1;
        u32 sl = (d1 >> 2) & 0x7;
        consumed += sl;
        d1 = (d1 >> 5) + (vlc & ((1U << sl) - 1));
        u[0] = d1 + 1;
    } else if (mode <= 4) {
        u32 add = first && mode == 4 ? 3 : 1;
        u32 d1 = dec[vlc & 0x7];
        vlc >>= d1 & 0x3;
        consumed += d1 & 0x3;
        u32 d2 = dec[vlc & 0x7];
        vlc >>= d2 & 0x3;
        consumed += d2 & 0x3;
        u32 sl = (d1 >> 2) & 0x7;
        consumed += sl;
        d1 = (d1 >> 5) + (vlc & ((1U << sl) - 1));
        u[0] = d1 + add;
        vlc >>= sl;
        sl = (d2 >> 2) & 0x7;
        consumed += sl;
        d2 = (d2 >> 5) + (vlc & ((1U << sl) - 1));
        u[1] = d2 + add;
    }
    return consumed;
}

// one significant sample of a quad: n its position (0-3), q the quad's
// info, U its exponent bound; the value, sign-magnitude, at bit p - 1
inline u32 ht_sample(HtFwd& ms, u32 q, u32 n, u32 U, u32 p, u32* vn_out) {
    u32 ms_val = frwd_fetch(ms);
    u32 m_n = U - ((q >> (12 + n)) & 1);
    frwd_advance(ms, m_n);
    u32 val = ms_val << 31;
    u32 v_n = ms_val & ((1U << m_n) - 1);
    v_n |= ((q >> (8 + n)) & 1) << m_n;
    v_n |= 1;
    *vn_out = v_n;
    return val | ((v_n + 2) << (p - 1));
}

// a stripe's MagRef bits: sig the significance of its rows (4 a nibble, 8
// columns a word), dpp its first row
void ht_magref(HtRev& magref, const u32* cur_sig, u32* dpp, i32 width, i32 stride, u32 p) {
    u32 half = 1u << (p - 2);
    for (i32 i = 0; i < width; i += 8) {
        u32 cwd = rev_fetch(magref);
        u32 sig = *cur_sig++;
        u32 col_mask = 0xFu;
        u32* dp = dpp + i;
        if (sig) {
            for (int j = 0; j < 8; ++j, dp++) {
                if (sig & col_mask) {
                    u32 sample_mask = 0x11111111u & col_mask;
                    for (int r = 0; r < 4; ++r) {
                        if (sig & sample_mask) {
                            u32 sym = cwd & 1;
                            dp[r * stride] ^= (1 - sym) << (p - 1);
                            dp[r * stride] |= half;
                            cwd >>= 1;
                        }
                        sample_mask += sample_mask;
                    }
                }
                col_mask <<= 4;
            }
        }
        rev_advance(magref, popcount32(sig));
    }
}

// a stripe's membership from its own significance: its 8 neighbours
void ht_stripe_mbr(const u32* sig, u32* mbr, i32 width) {
    u32 prev = 0;
    for (i32 i = 0; i < width; i += 8, mbr++, sig++) {
        mbr[0] = sig[0];
        mbr[0] |= prev >> 28;
        mbr[0] |= sig[0] << 4;
        mbr[0] |= sig[0] >> 4;
        mbr[0] |= sig[1] << 28;
        prev = sig[0];
        u32 t = mbr[0], z = mbr[0];
        z |= (t & 0x77777777) << 1;
        z |= (t & 0xEEEEEEEE) >> 1;
        mbr[0] = z & ~sig[0];
    }
}

// the next stripe's first row joins this stripe's membership (not under
// the vertically causal style); then the known significant samples leave
void ht_mbr_from_next(const u32* cur_sig, u32* cur_mbr, const u32* nxt_sig, i32 width,
                      bool stripe_causal) {
    u32 prev = 0;
    for (i32 i = 0; i < width; i += 8, cur_mbr++, cur_sig++, nxt_sig++) {
        u32 t = nxt_sig[0];
        t |= prev >> 28;
        t |= nxt_sig[0] << 4;
        t |= nxt_sig[0] >> 4;
        t |= nxt_sig[1] << 28;
        prev = nxt_sig[0];
        if (!stripe_causal) cur_mbr[0] |= (t & 0x11111111u) << 3;
        cur_mbr[0] &= ~cur_sig[0];
    }
}

// a stripe's SigProp: the members' significance bits, each half-group's
// signs after its bits; new samples pass membership on in scan order and
// to the next stripe's first row
void ht_sigprop(HtFwd& sigprop, u32* cur_sig, u32* cur_mbr, u32* nxt_sig, u32* nxt_mbr,
                u32* dp0, i32 width, i32 stride, u32 p, u32 pattern) {
    u32 val = 3u << (p - 2);
    for (i32 i = 0; i < width; i += 8, cur_sig++, cur_mbr++, nxt_sig++, nxt_mbr++) {
        u32 mbr = *cur_mbr & pattern;
        u32 new_sig = 0;
        if (mbr) {
            for (i32 n = 0; n < 8; n += 4) {
                u32 cwd = frwd_fetch(sigprop);
                u32 cnt = 0;
                u32* dp = dp0 + i + n;
                u32 col_mask = 0xFu << (4 * n);
                u32 inv_sig = ~cur_sig[0] & pattern;
                i32 end = n + 4 + i < width ? n + 4 : width - i;
                static const u32 prop[4] = {0x32u, 0x74u, 0xE8u, 0xC0u};
                for (i32 j = n; j < end; ++j, ++dp, col_mask <<= 4) {
                    if ((col_mask & mbr) == 0) continue;
                    u32 sample_mask = 0x11111111u & col_mask;
                    for (int r = 0; r < 4; ++r) {
                        if (mbr & sample_mask) {
                            if (cwd & 1) {
                                new_sig |= sample_mask;
                                u32 t = prop[r] << (j * 4);
                                mbr |= t & inv_sig;
                            }
                            cwd >>= 1;
                            ++cnt;
                        }
                        sample_mask += sample_mask;
                    }
                }
                if (new_sig & (0xFFFFu << (4 * n))) {
                    u32* sp = dp0 + i + n;
                    u32 cm = 0xFu << (4 * n);
                    for (i32 j = n; j < end; ++j, ++sp, cm <<= 4) {
                        if ((cm & new_sig) == 0) continue;
                        u32 sample_mask = 0x11111111u & cm;
                        for (int r = 0; r < 4; ++r) {
                            if (new_sig & sample_mask) {
                                sp[r * stride] |= ((cwd & 1) << 31) | val;
                                cwd >>= 1;
                                ++cnt;
                            }
                            sample_mask += sample_mask;
                        }
                    }
                }
                frwd_advance(sigprop, cnt);
                if (n == 4) {
                    u32 t = new_sig >> 28;
                    t |= ((t & 0xE) >> 1) | ((t & 7) << 1);
                    cur_mbr[1] |= t & ~cur_sig[1];
                }
            }
        }
        new_sig |= cur_sig[0];
        u32 ux = (new_sig & 0x88888888) >> 3;
        u32 tx = ux | (ux << 4) | (ux >> 4);
        if (i > 0) nxt_mbr[-1] |= (ux << 28) & ~nxt_sig[-1];
        nxt_mbr[0] |= tx & ~nxt_sig[0];
        nxt_mbr[1] |= (ux >> 28) & ~nxt_sig[1];
    }
}

// opj_t1_ht_decode_cblk on one code-block: cblkdata its segments joined
// (segment 0 the cleanup pass, segment 1 SigProp and MagRef), data the
// w x h samples (zeroed); Mb the band's bit-planes, numbps Mb minus the
// zero bit-planes the tag tree gave; nseg0/len0 and nseg1/len1 the first
// two segments' passes and lengths
void ht_decode_cblk(const u8* coded_data, u32 cblk_len, i32* data, i32 width, i32 height,
                    u32 Mb, u32 numbps, u32 nsegs, u32 np0, u32 len0, u32 np1, u32 len1,
                    u32 cblksty) {
    bool stripe_causal = (cblksty & 8) != 0;
    u32 zero_bplanes = (Mb + 1) - numbps;
    u32 num_passes = nsegs > 0 ? np0 : 0;
    num_passes += nsegs > 1 ? np1 : 0;
    u32 lengths1 = num_passes > 0 ? len0 : 0;
    u32 lengths2 = num_passes > 1 ? len1 : 0;
    i32 stride = width;
    u32* decoded_data = reinterpret_cast<u32*>(data);
    if (num_passes > 1 && lengths2 == 0) num_passes = 1;
    if (num_passes > 3)
        fail(fmt("We do not support more than 3 coding passes in an HT codeblock; "
                 "This codeblocks has %lld passes.", num_passes));
    if (Mb > 30)
        fail(fmt("32 bits are not enough to decode this codeblock, since the number "
                 "of bitplane, %lld, is larger than 30.", Mb));
    if (zero_bplanes > Mb)
        fail(fmt("Malformed HT codeblock. Decoding this codeblock is stopped. There "
                 "are %lld zero bitplanes in %lld bitplanes.", zero_bplanes, Mb));
    else if (zero_bplanes == Mb && num_passes > 1)
        num_passes = 1;
    u32 p = numbps;
    u32 zero_bplanes_p1 = zero_bplanes + 1;
    if (lengths1 < 2 || lengths1 > cblk_len || lengths1 + lengths2 > cblk_len)
        fail("Malformed HT codeblock. Invalid codeblock length values.");
    int lcup = (int)lengths1;
    int scup = (((int)coded_data[lcup - 1]) << 4) + (coded_data[lcup - 2] & 0xF);
    if (scup < 2 || scup > lcup || scup > 4079)
        fail("Malformed HT codeblock. One of the following condition is not met: "
             "2 <= Scup <= min(Lcup, 4079)");
    HtMel mel;
    HtRev vlc, magref;
    HtFwd magsgn, sigprop;
    if (!mel_init(mel, coded_data, lcup, scup))
        fail("Malformed HT codeblock. Incorrect MEL segment sequence.");
    rev_init(vlc, coded_data, lcup, scup);
    frwd_init(magsgn, coded_data, lcup - scup, 0xFF);
    if (num_passes > 1) frwd_init(sigprop, coded_data + lengths1, (int)lengths2, 0);
    if (num_passes > 2) rev_init_mrp(magref, coded_data, (int)lengths1, (int)lengths2);

    // OpenJPEG's flags buffer: four arrays of 132 words, then the line state
    u32 sigma1[132] = {}, sigma2[132] = {}, mbr1[132] = {}, mbr2[132] = {};
    u8 line_state[528] = {};
    u32* sip = sigma1;
    u32 sip_shift = 0;
    u8* lsp = line_state;
    lsp[0] = 0;
    int run = mel_get_run(mel);
    u32 qinf[2] = {0, 0};
    u32 c_q = 0;
    u32* sp = decoded_data;
    u32 vlc_val;
    auto quad_samples = [&](u32 q, u32 U, u32 locs, u32 lbase) {
        // samples 0-3 of a quad at sp (columns sp[0], sp[1]); line state
        // updates at lsp[0] (then lsp advances by one)
        u32 v_n;
        if (q & 0x10) {
            sp[0] = ht_sample(magsgn, q, 0, U, p, &v_n);
        } else if (locs & (0x1 << lbase)) {
            sp[0] = 0;
        }
        if (q & 0x20) {
            sp[stride] = ht_sample(magsgn, q, 1, U, p, &v_n);
            u32 t = lsp[0] & 0x7F;
            v_n = 32 - clz32(v_n);
            lsp[0] = (u8)(0x80 | (t > v_n ? t : v_n));
        } else if (locs & (0x2 << lbase)) {
            sp[stride] = 0;
        }
        ++lsp;
        ++sp;
        if (q & 0x40) {
            sp[0] = ht_sample(magsgn, q, 2, U, p, &v_n);
        } else if (locs & (0x4 << lbase)) {
            sp[0] = 0;
        }
        lsp[0] = 0;
        if (q & 0x80) {
            sp[stride] = ht_sample(magsgn, q, 3, U, p, &v_n);
            lsp[0] = (u8)(0x80 | (32 - clz32(v_n)));
        } else if (locs & (0x8 << lbase)) {
            sp[stride] = 0;
        }
        ++sp;
    };

    // the first row pair
    for (i32 x = 0; x < width; x += 4) {
        u32 U_q[2];
        vlc_val = rev_fetch(vlc);
        qinf[0] = kHtVlc0[(c_q << 7) | (vlc_val & 0x7F)];
        if (c_q == 0) {
            run -= 2;
            qinf[0] = (run == -1) ? qinf[0] : 0;
            if (run < 0) run = mel_get_run(mel);
        }
        c_q = ((qinf[0] & 0x10) >> 4) | ((qinf[0] & 0xE0) >> 5);
        vlc_val = rev_advance(vlc, qinf[0] & 0x7);
        *sip |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
        qinf[1] = 0;
        if (x + 2 < width) {
            qinf[1] = kHtVlc0[(c_q << 7) | (vlc_val & 0x7F)];
            if (c_q == 0) {
                run -= 2;
                qinf[1] = (run == -1) ? qinf[1] : 0;
                if (run < 0) run = mel_get_run(mel);
            }
            c_q = ((qinf[1] & 0x10) >> 4) | ((qinf[1] & 0xE0) >> 5);
            vlc_val = rev_advance(vlc, qinf[1] & 0x7);
        }
        *sip |= (((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2))) << (4 + sip_shift);
        sip += x & 0x7 ? 1 : 0;
        sip_shift ^= 0x10;
        u32 uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
        if (uvlc_mode == 3) {
            run -= 2;
            uvlc_mode += (run == -1) ? 1 : 0;
            if (run < 0) run = mel_get_run(mel);
        }
        u32 consumed_bits = decode_uvlc(vlc_val, uvlc_mode, U_q, true);
        if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
            fail("Malformed HT codeblock. Decoding this codeblock is stopped. U_q is "
                 "larger than zero bitplanes + 1");
        vlc_val = rev_advance(vlc, consumed_bits);
        u32 locs = 0xFF;
        if (x + 4 > width) locs >>= (x + 4 - width) << 1;
        locs = height > 1 ? locs : (locs & 0x55);
        if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
            fail("Malformed HT codeblock. VLC code produces significant samples "
                 "outside the codeblock area.");
        quad_samples(qinf[0], U_q[0], locs, 0);
        quad_samples(qinf[1], U_q[1], locs, 4);
    }

    // the row pairs below
    for (i32 y = 2; y < height;) {
        sip_shift ^= 0x2;
        sip_shift &= 0xFFFFFFEFu;
        u32* sipr = y & 0x4 ? sigma2 : sigma1;
        lsp = line_state;
        u8 ls0 = lsp[0];
        lsp[0] = 0;
        sp = decoded_data + y * stride;
        c_q = 0;
        for (i32 x = 0; x < width; x += 4) {
            u32 U_q[2];
            c_q |= (ls0 >> 7);
            c_q |= (lsp[1] >> 5) & 0x4;
            vlc_val = rev_fetch(vlc);
            qinf[0] = kHtVlc1[(c_q << 7) | (vlc_val & 0x7F)];
            if (c_q == 0) {
                run -= 2;
                qinf[0] = (run == -1) ? qinf[0] : 0;
                if (run < 0) run = mel_get_run(mel);
            }
            c_q = ((qinf[0] & 0x40) >> 5) | ((qinf[0] & 0x80) >> 6);
            vlc_val = rev_advance(vlc, qinf[0] & 0x7);
            *sipr |= (((qinf[0] & 0x30) >> 4) | ((qinf[0] & 0xC0) >> 2)) << sip_shift;
            qinf[1] = 0;
            if (x + 2 < width) {
                c_q |= (lsp[1] >> 7);
                c_q |= (lsp[2] >> 5) & 0x4;
                qinf[1] = kHtVlc1[(c_q << 7) | (vlc_val & 0x7F)];
                if (c_q == 0) {
                    run -= 2;
                    qinf[1] = (run == -1) ? qinf[1] : 0;
                    if (run < 0) run = mel_get_run(mel);
                }
                c_q = ((qinf[1] & 0x40) >> 5) | ((qinf[1] & 0x80) >> 6);
                vlc_val = rev_advance(vlc, qinf[1] & 0x7);
            }
            *sipr |= (((qinf[1] & 0x30) | ((qinf[1] & 0xC0) << 2))) << (4 + sip_shift);
            sipr += x & 0x7 ? 1 : 0;
            sip_shift ^= 0x10;
            u32 uvlc_mode = ((qinf[0] & 0x8) >> 3) | ((qinf[1] & 0x8) >> 2);
            u32 consumed_bits = decode_uvlc(vlc_val, uvlc_mode, U_q, false);
            vlc_val = rev_advance(vlc, consumed_bits);
            if ((qinf[0] & 0xF0) & ((qinf[0] & 0xF0) - 1)) {
                u32 E = (ls0 & 0x7Fu);
                E = E > (lsp[1] & 0x7Fu) ? E : (lsp[1] & 0x7Fu);
                U_q[0] += E > 2 ? E - 2 : 0;
            }
            if ((qinf[1] & 0xF0) & ((qinf[1] & 0xF0) - 1)) {
                u32 E = (lsp[1] & 0x7Fu);
                E = E > (lsp[2] & 0x7Fu) ? E : (lsp[2] & 0x7Fu);
                U_q[1] += E > 2 ? E - 2 : 0;
            }
            if (U_q[0] > zero_bplanes_p1 || U_q[1] > zero_bplanes_p1)
                fail("Malformed HT codeblock. Decoding this codeblock is stopped. U_q is "
                     "larger than bitplanes + 1");
            ls0 = lsp[2];
            lsp[1] = lsp[2] = 0;
            u32 locs = 0xFF;
            if (x + 4 > width) locs >>= (x + 4 - width) << 1;
            locs = y + 2 <= height ? locs : (locs & 0x55);
            if ((((qinf[0] & 0xF0) >> 4) | (qinf[1] & 0xF0)) & ~locs)
                fail("Malformed HT codeblock. VLC code produces significant samples "
                     "outside the codeblock area.");
            quad_samples(qinf[0], U_q[0], locs, 0);
            quad_samples(qinf[1], U_q[1], locs, 4);
        }
        y += 2;
        if (num_passes > 1 && (y & 3) == 0) {
            if (num_passes > 2) {
                u32* cur_sig = y & 0x4 ? sigma1 : sigma2;
                ht_magref(magref, cur_sig, decoded_data + (y - 4) * stride, width, stride, p);
            }
            if (y >= 4) {
                u32* sig = y & 0x4 ? sigma1 : sigma2;
                u32* mbr = y & 0x4 ? mbr1 : mbr2;
                ht_stripe_mbr(sig, mbr, width);
            }
            if (y >= 8) {
                u32* cur_sig = y & 0x4 ? sigma2 : sigma1;
                u32* cur_mbr = y & 0x4 ? mbr2 : mbr1;
                u32* nxt_sig = y & 0x4 ? sigma1 : sigma2;
                u32* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
                ht_mbr_from_next(cur_sig, cur_mbr, nxt_sig, width, stripe_causal);
                ht_sigprop(sigprop, cur_sig, cur_mbr, nxt_sig, nxt_mbr,
                           decoded_data + (y - 8) * stride, width, stride, p, 0xFFFFFFFFu);
                memset(cur_sig, 0, ((((u32)width + 7u) >> 3) + 1u) << 2);
            }
        }
    }

    // the last stripes
    if (num_passes > 1) {
        if (num_passes > 2 && ((height & 3) == 1 || (height & 3) == 2)) {
            u32* cur_sig = height & 0x4 ? sigma2 : sigma1;
            ht_magref(magref, cur_sig, decoded_data + (height & 0xFFFFFC) * stride, width,
                      stride, p);
        }
        if ((height & 3) == 1 || (height & 3) == 2) {
            u32* sig = height & 0x4 ? sigma2 : sigma1;
            u32* mbr = height & 0x4 ? mbr2 : mbr1;
            ht_stripe_mbr(sig, mbr, width);
        }
        i32 st = height;
        st -= height > 6 ? (((height + 1) & 3) + 3) : height;
        for (i32 y = st; y < height; y += 4) {
            u32 pattern = 0xFFFFFFFFu;
            if (height - y == 3) pattern = 0x77777777u;
            else if (height - y == 2) pattern = 0x33333333u;
            else if (height - y == 1) pattern = 0x11111111u;
            u32* cur_sig = y & 0x4 ? sigma2 : sigma1;
            u32* cur_mbr = y & 0x4 ? mbr2 : mbr1;
            u32* nxt_sig = y & 0x4 ? sigma1 : sigma2;
            u32* nxt_mbr = y & 0x4 ? mbr1 : mbr2;
            if (height - y > 4) ht_mbr_from_next(cur_sig, cur_mbr, nxt_sig, width, stripe_causal);
            ht_sigprop(sigprop, cur_sig, cur_mbr, nxt_sig, nxt_mbr, decoded_data + y * stride,
                       width, stride, p, pattern);
        }
    }

    // sign-magnitude to integers
    for (i32 y = 0; y < height; ++y) {
        i32* s = data + (size_t)y * stride;
        for (i32 x = 0; x < width; ++x) {
            u32 v = (u32)s[x];
            i32 m = (i32)(v & 0x7FFFFFFF);
            s[x] = (v & 0x80000000u) ? -m : m;
        }
    }
}

// --------------------------------------------------------- coding params

constexpr int MAXRLVLS = 33, MAXBANDS = 3 * MAXRLVLS - 2;

struct StepSize {
    i32 expn = 0, mant = 0;
};

struct TCCP {
    u32 csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0;
    u32 qntsty = 0, numgbits = 0, roishift = 0;
    u32 prcw[MAXRLVLS] = {}, prch[MAXRLVLS] = {};
    StepSize steps[MAXBANDS];
    i32 dc_shift = 0;
};

struct POC {
    u32 resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
    i32 prg = 0;
};

struct PPx {
    bool present = false;
    std::vector<u8> data;
};

// Part 2's array-based component transform records (MCT and MCC markers),
// as OpenJPEG keeps them: an MCC names MCT records by their index
struct MctRec {
    u32 index = 0, element_type = 0;
    std::vector<u8> data;
};

struct MccRec {
    u32 index = 0, nb_comps = 0;
    i32 deco = -1, offset = -1;   // MCT records, by position
};

struct TCP {
    u32 csty = 0, numlayers = 0, mct = 0;
    std::vector<MctRec> mcts;
    std::vector<MccRec> mccs;     // mccs[nb_mcc] may hold a half-read record
    u32 nb_mcc = 0;
    i32 prg = 0;
    bool cod = false;
    std::vector<TCCP> tccps;
    bool has_poc = false;
    u32 numpocs = 0;
    POC pocs[32];
    i32 cur_tp = -1;
    u32 nb_tp = 0;
    std::vector<u8> data;
    bool has_data = false;
    bool ppt = false;
    std::vector<PPx> ppt_markers;
    std::vector<u8> ppt_buf;
    bool ppt_merged = false;
};

struct Comp {
    u32 prec = 0, sgnd = 0, dx = 1, dy = 1;
    u32 x0 = 0, y0 = 0, w = 0, h = 0;
    std::vector<i32> data;
    bool has_data = false;
};

// decoder states (OpenJPEG's J2K_STATE_*)
constexpr u32 ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16,
              ST_NEOC = 64, ST_DATA = 128, ST_EOC = 256;

enum Marker : u32 {
    M_SOC = 0xFF4F, M_SIZ = 0xFF51, M_COD = 0xFF52, M_COC = 0xFF53,
    M_TLM = 0xFF55, M_PLM = 0xFF57, M_PLT = 0xFF58, M_QCD = 0xFF5C,
    M_QCC = 0xFF5D, M_RGN = 0xFF5E, M_POC = 0xFF5F, M_PPM = 0xFF60,
    M_PPT = 0xFF61, M_CRG = 0xFF63, M_COM = 0xFF64, M_SOT = 0xFF90,
    M_SOP = 0xFF91, M_SOD = 0xFF93, M_EOC = 0xFFD9, M_CAP = 0xFF50,
    M_CPF = 0xFF59, M_MCT = 0xFF74, M_MCC = 0xFF75, M_MCO = 0xFF77,
    M_CBD = 0xFF78, M_UNK = 0
};

u32 marker_states(u32 m) {
    switch (m) {
        case M_SOT: return ST_MH | ST_TPHSOT;
        case M_COD: case M_COC: case M_RGN: case M_QCD: case M_QCC:
        case M_POC: case M_COM: case M_MCT: case M_MCC: case M_MCO:
            return ST_MH | ST_TPH;
        case M_SIZ: return ST_MHSIZ;
        case M_TLM: case M_PLM: case M_PPM: case M_CRG: case M_CBD:
        case M_CAP: case M_CPF:
            return ST_MH;
        case M_PLT: case M_PPT: return ST_TPH;
        case M_SOP: return 0;
        default: return ST_MH | ST_TPH;   // unknown
    }
}

bool known_marker(u32 m) {
    switch (m) {
        case M_SOT: case M_COD: case M_COC: case M_RGN: case M_QCD:
        case M_QCC: case M_POC: case M_SIZ: case M_TLM: case M_PLM:
        case M_PLT: case M_PPM: case M_PPT: case M_SOP: case M_CRG:
        case M_COM: case M_MCT: case M_CBD: case M_CAP: case M_CPF:
        case M_MCC: case M_MCO:
            return true;
        default:
            return false;
    }
}

inline u32 rd(const u8* p, int n) {
    u32 v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | p[i];
    return v;
}

// -------------------------------------------------------- tile structure

struct Seg {
    u32 len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0;
    u32 numnewpasses = 0, newlen = 0;
};

struct Chunk {
    const u8* data;
    u32 len;
};

struct Cblk {
    i32 x0, y0, x1, y1;
    u32 Mb = 0;   // the band's bit-planes, set at the first inclusion
    u32 numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0;
    u32 real_num_segs = 0;
    std::vector<Seg> segs;
    std::vector<Chunk> chunks;
};

struct TagTree {
    u32 nw = 0, nh = 0;
    struct Node {
        i32 parent, value, low;
    };
    std::vector<Node> nodes;
    void build(u32 w, u32 h) {
        nw = w;
        nh = h;
        nodes.clear();
        if (!w || !h) return;
        std::vector<u32> lw{w}, lh{h};
        while (lw.back() * lh.back() > 1) {
            lw.push_back((lw.back() + 1) / 2);
            lh.push_back((lh.back() + 1) / 2);
        }
        std::vector<u32> start(lw.size());
        u32 n = 0;
        for (size_t l = 0; l < lw.size(); l++) {
            start[l] = n;
            n += lw[l] * lh[l];
        }
        nodes.assign(n, {-1, 999, 0});
        for (size_t l = 0; l + 1 < lw.size(); l++)
            for (u32 j = 0; j < lh[l]; j++)
                for (u32 i = 0; i < lw[l]; i++)
                    nodes[start[l] + j * lw[l] + i].parent =
                        (i32)(start[l + 1] + (j / 2) * lw[l + 1] + i / 2);
    }
    void reset() {
        for (auto& nd : nodes) {
            nd.value = 999;
            nd.low = 0;
        }
    }
};

struct Precinct {
    i32 x0, y0, x1, y1;
    u32 cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    u32 bandno;
    i32 x0, y0, x1, y1;
    float stepsize;
    i32 numbps;
    std::vector<Precinct> precs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    i32 x0, y0, x1, y1;
    u32 pdx, pdy, pw, ph, numbands;
    Band bands[3];
};

struct TileComp {
    i32 x0, y0, x1, y1;
    u32 numres;
    std::vector<Res> res;
    std::vector<i32> data;
};

// OpenJPEG's bio (packet header bits, 0xFF stuffing)
struct Bio {
    const u8 *start, *end, *bp;
    u32 buf, ct;
    void init(const u8* p, u32 len) {
        start = bp = p;
        end = p + len;
        buf = 0;
        ct = 0;
    }
    void bytein() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    u32 bit() {
        if (ct == 0) bytein();
        ct--;
        return (buf >> ct) & 1;
    }
    u32 read(u32 n) {
        u32 v = 0;
        for (u32 i = n - 1; i < n; i--) v |= bit() << i;
        return v;
    }
    void inalign() {
        if ((buf & 0xFF) == 0xFF) bytein();
        ct = 0;
    }
    u32 numbytes() const { return (u32)(bp - start); }
};

u32 tgt_decode(Bio& bio, TagTree& t, u32 leaf, i32 threshold) {
    i32 stk[40];
    int sp = 0;
    i32 node = (i32)leaf;
    while (t.nodes[node].parent >= 0) {
        stk[sp++] = node;
        node = t.nodes[node].parent;
    }
    i32 low = 0;
    for (;;) {
        TagTree::Node& nd = t.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.read(1)) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (sp == 0) break;
        node = stk[--sp];
    }
    return t.nodes[node].value < threshold ? 1 : 0;
}

// ------------------------------------------------------------- the decoder

struct Decoder {
    const u8* buf;
    size_t len, pos = 0;
    // image
    i32 x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    u32 numcomps = 0;
    std::vector<Comp> comps;
    // coding parameters
    u32 tx0 = 0, ty0 = 0, tdx = 0, tdy = 0, tw = 0, th = 0;
    TCP deftcp;
    std::vector<TCP> tcps;
    bool ppm = false;
    std::vector<PPx> ppm_markers;
    std::vector<u8> ppm_buf;
    u32 ppm_pos = 0, ppm_len = 0;
    u32 ihdr_w = 0, ihdr_h = 0;
    // state
    u32 state = 0;
    u32 cur_tile = 0;
    u32 sot_length = 0;
    bool last_tile_part = false;
    bool can_decode = false;
    bool tp_corr_checked = false;
    u32 tp_correction = 0;

    size_t left() const { return len - pos; }
    bool read(u8* out, size_t n) {
        if (left() < n) {
            pos = len;
            return false;
        }
        memcpy(out, buf + pos, n);
        pos += n;
        return true;
    }
    u32 read_marker_or_fail() {
        u8 b[2];
        if (!read(b, 2)) fail("Stream too short");
        return rd(b, 2);
    }

    TCP& cur_tcp() {
        return state == ST_TPH ? tcps[cur_tile] : deftcp;
    }

    // ---- marker segments

    void read_siz(const u8* p, u32 n) {
        if (n < 36) fail("Error with SIZ marker size");
        u32 ncomp = (n - 36) / 3;
        if ((n - 36) % 3) fail("Error with SIZ marker size");
        x1 = (i32)rd(p + 2, 4);
        y1 = (i32)rd(p + 6, 4);
        x0 = (i32)rd(p + 10, 4);
        y0 = (i32)rd(p + 14, 4);
        u32 ux1 = rd(p + 2, 4), uy1 = rd(p + 6, 4), ux0 = rd(p + 10, 4),
            uy0 = rd(p + 14, 4);
        tdx = rd(p + 18, 4);
        tdy = rd(p + 22, 4);
        tx0 = rd(p + 26, 4);
        ty0 = rd(p + 30, 4);
        u32 nc = rd(p + 34, 2);
        if (nc >= 16385) fail("Error with SIZ marker: number of component is illegal");
        numcomps = nc;
        if (numcomps != ncomp)
            fail("Error with SIZ marker: number of component is not compatible "
                 "with the remaining number of parameters");
        if (ux0 >= ux1 || uy0 >= uy1)
            fail("Error with SIZ marker: negative or zero image size");
        if (tdx == 0 || tdy == 0) fail("Error with SIZ marker: invalid tile size");
        uint64_t tx1 = (uint64_t)tx0 + tdx, ty1 = (uint64_t)ty0 + tdy;
        if (tx1 > 0xFFFFFFFFu) tx1 = 0xFFFFFFFFu;
        if (ty1 > 0xFFFFFFFFu) ty1 = 0xFFFFFFFFu;
        if (tx0 > ux0 || ty0 > uy0 || tx1 <= ux0 || ty1 <= uy0)
            fail("Error with SIZ marker: illegal tile offset");
        if (ihdr_w > 0 && ihdr_h > 0 && (ihdr_w != ux1 - ux0 || ihdr_h != uy1 - uy0))
            fail("Error with SIZ marker: IHDR w/h differ from SIZ w/h");
        comps.assign(numcomps, Comp());
        for (u32 i = 0; i < numcomps; i++) {
            u32 t = p[36 + 3 * i];
            comps[i].prec = (t & 0x7F) + 1;
            comps[i].sgnd = t >> 7;
            comps[i].dx = p[37 + 3 * i];
            comps[i].dy = p[38 + 3 * i];
            if (comps[i].dx < 1 || comps[i].dy < 1)
                fail(fmt("Invalid values for comp = %lld : dx=%lld dy=%lld", i,
                         comps[i].dx, comps[i].dy));
            if (comps[i].prec > 31)
                fail(fmt("Invalid values for comp = %lld : prec=%lld", i,
                         comps[i].prec));
        }
        tw = uceildiv(ux1 - tx0, tdx);
        th = uceildiv(uy1 - ty0, tdy);
        if (tw == 0 || th == 0 || tw > 65535 / th)
            fail(fmt("Invalid number of tiles : %lld x %lld", tw, th));
        tcps.assign((size_t)tw * th, TCP());
        deftcp.tccps.assign(numcomps, TCCP());
        for (u32 i = 0; i < numcomps; i++)
            if (!comps[i].sgnd)
                deftcp.tccps[i].dc_shift = 1 << (comps[i].prec - 1);
        for (u32 i = 0; i < numcomps; i++) {
            Comp& c = comps[i];
            c.x0 = uceildiv(ux0, c.dx);
            c.y0 = uceildiv(uy0, c.dy);
            c.w = uceildiv(ux1, c.dx) - c.x0;
            c.h = uceildiv(uy1, c.dy) - c.y0;
        }
        state = ST_MH;
    }

    void read_spcod(u32 compno, const u8* p, u32& n) {
        TCP& tcp = cur_tcp();
        if (compno >= numcomps) fail("Error reading SPCod SPCoc element");
        TCCP& t = tcp.tccps[compno];
        if (n < 5) fail("Error reading SPCod SPCoc element");
        t.numres = p[0] + 1u;
        if (t.numres > MAXRLVLS) fail("Invalid value for numresolutions");
        t.cblkw = p[1] + 2u;
        t.cblkh = p[2] + 2u;
        if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
            fail("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
        t.cblksty = p[3];
        if (t.cblksty & 0x80)
            fail("Error reading SPCod SPCoc element. Unsupported Mixed HT code-block style found");
        t.qmfbid = p[4];
        if (t.qmfbid > 1) fail("Error reading SPCod SPCoc element, Invalid transformation found");
        n -= 5;
        p += 5;
        if (t.csty & 1) {
            if (n < t.numres) fail("Error reading SPCod SPCoc element");
            for (u32 i = 0; i < t.numres; i++) {
                u32 v = p[i];
                if (i != 0 && ((v & 0xF) == 0 || (v >> 4) == 0)) fail("Invalid precinct size");
                t.prcw[i] = v & 0xF;
                t.prch[i] = v >> 4;
            }
            n -= t.numres;
        } else {
            for (u32 i = 0; i < t.numres; i++) t.prcw[i] = t.prch[i] = 15;
        }
    }

    void read_cod(const u8* p, u32 n) {
        TCP& tcp = cur_tcp();
        if (tcp.cod) fail("COD marker already read. No more than one COD marker per tile.");
        tcp.cod = true;
        if (n < 5) fail("Error reading COD marker");
        tcp.csty = p[0];
        if (tcp.csty & ~7u) fail("Unknown Scod value in COD marker");
        tcp.prg = p[1];
        if (tcp.prg > 4) tcp.prg = -1;
        tcp.numlayers = rd(p + 2, 2);
        if (tcp.numlayers < 1) fail("Invalid number of layers in COD marker");
        tcp.mct = p[4];
        if (tcp.mct > 1) fail("Invalid multiple component transformation");
        n -= 5;
        for (u32 i = 0; i < numcomps; i++) tcp.tccps[i].csty = tcp.csty & 1;
        read_spcod(0, p + 5, n);
        if (n != 0) fail("Error reading COD marker");
        TCCP& r = tcp.tccps[0];
        for (u32 i = 1; i < numcomps; i++) {
            TCCP& c = tcp.tccps[i];
            c.numres = r.numres;
            c.cblkw = r.cblkw;
            c.cblkh = r.cblkh;
            c.cblksty = r.cblksty;
            c.qmfbid = r.qmfbid;
            memcpy(c.prcw, r.prcw, sizeof r.prcw);
            memcpy(c.prch, r.prch, sizeof r.prch);
        }
    }

    void read_coc(const u8* p, u32 n) {
        TCP& tcp = cur_tcp();
        u32 room = numcomps <= 256 ? 1 : 2;
        if (n < room + 1) fail("Error reading COC marker");
        n -= room + 1;
        u32 compno = rd(p, room);
        if (compno >= numcomps) fail("Error reading COC marker (bad number of components)");
        tcp.tccps[compno].csty = p[room];
        read_spcod(compno, p + room + 1, n);
        if (n != 0) fail("Error reading COC marker");
    }

    void read_sqcd(u32 compno, const u8* p, u32& n) {
        TCP& tcp = cur_tcp();
        if (compno >= numcomps) fail("Error reading SQcd or SQcc element");
        TCCP& t = tcp.tccps[compno];
        if (n < 1) fail("Error reading SQcd or SQcc element");
        n -= 1;
        u32 v = p[0];
        p++;
        t.qntsty = v & 0x1F;
        t.numgbits = v >> 5;
        u32 nb;
        if (t.qntsty == 1) nb = 1;
        else nb = t.qntsty == 0 ? n : n / 2;
        if (t.qntsty == 0) {
            for (u32 b = 0; b < nb; b++) {
                if (b < (u32)MAXBANDS) {
                    t.steps[b].expn = (i32)(p[b] >> 3);
                    t.steps[b].mant = 0;
                }
            }
            if (n < nb) fail("Error reading SQcd or SQcc element");
            n -= nb;
        } else {
            if (n < 2 * nb) fail("Error reading SQcd or SQcc element");
            for (u32 b = 0; b < nb; b++) {
                u32 s = rd(p + 2 * b, 2);
                if (b < (u32)MAXBANDS) {
                    t.steps[b].expn = (i32)(s >> 11);
                    t.steps[b].mant = (i32)(s & 0x7FF);
                }
            }
            n -= 2 * nb;
        }
        if (t.qntsty == 1) {
            for (int b = 1; b < MAXBANDS; b++) {
                i32 e = t.steps[0].expn - (b - 1) / 3;
                t.steps[b].expn = e > 0 ? e : 0;
                t.steps[b].mant = t.steps[0].mant;
            }
        }
    }

    void read_qcd(const u8* p, u32 n) {
        read_sqcd(0, p, n);
        if (n != 0) fail("Error reading QCD marker");
        TCP& tcp = cur_tcp();
        TCCP& r = tcp.tccps[0];
        for (u32 i = 1; i < numcomps; i++) {
            TCCP& c = tcp.tccps[i];
            c.qntsty = r.qntsty;
            c.numgbits = r.numgbits;
            memcpy(c.steps, r.steps, sizeof r.steps);
        }
    }

    void read_qcc(const u8* p, u32 n) {
        u32 compno;
        if (numcomps <= 256) {
            if (n < 1) fail("Error reading QCC marker");
            compno = p[0];
            p++;
            n--;
        } else {
            if (n < 2) fail("Error reading QCC marker");
            compno = rd(p, 2);
            p += 2;
            n -= 2;
        }
        if (compno >= numcomps) fail("Invalid component number in QCC marker");
        read_sqcd(compno, p, n);
        if (n != 0) fail("Error reading QCC marker");
    }

    void read_rgn(const u8* p, u32 n) {
        u32 room = numcomps <= 256 ? 1 : 2;
        if (n != 2 + room) fail("Error reading RGN marker");
        TCP& tcp = cur_tcp();
        u32 compno = rd(p, room);
        if (compno >= numcomps) fail("bad component number in RGN");
        tcp.tccps[compno].roishift = p[room + 1];
    }

    void read_poc(const u8* p, u32 n) {
        u32 room = numcomps <= 256 ? 1 : 2;
        u32 chunk = 5 + 2 * room;
        u32 cnt = n / chunk;
        if (cnt == 0 || n % chunk) fail("Error reading POC marker");
        TCP& tcp = cur_tcp();
        u32 old = tcp.has_poc ? tcp.numpocs + 1 : 0;
        cnt += old;
        if (cnt >= 32) fail("Too many POCs");
        tcp.has_poc = true;
        for (u32 i = old; i < cnt; i++) {
            POC& c = tcp.pocs[i];
            c.resno0 = p[0];
            c.compno0 = rd(p + 1, room);
            c.layno1 = rd(p + 1 + room, 2);
            if (c.layno1 > tcp.numlayers) c.layno1 = tcp.numlayers;
            c.resno1 = p[3 + room];
            c.compno1 = rd(p + 4 + room, room);
            c.prg = p[4 + 2 * room];
            if (c.compno1 > numcomps) c.compno1 = numcomps;
            p += chunk;
        }
        tcp.numpocs = cnt - 1;
    }

    void read_ppx(std::vector<PPx>& markers, const u8* p, u32 n, const char* name) {
        u32 z = p[0];
        if (markers.size() <= z) markers.resize(z + 1);
        if (markers[z].present) fail(std::string(name) + " index already read");
        markers[z].present = true;
        markers[z].data.assign(p + 1, p + n);
    }

    // TLM: only its length is checked; OpenJPEG 2.5.3 ignores a TLM whose
    // ST is 3 or whose entries do not fill it
    void read_tlm(const u8* p, u32 n) {
        (void)p;
        if (n < 2) fail("Error reading TLM marker");
    }

    void read_plt(const u8* p, u32 n) {
        if (n < 1) fail("Error reading PLT marker");
        u32 len = 0;
        for (u32 i = 1; i < n; i++) {
            u32 t = p[i];
            len |= t & 0x7F;
            if (t & 0x80) len <<= 7;
            else len = 0;
        }
        if (len != 0) fail("Error reading PLT marker");
    }

    void handle(u32 m, const u8* p, u32 n) {
        switch (m) {
            case M_SIZ: read_siz(p, n); break;
            case M_COD: read_cod(p, n); break;
            case M_COC: read_coc(p, n); break;
            case M_QCD: read_qcd(p, n); break;
            case M_QCC: read_qcc(p, n); break;
            case M_RGN: read_rgn(p, n); break;
            case M_POC: read_poc(p, n); break;
            case M_TLM: read_tlm(p, n); break;
            case M_PLM:
                if (n < 1) fail("Error reading PLM marker");
                break;
            case M_PLT: read_plt(p, n); break;
            case M_PPM:
                if (n < 2) fail("Error reading PPM marker");
                ppm = true;
                read_ppx(ppm_markers, p, n, "Zppm");
                break;
            case M_PPT: {
                if (n < 2) fail("Error reading PPT marker");
                if (ppm)
                    fail("Error reading PPT marker: packet header have been previously "
                         "found in the main header (PPM marker).");
                TCP& tcp = tcps[cur_tile];
                tcp.ppt = true;
                read_ppx(tcp.ppt_markers, p, n, "Zppt");
                break;
            }
            case M_CRG:
                if (n != numcomps * 4) fail("Error reading CRG marker");
                break;
            case M_COM: break;
            case M_SOT: read_sot(p, n); break;
            // Part 15's capabilities and profile: OpenJPEG reads neither
            case M_CAP: case M_CPF: break;
            case M_CBD: read_cbd(p, n); break;
            case M_MCT: read_mct(p, n); break;
            case M_MCC: read_mcc(p, n); break;
            case M_MCO: read_mco(p, n); break;
            default: fail("Not sure how that happened.");
        }
    }

    // ---- Part 2's markers (opj_j2k_read_cbd, _mct, _mcc, _mco)

    // CBD: each component's precision and sign, over SIZ's
    void read_cbd(const u8* p, u32 n) {
        if (n != numcomps + 2) fail("Crror reading CBD marker");
        if (rd(p, 2) != numcomps) fail("Crror reading CBD marker");
        for (u32 i = 0; i < numcomps; i++) {
            u32 def = p[2 + i];
            comps[i].sgnd = (def >> 7) & 1;
            comps[i].prec = (def & 0x7F) + 1;
            if (comps[i].prec > 31)
                fail(fmt("Invalid values for comp = %lld : prec=%lld (should be between 1 and "
                         "38 according to the JPEG2000 norm. OpenJPEG only supports up to 31)",
                         i, comps[i].prec));
        }
    }

    // MCT: one record (Zmct and Ymct 0: the rest is skipped), kept by its
    // index with its element and array types
    void read_mct(const u8* p, u32 n) {
        TCP& tcp = cur_tcp();
        if (n < 2) fail("Error reading MCT marker");
        if (rd(p, 2) != 0) return;   // "Cannot take in charge mct data within multiple MCT records"
        if (n <= 6) fail("Error reading MCT marker");
        u32 tmp = rd(p + 2, 2);
        u32 indix = tmp & 0xFF;
        size_t i = 0;
        while (i < tcp.mcts.size() && tcp.mcts[i].index != indix) i++;
        if (i == tcp.mcts.size()) tcp.mcts.emplace_back();
        MctRec& r = tcp.mcts[i];
        r.data.clear();
        r.index = indix;
        r.element_type = (tmp >> 10) & 3;
        if (rd(p + 4, 2) != 0) return;   // "Cannot take in charge multiple MCT markers"
        r.data.assign(p + 6, p + n);
    }

    // MCC: one collection of array decorrelation over components 0..n-1 in
    // order, naming its decorrelation and offset MCT records
    void read_mcc(const u8* p, u32 n) {
        TCP& tcp = cur_tcp();
        if (n < 2) fail("Error reading MCC marker");
        if (rd(p, 2) != 0) return;   // "Cannot take in charge multiple data spanning"
        if (n < 7) fail("Error reading MCC marker");
        u32 indix = p[2];
        u32 i = 0;
        while (i < tcp.nb_mcc && tcp.mccs[i].index != indix) i++;
        bool fresh = i == tcp.nb_mcc;
        if (fresh && tcp.mccs.size() == tcp.nb_mcc) tcp.mccs.emplace_back();
        MccRec& r = tcp.mccs[i];
        r.index = indix;
        if (rd(p + 3, 2) != 0) return;   // "Cannot take in charge multiple data spanning"
        u32 ncoll = rd(p + 5, 2);
        if (ncoll > 1) return;           // "Cannot take in charge multiple collections"
        p += 7;
        n -= 7;
        for (u32 c = 0; c < ncoll; c++) {
            if (n < 3) fail("Error reading MCC marker");
            if (p[0] != 1) return;   // "... collections other than array decorrelation"
            u32 nb = rd(p + 1, 2);
            p += 3;
            n -= 3;
            u32 w = 1 + (nb >> 15);
            r.nb_comps = nb & 0x7FFF;
            if (n < w * r.nb_comps + 2) fail("Error reading MCC marker");
            n -= w * r.nb_comps + 2;
            for (u32 j = 0; j < r.nb_comps; j++, p += w)
                if (rd(p, (int)w) != j) return;   // "... collections with indix shuffle"
            nb = rd(p, 2);
            p += 2;
            w = 1 + (nb >> 15);
            nb &= 0x7FFF;
            if (nb != r.nb_comps) return;   // "... without same number of indixes"
            if (n < w * r.nb_comps + 3) fail("Error reading MCC marker");
            n -= w * r.nb_comps + 3;
            for (u32 j = 0; j < r.nb_comps; j++, p += w)
                if (rd(p, (int)w) != j) return;
            u32 t = rd(p, 3);
            p += 3;
            r.deco = r.offset = -1;
            auto find = [&](u32 idx) {
                for (size_t k = 0; k < tcp.mcts.size(); k++)
                    if (tcp.mcts[k].index == idx) return (i32)k;
                fail("Error reading MCC marker");
            };
            if (t & 0xFF) r.deco = find(t & 0xFF);
            if ((t >> 8) & 0xFF) r.offset = find((t >> 8) & 0xFF);
        }
        if (n != 0) fail("Error reading MCC marker");
        if (fresh) tcp.nb_mcc++;
    }

    // an MCT element as OpenJPEG's opj_j2k_read_*_to_int32 gives it: 16-bit
    // elements unsigned, floats truncated (x86's INT_MIN out of range)
    static i32 mct_int(const MctRec& r, u32 k) {
        const u8* q = r.data.data();
        switch (r.element_type) {
            case 0: return (i32)rd(q + 2 * k, 2);
            case 1: return (i32)rd(q + 4 * k, 4);
            case 2: {
                u32 b = rd(q + 4 * k, 4);
                float f;
                memcpy(&f, &b, 4);
                return f >= -2147483648.0f && f < 2147483648.0f ? (i32)f : INT_MIN;
            }
            default: {
                uint64_t b = ((uint64_t)rd(q + 8 * k, 4) << 32) | rd(q + 8 * k + 4, 4);
                double f;
                memcpy(&f, &b, 8);
                return f > -2147483649.0 && f < 2147483648.0 ? (i32)f : INT_MIN;
            }
        }
    }

    // opj_j2k_add_mct: the stage's MCC record (OpenJPEG's search compares
    // the first record only), its arrays' sizes checked, its offsets made
    // the components' DC level shifts; its decorrelation matrix would act
    // only under COD's MCT byte 2, which read_cod refuses
    bool add_mct(TCP& tcp, u32 index) {
        static const u32 esize[4] = {2, 4, 4, 8};
        u32 i = 0;
        while (i < tcp.nb_mcc && tcp.mccs[0].index != index) i++;
        if (i == tcp.nb_mcc) return true;
        const MccRec& r = tcp.mccs[0];
        if (r.nb_comps != numcomps) return true;
        if (r.deco >= 0) {
            const MctRec& d = tcp.mcts[r.deco];
            if (d.data.size() != esize[d.element_type] * numcomps * numcomps) return false;
        }
        if (r.offset >= 0) {
            const MctRec& o = tcp.mcts[r.offset];
            if (o.data.size() != esize[o.element_type] * numcomps) return false;
            for (u32 c = 0; c < numcomps; c++) tcp.tccps[c].dc_shift = mct_int(o, c);
        }
        return true;
    }

    // MCO: one stage at most; every DC level shift is cleared first
    void read_mco(const u8* p, u32 n) {
        TCP& tcp = cur_tcp();
        if (n < 1) fail("Error reading MCO marker");
        u32 stages = p[0];
        if (stages > 1) return;   // "Cannot take in charge multiple transformation stages."
        if (n != stages + 1) fail("Error reading MCO marker");
        for (auto& t : tcp.tccps) t.dc_shift = 0;
        for (u32 i = 0; i < stages; i++)
            if (!add_mct(tcp, p[1 + i]))
                fail("Marker handler function failed to read the marker segment");
    }

    // the scan of opj_j2k_read_unk: known marker or error
    u32 read_unk() {
        for (;;) {
            u8 b[2];
            if (!read(b, 2)) fail("Stream too short");
            u32 m = rd(b, 2);
            if (m >= 0xFF00) {
                if (!(state & marker_states(known_marker(m) ? m : M_UNK)))
                    fail("Marker is not compliant with its position");
                if (known_marker(m)) return m;
            }
        }
    }

    void merge_ppm() {
        if (!ppm) return;
        // Nppm fields stripped, segments concatenated in Zppm order
        u32 remaining = 0;
        for (auto& mk : ppm_markers) {
            if (!mk.present) continue;
            const u8* d = mk.data.data();
            u32 n = (u32)mk.data.size();
            if (remaining >= n) {
                ppm_buf.insert(ppm_buf.end(), d, d + n);
                remaining -= n;
                continue;
            }
            ppm_buf.insert(ppm_buf.end(), d, d + remaining);
            d += remaining;
            n -= remaining;
            remaining = 0;
            while (n > 0) {
                if (n < 4) fail("Not enough bytes to read Nppm");
                u32 nppm = rd(d, 4);
                d += 4;
                n -= 4;
                if ((uint64_t)ppm_buf.size() + nppm > 0xFFFFFFFFull)
                    fail("Too large value for Nppm");
                if (n >= nppm) {
                    ppm_buf.insert(ppm_buf.end(), d, d + nppm);
                    d += nppm;
                    n -= nppm;
                } else {
                    ppm_buf.insert(ppm_buf.end(), d, d + n);
                    remaining = nppm - n;
                    n = 0;
                }
            }
        }
        if (remaining) fail("Corrupted PPM markers");
        ppm_pos = 0;
        ppm_len = (u32)ppm_buf.size();
    }

    void read_main_header() {
        u8 b[2];
        if (!read(b, 2) || rd(b, 2) != M_SOC) fail("Expected a SOC marker");
        state = ST_MHSIZ;
        u32 m = read_marker_or_fail();
        bool has_siz = false, has_cod = false, has_qcd = false;
        while (m != M_SOT) {
            if (m < 0xFF00) fail("A marker ID was expected (0xff--)");
            if (!known_marker(m)) {
                m = read_unk();
                if (m == M_SOT) break;
            }
            if (m == M_SIZ) has_siz = true;
            if (m == M_COD) has_cod = true;
            if (m == M_QCD) has_qcd = true;
            if (!(state & marker_states(m))) fail("Marker is not compliant with its position");
            u32 size = read_marker_or_fail();
            if (size < 2) fail("Invalid marker size");
            size -= 2;
            if (left() < size) fail("Stream too short");
            const u8* p = buf + pos;
            pos += size;
            handle(m, p, size);
            m = read_marker_or_fail();
        }
        if (!has_siz) fail("required SIZ marker not found in main header");
        if (!has_cod) fail("required COD marker not found in main header");
        if (!has_qcd) fail("required QCD marker not found in main header");
        merge_ppm();
        state = ST_TPHSOT;
        // opj_j2k_copy_default_tcp_and_create_tcd
        for (auto& t : tcps) {
            t = deftcp;
            t.cod = false;
            t.ppt = false;
            t.ppt_markers.clear();
            t.cur_tp = -1;
        }
    }

    void read_sot(const u8* p, u32 n) {
        if (n != 8) fail("Error reading SOT marker");
        u32 tile = rd(p, 2), tot = rd(p + 2, 4), part = p[6], nparts = p[7];
        cur_tile = tile;
        if (tile >= tw * th) fail(fmt("Invalid tile number %lld", tile));
        TCP& tcp = tcps[tile];
        if ((i32)part != tcp.cur_tp + 1)
            fail(fmt("Invalid tile part index for tile number %lld. Got %lld, expected %lld",
                     tile, part, tcp.cur_tp + 1));
        tcp.cur_tp = (i32)part;
        if (tot != 0 && tot < 14) {
            if (tot != 12) fail("Psot value is not correct regards to the JPEG2000 norm");
        }
        if (!tot) last_tile_part = true;
        if (tcp.nb_tp != 0 && part >= tcp.nb_tp) {
            last_tile_part = true;
            fail("In SOT marker, TPSot is not valid regards to the previous number of tile-part");
        }
        if (nparts != 0) {
            nparts += tp_correction;
            if (tcp.nb_tp && part >= tcp.nb_tp) {
                last_tile_part = true;
                fail("In SOT marker, TPSot is not valid regards to the current number "
                     "of tile-part");
            }
            if (part >= nparts) {
                last_tile_part = true;
                fail("In SOT marker, TPSot is not valid regards to the current number "
                     "of tile-part (header)");
            }
            tcp.nb_tp = nparts;
        }
        if (tcp.nb_tp && tcp.nb_tp == part + 1) can_decode = true;
        sot_length = last_tile_part ? 0 : tot - 12;
        state = ST_TPH;
    }

    void read_sod() {
        TCP& tcp = tcps[cur_tile];
        if (last_tile_part) {
            sot_length = (u32)(left() - 2);
        } else if (sot_length >= 2) {
            sot_length -= 2;
        }
        size_t got = 0;
        if (sot_length) {
            if ((size_t)sot_length > left())
                fail("Tile part length size inconsistent with stream length");
            got = sot_length;
            tcp.data.insert(tcp.data.end(), buf + pos, buf + pos + got);
            pos += got;
            tcp.has_data = true;
        }
        state = got != sot_length ? ST_NEOC : ST_TPHSOT;
    }

    // opj_j2k_need_nb_tile_parts_correction: does the next SOT of the tile
    // just completed carry TPsot == TNsot?  Fails where OpenJPEG does.
    bool need_tp_correction() {
        size_t p = pos;
        for (;;) {
            if (len - p < 2) return false;
            u32 m = rd(buf + p, 2);
            if (m != M_SOT) return false;
            if (len - p < 4) return false;
            if (rd(buf + p + 2, 2) != 10) fail("Inconsistent marker size");
            if (len - p < 12) fail("Stream too short");
            u32 tile = rd(buf + p + 4, 2), tot = rd(buf + p + 6, 4),
                part = buf[p + 10], nparts = buf[p + 11];
            if (tile == cur_tile) return part == nparts && nparts != 0;
            if (tot < 14) return false;
            if ((uint64_t)p + tot > len) return false;
            p += tot;
        }
    }

    // opj_j2k_read_tile_header: true and the tile to decode, or false when
    // no tile is left
    bool read_tile_header() {
        u32 m = M_SOT;
        if (state == ST_EOC) m = M_EOC;
        else if (state != ST_TPHSOT) fail("tile header expected");
        while (!can_decode && m != M_EOC) {
            while (m != M_SOD) {
                if (left() == 0) {
                    state = ST_NEOC;
                    break;
                }
                u32 size = read_marker_or_fail();
                if (size < 2) fail("Inconsistent marker size");
                if (m == 0x8080 && left() == 0) {
                    state = ST_NEOC;
                    break;
                }
                if ((state & ST_TPH) && sot_length != 0) {
                    if (sot_length < size + 2)
                        fail("Sot length is less than marker size + marker ID");
                    sot_length -= size + 2;
                }
                size -= 2;
                u32 hm = known_marker(m) ? m : M_UNK;
                if (!(state & marker_states(hm))) fail("Marker is not compliant with its position");
                if (left() < size) fail("Stream too short");
                const u8* p = buf + pos;
                pos += size;
                if (hm == M_UNK || hm == M_SOP) fail("Not sure how that happened.");
                handle(m, p, size);
                m = read_marker_or_fail();
            }
            if (left() == 0 && state == ST_NEOC) break;
            read_sod();
            if (can_decode && !tp_corr_checked) {
                tp_corr_checked = true;
                if (need_tp_correction()) {
                    can_decode = false;
                    tp_correction = 1;
                    for (auto& t : tcps)
                        if (t.nb_tp) t.nb_tp += 1;
                }
            }
            if (!can_decode) {
                u8 b[2];
                if (!read(b, 2)) {
                    u32 ntiles = tw * th;
                    if (cur_tile + 1 == ntiles) {
                        u32 t;
                        for (t = 0; t < ntiles; t++)
                            if (tcps[t].cur_tp == 0 && tcps[t].nb_tp == 0) break;
                        if (t < ntiles) {
                            cur_tile = t;
                            m = M_EOC;
                            state = ST_EOC;
                            break;
                        }
                    }
                    fail("Stream too short");
                }
                m = rd(b, 2);
            }
        }
        if (m == M_EOC && state != ST_EOC) {
            cur_tile = 0;
            state = ST_EOC;
        }
        if (!can_decode) {
            u32 ntiles = tw * th;
            while (cur_tile < ntiles && !tcps[cur_tile].has_data) cur_tile++;
            if (cur_tile == ntiles) return false;
        }
        TCP& tcp = tcps[cur_tile];
        // opj_j2k_merge_ppt
        if (tcp.ppt_merged) fail("opj_j2k_merge_ppt() has already been called");
        if (tcp.ppt) {
            tcp.ppt_merged = true;
            for (auto& mk : tcp.ppt_markers)
                if (mk.present)
                    tcp.ppt_buf.insert(tcp.ppt_buf.end(), mk.data.begin(), mk.data.end());
        }
        state |= ST_DATA;
        return true;
    }

    // ---- tile decoding

    std::vector<TileComp> tcs;
    i32 tile_x0, tile_y0, tile_x1, tile_y1;
    std::vector<u32> tile_resno;     // per component, resno_decoded

    void init_tile(u32 tileno) {
        TCP& tcp = tcps[tileno];
        u32 p = tileno % tw, q = tileno / tw;
        uint64_t tx = (uint64_t)tx0 + (uint64_t)p * tdx;
        uint64_t ty = (uint64_t)ty0 + (uint64_t)q * tdy;
        tile_x0 = (i32)std::max<uint64_t>(tx, (u32)x0);
        tile_x1 = (i32)std::min<uint64_t>(std::min<uint64_t>(tx + tdx, 0xFFFFFFFFull), (u32)x1);
        tile_y0 = (i32)std::max<uint64_t>(ty, (u32)y0);
        tile_y1 = (i32)std::min<uint64_t>(std::min<uint64_t>(ty + tdy, 0xFFFFFFFFull), (u32)y1);
        if (tile_x0 < 0 || tile_x1 <= tile_x0) fail("Tile X coordinates are not supported");
        if (tile_y0 < 0 || tile_y1 <= tile_y0) fail("Tile Y coordinates are not supported");
        if (tcp.tccps[0].numres == 0) fail("tiles require at least one resolution");
        tcs.assign(numcomps, TileComp());
        tile_resno.assign(numcomps, 0);
        for (u32 c = 0; c < numcomps; c++) {
            TCCP& tccp = tcp.tccps[c];
            TileComp& tc = tcs[c];
            Comp& ic = comps[c];
            tc.x0 = ceildiv(tile_x0, (i32)ic.dx);
            tc.y0 = ceildiv(tile_y0, (i32)ic.dy);
            tc.x1 = ceildiv(tile_x1, (i32)ic.dx);
            tc.y1 = ceildiv(tile_y1, (i32)ic.dy);
            tc.numres = tccp.numres;
            if (tc.numres == 0) fail("tiles require at least one resolution");
            tc.res.assign(tc.numres, Res());
            u32 level = tc.numres - 1;
            int stepidx = 0;
            for (u32 r = 0; r < tc.numres; r++, level--) {
                Res& rs = tc.res[r];
                rs.x0 = ceildivpow2(tc.x0, level);
                rs.y0 = ceildivpow2(tc.y0, level);
                rs.x1 = ceildivpow2(tc.x1, level);
                rs.y1 = ceildivpow2(tc.y1, level);
                u32 pdx = tccp.prcw[r], pdy = tccp.prch[r];
                rs.pdx = pdx;
                rs.pdy = pdy;
                i32 tlx = floordivpow2(rs.x0, pdx) << pdx;
                i32 tly = floordivpow2(rs.y0, pdy) << pdy;
                i32 brx = ceildivpow2(rs.x1, pdx) << pdx;
                i32 bry = ceildivpow2(rs.y1, pdy) << pdy;
                rs.pw = rs.x0 == rs.x1 ? 0 : (u32)((brx - tlx) >> pdx);
                rs.ph = rs.y0 == rs.y1 ? 0 : (u32)((bry - tly) >> pdy);
                if (rs.pw && 0xFFFFFFFFu / rs.pw < rs.ph)
                    fail("Size of tile data exceeds system limits");
                u32 nprec = rs.pw * rs.ph;
                if (nprec > (1u << 26)) fail("limit: a resolution of more than 2^26 precincts");
                i32 cbgx0, cbgy0;
                u32 cbgwe, cbghe;
                if (r == 0) {
                    cbgx0 = tlx;
                    cbgy0 = tly;
                    cbgwe = pdx;
                    cbghe = pdy;
                    rs.numbands = 1;
                } else {
                    cbgx0 = ceildivpow2(tlx, 1);
                    cbgy0 = ceildivpow2(tly, 1);
                    cbgwe = pdx - 1;
                    cbghe = pdy - 1;
                    rs.numbands = 3;
                }
                u32 cbw = std::min(tccp.cblkw, cbgwe), cbh = std::min(tccp.cblkh, cbghe);
                for (u32 b = 0; b < rs.numbands; b++, stepidx++) {
                    Band& bd = rs.bands[b];
                    if (r == 0) {
                        bd.bandno = 0;
                        bd.x0 = ceildivpow2(tc.x0, level);
                        bd.y0 = ceildivpow2(tc.y0, level);
                        bd.x1 = ceildivpow2(tc.x1, level);
                        bd.y1 = ceildivpow2(tc.y1, level);
                    } else {
                        bd.bandno = b + 1;
                        i64 xob = bd.bandno & 1, yob = bd.bandno >> 1;
                        bd.x0 = ceildivpow2_64(tc.x0 - (xob << level), level + 1);
                        bd.y0 = ceildivpow2_64(tc.y0 - (yob << level), level + 1);
                        bd.x1 = ceildivpow2_64(tc.x1 - (xob << level), level + 1);
                        bd.y1 = ceildivpow2_64(tc.y1 - (yob << level), level + 1);
                    }
                    const StepSize& ss = tccp.steps[stepidx < MAXBANDS ? stepidx : MAXBANDS - 1];
                    i32 log2_gain = tccp.qmfbid == 0 ? 0
                                    : (bd.bandno == 0 ? 0 : (bd.bandno == 3 ? 2 : 1));
                    i32 rb = (i32)ic.prec + log2_gain;
                    bd.stepsize =
                        (float)((1.0 + ss.mant / 2048.0) * pow(2.0, (double)(rb - ss.expn)));
                    bd.numbps = ss.expn + (i32)tccp.numgbits - 1;
                    bd.precs.assign(nprec, Precinct());
                    for (u32 pn = 0; pn < nprec; pn++) {
                        Precinct& pc = bd.precs[pn];
                        i32 cx0 = cbgx0 + (i32)(pn % rs.pw) * (1 << cbgwe);
                        i32 cy0 = cbgy0 + (i32)(pn / rs.pw) * (1 << cbghe);
                        i32 cx1 = cx0 + (1 << cbgwe), cy1 = cy0 + (1 << cbghe);
                        pc.x0 = std::max(cx0, bd.x0);
                        pc.y0 = std::max(cy0, bd.y0);
                        pc.x1 = std::min(cx1, bd.x1);
                        pc.y1 = std::min(cy1, bd.y1);
                        i32 tbx = floordivpow2(pc.x0, cbw) << cbw;
                        i32 tby = floordivpow2(pc.y0, cbh) << cbh;
                        i32 bbx = ceildivpow2(pc.x1, cbw) << cbw;
                        i32 bby = ceildivpow2(pc.y1, cbh) << cbh;
                        pc.cw = (u32)((bbx - tbx) >> cbw);
                        pc.ch = (u32)((bby - tby) >> cbh);
                        if (pc.cw && 0xFFFFFFFFu / pc.cw < pc.ch)
                            fail("Size of code block data exceeds system limits");
                        if ((uint64_t)pc.cw * pc.ch > (1u << 24))
                            fail("limit: a precinct of more than 2^24 code-blocks");
                        u32 ncb = pc.cw * pc.ch;
                        pc.cblks.assign(ncb, Cblk());
                        for (u32 k = 0; k < ncb; k++) {
                            Cblk& cb = pc.cblks[k];
                            i32 bx0 = tbx + (i32)(k % pc.cw) * (1 << cbw);
                            i32 by0 = tby + (i32)(k / pc.cw) * (1 << cbh);
                            cb.x0 = std::max(bx0, pc.x0);
                            cb.y0 = std::max(by0, pc.y0);
                            cb.x1 = std::min(bx0 + (1 << cbw), pc.x1);
                            cb.y1 = std::min(by0 + (1 << cbh), pc.y1);
                        }
                        pc.incl.build(pc.cw, pc.ch);
                        pc.imsb.build(pc.cw, pc.ch);
                    }
                }
            }
        }
    }

    // ---- tier-2

    struct PacketPos {
        u32 layno, resno, compno, precno;
    };

    // OpenJPEG's packet iterators (opj_pi_next_*), one POC at a time
    void iterate_packets(u32 tileno, std::vector<PacketPos>& out) {
        TCP& tcp = tcps[tileno];
        u32 max_res = 0, max_prec = 0;
        for (u32 c = 0; c < numcomps; c++) {
            max_res = std::max(max_res, tcs[c].numres);
            for (u32 r = 0; r < tcs[c].numres; r++)
                max_prec = std::max(max_prec, tcs[c].res[r].pw * tcs[c].res[r].ph);
        }
        uint64_t step_c = max_prec, step_r = (uint64_t)numcomps * step_c,
                 step_l = (uint64_t)max_res * step_r;
        if (step_l > 0xFFFFFFFFull / (tcp.numlayers + 1ull)) fail("packet iterator too large");
        uint64_t incsize = (tcp.numlayers + 1ull) * step_l;
        if (incsize > (1ull << 31)) fail("limit: a tile of more than 2^31 packets");
        std::vector<u8> include(incsize, 0);
        u32 npoc = tcp.has_poc ? tcp.numpocs + 1 : 1;
        for (u32 pi = 0; pi < npoc; pi++) {
            POC poc;
            if (tcp.has_poc) {
                poc = tcp.pocs[pi];
                if (poc.layno1 > tcp.numlayers) poc.layno1 = tcp.numlayers;
            } else {
                poc.prg = tcp.prg;
                poc.resno0 = 0;
                poc.compno0 = 0;
                poc.resno1 = max_res;
                poc.compno1 = numcomps;
                poc.layno1 = tcp.numlayers;
            }
            if (poc.prg < 0) fail("Unknown progression order");   // COD's, no POC
            if (poc.prg > 4) continue;
            if (poc.compno0 >= numcomps || poc.compno1 >= numcomps + 1) continue;
            // emit: false stops this iterator (OpenJPEG's error return)
            bool stop = false;
            auto emit = [&](u32 l, u32 r, u32 c, u32 p) {
                uint64_t idx = l * step_l + r * step_r + c * step_c + p;
                if (idx >= incsize) {
                    stop = true;
                    return;
                }
                if (!include[idx]) {
                    include[idx] = 1;
                    out.push_back({l, r, c, p});
                }
            };
            if (poc.prg == 0 || poc.prg == 1) {   // LRCP, RLCP
                auto body = [&](u32 l, u32 r) {
                    for (u32 c = poc.compno0; c < poc.compno1 && !stop; c++) {
                        if (r >= tcs[c].numres) continue;
                        u32 np = tcs[c].res[r].pw * tcs[c].res[r].ph;
                        for (u32 p = 0; p < np && !stop; p++) emit(l, r, c, p);
                    }
                };
                if (poc.prg == 0) {
                    for (u32 l = 0; l < poc.layno1 && !stop; l++)
                        for (u32 r = poc.resno0; r < poc.resno1 && !stop; r++) body(l, r);
                } else {
                    for (u32 r = poc.resno0; r < poc.resno1 && !stop; r++)
                        for (u32 l = 0; l < poc.layno1 && !stop; l++) body(l, r);
                }
                continue;
            }
            // position-driven orders
            auto mindxy = [&](u32 c0, u32 c1, u32& dx, u32& dy) {
                dx = dy = 0;
                for (u32 c = c0; c < c1; c++) {
                    const Comp& ic = comps[c];
                    for (u32 r = 0; r < tcs[c].numres; r++) {
                        const Res& rs = tcs[c].res[r];
                        u32 e = rs.pdx + tcs[c].numres - 1 - r;
                        if (e < 32 && ic.dx <= 0xFFFFFFFFu / (1u << e)) {
                            u32 v = ic.dx * (1u << e);
                            dx = !dx ? v : std::min(dx, v);
                        }
                        e = rs.pdy + tcs[c].numres - 1 - r;
                        if (e < 32 && ic.dy <= 0xFFFFFFFFu / (1u << e)) {
                            u32 v = ic.dy * (1u << e);
                            dy = !dy ? v : std::min(dy, v);
                        }
                    }
                }
            };
            u32 ptx0 = (u32)tile_x0, pty0 = (u32)tile_y0, ptx1 = (u32)tile_x1, pty1 = (u32)tile_y1;
            // the body shared by RPCL, PCRL and CPRL at (r, y, x, c)
            auto body = [&](u32 r, u32 y, u32 x, u32 c) {
                const Comp& ic = comps[c];
                if (r >= tcs[c].numres) return;
                const Res& rs = tcs[c].res[r];
                u32 levelno = tcs[c].numres - 1 - r;
                if ((u32)(((uint64_t)ic.dx << levelno) >> levelno) != ic.dx ||
                    (u32)(((uint64_t)ic.dy << levelno) >> levelno) != ic.dy)
                    return;
                auto cdiv = [](uint64_t a, uint64_t b) { return (u32)((a + b - 1) / b); };
                u32 trx0 = cdiv(ptx0, (uint64_t)ic.dx << levelno);
                u32 try0 = cdiv(pty0, (uint64_t)ic.dy << levelno);
                u32 trx1 = cdiv(ptx1, (uint64_t)ic.dx << levelno);
                u32 try1 = cdiv(pty1, (uint64_t)ic.dy << levelno);
                u32 rpx = rs.pdx + levelno, rpy = rs.pdy + levelno;
                if (rpx >= 64 || rpy >= 64) return;
                if ((u32)(((uint64_t)ic.dx << rpx) >> rpx) != ic.dx ||
                    (u32)(((uint64_t)ic.dy << rpy) >> rpy) != ic.dy)
                    return;
                if (!(((uint64_t)y % ((uint64_t)ic.dy << rpy) == 0) ||
                      ((y == pty0) && (((uint64_t)try0 << levelno) % ((uint64_t)1 << rpy)))))
                    return;
                if (!(((uint64_t)x % ((uint64_t)ic.dx << rpx) == 0) ||
                      ((x == ptx0) && (((uint64_t)trx0 << levelno) % ((uint64_t)1 << rpx)))))
                    return;
                if (rs.pw == 0 || rs.ph == 0) return;
                if (trx0 == trx1 || try0 == try1) return;
                u32 prci = (cdiv(x, (uint64_t)ic.dx << levelno) >> rs.pdx) - (trx0 >> rs.pdx);
                u32 prcj = (cdiv(y, (uint64_t)ic.dy << levelno) >> rs.pdy) - (try0 >> rs.pdy);
                u32 precno = prci + prcj * rs.pw;
                for (u32 l = 0; l < poc.layno1 && !stop; l++) emit(l, r, c, precno);
            };
            if (poc.prg == 2 || poc.prg == 3) {   // RPCL, PCRL
                u32 dx, dy;
                mindxy(0, numcomps, dx, dy);
                if (dx == 0 || dy == 0) continue;
                if (poc.prg == 2) {
                    for (u32 r = poc.resno0; r < poc.resno1 && !stop; r++)
                        for (u32 y = pty0; y < pty1 && !stop; y += dy - (y % dy))
                            for (u32 x = ptx0; x < ptx1 && !stop; x += dx - (x % dx))
                                for (u32 c = poc.compno0; c < poc.compno1 && !stop; c++)
                                    body(r, y, x, c);
                } else {
                    for (u32 y = pty0; y < pty1 && !stop; y += dy - (y % dy))
                        for (u32 x = ptx0; x < ptx1 && !stop; x += dx - (x % dx))
                            for (u32 c = poc.compno0; c < poc.compno1 && !stop; c++) {
                                u32 rmax = std::min(poc.resno1, tcs[c].numres);
                                for (u32 r = poc.resno0; r < rmax && !stop; r++) body(r, y, x, c);
                            }
                }
            } else {                               // CPRL
                for (u32 c = poc.compno0; c < poc.compno1 && !stop; c++) {
                    u32 dx, dy;
                    mindxy(c, c + 1, dx, dy);
                    if (dx == 0 || dy == 0) {
                        stop = true;
                        break;
                    }
                    for (u32 y = pty0; y < pty1 && !stop; y += dy - (y % dy))
                        for (u32 x = ptx0; x < ptx1 && !stop; x += dx - (x % dx)) {
                            u32 rmax = std::min(poc.resno1, tcs[c].numres);
                            for (u32 r = poc.resno0; r < rmax && !stop; r++) body(r, y, x, c);
                        }
                }
            }
        }
    }

    static void init_seg(Cblk& cb, u32 index, u32 cblksty, bool first) {
        if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
        Seg& s = cb.segs[index];
        s = Seg();
        if (cblksty & STY_TERMALL) {
            s.maxpasses = 1;
        } else if (cblksty & STY_LAZY) {
            if (first) s.maxpasses = 10;
            else {
                u32 pm = cb.segs[index - 1].maxpasses;
                s.maxpasses = (pm == 1 || pm == 10) ? 2 : 1;
            }
        } else {
            s.maxpasses = 109;
        }
    }

    static u32 getnumpasses(Bio& bio) {
        if (!bio.read(1)) return 1;
        if (!bio.read(1)) return 2;
        u32 n = bio.read(2);
        if (n != 3) return 3 + n;
        n = bio.read(5);
        if (n != 31) return 6 + n;
        return 37 + bio.read(7);
    }

    // opj_t2_read_packet_header + opj_t2_read_packet_data; returns the
    // bytes consumed from the tile data
    u32 decode_packet(TCP& tcp, const PacketPos& pp, const u8* src, u32 maxlen) {
        TileComp& tc = tcs[pp.compno];
        Res& rs = tc.res[pp.resno];
        u32 cblksty = tcp.tccps[pp.compno].cblksty;
        if (pp.layno == 0) {
            for (u32 b = 0; b < rs.numbands; b++) {
                Band& bd = rs.bands[b];
                if (bd.empty()) continue;
                if (pp.precno >= bd.precs.size()) fail("Invalid precinct");
                Precinct& pc = bd.precs[pp.precno];
                pc.incl.reset();
                pc.imsb.reset();
                for (auto& cb : pc.cblks) {
                    cb.numsegs = 0;
                    cb.real_num_segs = 0;
                }
            }
        }
        for (u32 b = 0; b < rs.numbands; b++)
            if (!rs.bands[b].empty() && pp.precno >= rs.bands[b].precs.size())
                fail("Invalid precinct");
        const u8* cur = src;
        if (tcp.csty & 2) {   // SOP
            if (maxlen >= 6 && cur[0] == 0xFF && cur[1] == 0x91) cur += 6;
        }
        const u8* hstart;
        u32* hlen;
        u32 remaining;
        const u8** hptr;
        const u8* ppx_ptr;
        if (ppm) {
            ppx_ptr = ppm_buf.data() + ppm_pos;
            hptr = &ppx_ptr;
            hlen = &ppm_len;
        } else if (tcp.ppt) {
            ppx_ptr = tcp.ppt_buf.data() + (tcp.ppt_buf.size() - ppt_left);
            hptr = &ppx_ptr;
            hlen = &ppt_left;
        } else {
            hptr = &cur;
            remaining = (u32)(src + maxlen - cur);
            hlen = &remaining;
        }
        hstart = *hptr;
        const u8* hdata = hstart;
        Bio bio;
        bio.init(hdata, *hlen);
        u32 present = bio.read(1);
        bool data_present = present != 0;
        if (present) {
            for (u32 b = 0; b < rs.numbands; b++) {
                Band& bd = rs.bands[b];
                if (bd.empty()) continue;
                Precinct& pc = bd.precs[pp.precno];
                u32 ncb = pc.cw * pc.ch;
                for (u32 k = 0; k < ncb; k++) {
                    Cblk& cb = pc.cblks[k];
                    u32 included;
                    if (!cb.numsegs) included = tgt_decode(bio, pc.incl, k, (i32)(pp.layno + 1));
                    else included = bio.read(1);
                    if (!included) {
                        cb.numnewpasses = 0;
                        continue;
                    }
                    if (!cb.numsegs) {
                        u32 i = 0;
                        while (!tgt_decode(bio, pc.imsb, k, (i32)i)) ++i;
                        cb.Mb = (u32)bd.numbps;
                        cb.numbps = (u32)bd.numbps + 1 - i;
                        cb.numlenbits = 3;
                    }
                    cb.numnewpasses = getnumpasses(bio);
                    u32 inc = 0;
                    while (bio.read(1)) ++inc;
                    cb.numlenbits += inc;
                    u32 segno = 0;
                    if (!cb.numsegs) {
                        init_seg(cb, 0, cblksty, true);
                    } else {
                        segno = cb.numsegs - 1;
                        if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                            ++segno;
                            init_seg(cb, segno, cblksty, false);
                        }
                    }
                    i32 n = (i32)cb.numnewpasses;
                    // HT: the cleanup pass alone in the first segment, every
                    // later pass of the packet in the next (OpenJPEG's rule)
                    bool ht = (cblksty & STY_HT) != 0;
                    do {
                        Seg& s = cb.segs[segno];
                        if (ht) s.numnewpasses = segno == 0 ? 1 : (u32)n;
                        else s.numnewpasses = (u32)std::min<i32>((i32)(s.maxpasses - s.numpasses), n);
                        u32 bits = cb.numlenbits + ufloorlog2(s.numnewpasses);
                        if (bits > 32) fail("Invalid bit number in opj_t2_read_packet_header()");
                        s.newlen = bits ? bio.read(bits) : 0;
                        n -= (i32)s.numnewpasses;
                        if (n > 0) {
                            ++segno;
                            init_seg(cb, segno, cblksty, false);
                        }
                    } while (n > 0);
                }
            }
        }
        bio.inalign();
        hdata += bio.numbytes();
        if (tcp.csty & 4) {   // EPH: a missing or wrong one is an error
            if ((*hlen - (u32)(hdata - hstart)) < 2)
                fail("Not enough space for required EPH marker");
            if (hdata[0] != 0xFF || hdata[1] != 0x92) fail("Expected EPH marker");
            hdata += 2;
        }
        u32 hl = (u32)(hdata - hstart);
        *hlen -= hl;
        *hptr += hl;
        if (ppm) ppm_pos += hl;
        u32 read = (u32)(cur - src);
        if (!data_present) return read;
        // packet body
        const u8* body = src + read;
        u32 bodymax = maxlen - read;
        const u8* d = body;
        for (u32 b = 0; b < rs.numbands; b++) {
            Band& bd = rs.bands[b];
            if (bd.empty()) continue;
            Precinct& pc = bd.precs[pp.precno];
            u32 ncb = pc.cw * pc.ch;
            for (u32 k = 0; k < ncb; k++) {
                Cblk& cb = pc.cblks[k];
                if (!cb.numnewpasses) continue;
                u32 si;
                if (!cb.numsegs) {
                    si = 0;
                    ++cb.numsegs;
                } else {
                    si = cb.numsegs - 1;
                    if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
                        ++si;
                        ++cb.numsegs;
                    }
                }
                do {
                    Seg& s = cb.segs[si];
                    if ((uint64_t)(d - body) + s.newlen > bodymax)
                        fail(fmt("read: segment too long (%lld) with max (%lld) for codeblock %lld",
                                 s.newlen, bodymax, k));
                    cb.chunks.push_back({d, s.newlen});
                    d += s.newlen;
                    s.len += s.newlen;
                    s.numpasses += s.numnewpasses;
                    cb.numnewpasses -= s.numnewpasses;
                    s.real_num_passes = s.numpasses;
                    if (cb.numnewpasses > 0) {
                        ++si;
                        ++cb.numsegs;
                    }
                } while (cb.numnewpasses > 0);
                cb.real_num_segs = cb.numsegs;
            }
        }
        return read + (u32)(d - body);
    }

    u32 ppt_left = 0;

    void t2_decode(u32 tileno) {
        TCP& tcp = tcps[tileno];
        std::vector<PacketPos> order;
        iterate_packets(tileno, order);
        const u8* src = tcp.data.data();
        u32 maxlen = (u32)tcp.data.size();
        ppt_left = (u32)tcp.ppt_buf.size();
        for (const PacketPos& pp : order) {
            u32 n = decode_packet(tcp, pp, src, maxlen);
            tile_resno[pp.compno] = std::max(tile_resno[pp.compno], pp.resno);
            src += n;
            maxlen -= n;
        }
    }

    // ---- tier-1 and dequantisation (code-blocks in parallel)

    struct Job {
        Cblk* cb;
        Band* bd;
        u32 comp, res;
    };

    static void decode_cblk(T1& t1, std::vector<u8>& segbuf, Cblk& cb, u32 orient,
                            const TCCP& tccp) {
        int w = cb.x1 - cb.x0, h = cb.y1 - cb.y0;
        if (w < 0) w = 0;
        if (h < 0) h = 0;
        if (tccp.cblksty & STY_HT) {
            // opj_t1_ht_decode_cblk: one chunk is read where it lies (its
            // address mod 4 OpenJPEG's, the tile's data being as aligned),
            // several are joined in a buffer of their own
            if (tccp.roishift != 0) fail("We do not support ROI in decoding HT codeblocks");
            t1.setup(w, h);
            if (cb.Mb == 0 || cb.chunks.empty()) return;
            size_t total = 0;
            for (auto& ch : cb.chunks) total += ch.len;
            const u8* cdata = cb.chunks[0].data;
            if (cb.chunks.size() > 1) {
                segbuf.resize(total);
                size_t at = 0;
                for (auto& ch : cb.chunks) {
                    memcpy(segbuf.data() + at, ch.data, ch.len);
                    at += ch.len;
                }
                cdata = segbuf.data();
            }
            u32 ns = cb.numsegs;
            ht_decode_cblk(cdata, (u32)total, t1.data.data(), w, h, cb.Mb, cb.numbps, ns,
                           ns > 0 ? cb.segs[0].real_num_passes : 0, ns > 0 ? cb.segs[0].len : 0,
                           ns > 1 ? cb.segs[1].real_num_passes : 0, ns > 1 ? cb.segs[1].len : 0,
                           tccp.cblksty);
            return;
        }
        t1.setup(w, h);
        t1.zc = g_zc[orient];
        t1.vsc = (tccp.cblksty & STY_VSC) != 0;
        i32 bpno_plus_one = (i32)(tccp.roishift + cb.numbps);
        if (bpno_plus_one >= 31) fail("opj_t1_decode_cblk(): unsupported bpno_plus_one >= 31");
        reset_contexts(t1.ctx);
        if (cb.chunks.empty()) return;
        size_t total = 0;
        for (auto& ch : cb.chunks) total += ch.len;
        // the segments, each followed by OpenJPEG's synthetic 0xFF 0xFF
        segbuf.resize(total + 2 * (size_t)cb.real_num_segs + 2);
        std::vector<u8> joined;
        joined.reserve(total);
        for (auto& ch : cb.chunks) joined.insert(joined.end(), ch.data, ch.data + ch.len);
        u32 sty = tccp.cblksty;
        u32 passtype = 2;
        size_t idx = 0, out = 0;
        for (u32 s = 0; s < cb.real_num_segs; s++) {
            Seg& sg = cb.segs[s];
            bool raw = (bpno_plus_one <= (i32)cb.numbps - 4) && passtype < 2 && (sty & STY_LAZY);
            u8* seg = segbuf.data() + out;
            memcpy(seg, joined.data() + idx, sg.len);
            seg[sg.len] = 0xFF;
            seg[sg.len + 1] = 0xFF;
            out += sg.len + 2;
            if (raw) t1.mq.raw_init(seg);
            else t1.mq.init(seg, sg.len);
            idx += sg.len;
            for (u32 p = 0; p < sg.real_num_passes && bpno_plus_one >= 1; p++) {
                if (passtype == 0) t1.sigpass(bpno_plus_one, raw);
                else if (passtype == 1) t1.refpass(bpno_plus_one, raw);
                else t1.clnpass(bpno_plus_one, (sty & STY_SEGSYM) != 0);
                if ((sty & STY_RESET) && !raw) reset_contexts(t1.ctx);
                if (++passtype == 3) {
                    passtype = 0;
                    bpno_plus_one--;
                }
            }
        }
    }

    void t1_decode(u32 tileno) {
        TCP& tcp = tcps[tileno];
        std::vector<Job> jobs;
        for (u32 c = 0; c < numcomps; c++) {
            TileComp& tc = tcs[c];
            Res& top = tc.res[tc.numres - 1];
            size_t tw_ = (size_t)(top.x1 - top.x0), th_ = (size_t)(top.y1 - top.y0);
            if (th_ > 0 && tw_ > SIZE_MAX / th_) fail("Size of tile data exceeds system limits");
            if (tw_ * th_ > (size_t)1 << 31) fail("limit: a tile-component of more than 2^31 samples");
            tc.data.assign(tw_ * th_, 0);
            for (u32 r = 0; r < tc.numres; r++)
                for (u32 b = 0; b < tc.res[r].numbands; b++)
                    for (auto& pc : tc.res[r].bands[b].precs)
                        for (auto& cb : pc.cblks) jobs.push_back({&cb, &tc.res[r].bands[b], c, r});
        }
        parallel_for(jobs.size(), [&](size_t j) {
            thread_local T1 t1;
            thread_local std::vector<u8> segbuf;
            const Job& jb = jobs[j];
            Cblk& cb = *jb.cb;
            Band& bd = *jb.bd;
            TileComp& tc = tcs[jb.comp];
            const TCCP& tccp = tcp.tccps[jb.comp];
            size_t tw_ = (size_t)(tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0);
            decode_cblk(t1, segbuf, cb, bd.bandno, tccp);
            int w = t1.w, h = t1.h;
            i32* dp = t1.data.data();
            if (tccp.roishift) {
                if (tccp.roishift >= 31) {
                    std::fill(t1.data.begin(), t1.data.end(), 0);
                } else {
                    i32 thresh = 1 << tccp.roishift;
                    for (auto& v : t1.data) {
                        i32 mag = v < 0 ? -v : v;
                        if (mag >= thresh) {
                            mag >>= tccp.roishift;
                            v = v < 0 ? -mag : mag;
                        }
                    }
                }
            }
            i32 x = cb.x0 - bd.x0, y = cb.y0 - bd.y0;
            if (bd.bandno & 1) x += tc.res[jb.res - 1].x1 - tc.res[jb.res - 1].x0;
            if (bd.bandno & 2) y += tc.res[jb.res - 1].y1 - tc.res[jb.res - 1].y0;
            if (tccp.qmfbid == 1) {
                for (int jj = 0; jj < h; jj++) {
                    i32* o = &tc.data[(size_t)(y + jj) * tw_ + x];
                    for (int i = 0; i < w; i++) o[i] = dp[jj * w + i] / 2;
                }
            } else {
                const float st = 0.5f * bd.stepsize;
                for (int jj = 0; jj < h; jj++) {
                    float* o = reinterpret_cast<float*>(&tc.data[(size_t)(y + jj) * tw_ + x]);
                    for (int i = 0; i < w; i++) o[i] = (float)dp[jj * w + i] * st;
                }
            }
        });
    }

    // ---- inverse transforms

    static void idwt53_1d(i32* a, i32 sn, i32 dn, int cas, std::vector<i32>& tmp) {
        i32 n = sn + dn;
        if (cas == 0) {
            if (n <= 1) return;
        } else {
            if (n == 1) {
                a[0] /= 2;
                return;
            }
        }
        // interleave: lows at 2i + cas, highs at 2i + 1 - cas
        tmp.resize(n);
        i32* x = tmp.data();
        for (i32 i = 0; i < sn; i++) x[2 * i + cas] = a[i];
        for (i32 i = 0; i < dn; i++) x[2 * i + 1 - cas] = a[sn + i];
        auto at = [&](i32 k) -> i32 {   // symmetric extension
            if (k < 0) k = -k;
            if (k >= n) k = 2 * (n - 1) - k;
            return x[k];
        };
        // two's complement wrap, as OpenJPEG's opj_int_add_no_overflow
        auto add = [](i32 a, i32 b) { return (i32)((u32)a + (u32)b); };
        for (i32 k = cas; k < n; k += 2)
            x[k] = add(x[k], -(add(add(at(k - 1), at(k + 1)), 2) >> 2));
        for (i32 k = 1 - cas; k < n; k += 2)
            x[k] = add(x[k], add(at(k - 1), at(k + 1)) >> 1);
        memcpy(a, x, n * sizeof(i32));
    }

    static void idwt97_1d(float* a, i32 sn, i32 dn, int cas, std::vector<float>& tmp) {
        if (cas == 0) {
            if (!(dn > 0 || sn > 1)) return;
        } else {
            if (!(sn > 0 || dn > 1)) return;
        }
        i32 n = sn + dn;
        tmp.resize(n);
        float* x = tmp.data();
        const float K = 1.230174105f, two_invK = 1.625732422f;
        for (i32 i = 0; i < sn; i++) x[2 * i + cas] = a[i] * K;
        for (i32 i = 0; i < dn; i++) x[2 * i + 1 - cas] = a[sn + i] * two_invK;
        auto lift = [&](int start, float c) {
            for (i32 k = start; k < n; k += 2) {
                float l = k - 1 >= 0 ? x[k - 1] : x[k + 1];
                float r = k + 1 < n ? x[k + 1] : x[k - 1];
                float s = l + r;
                float p = s * c;
                x[k] = x[k] + p;
            }
        };
        lift(cas, -0.443506852f);        // -delta on the lows
        lift(1 - cas, -0.882911075f);    // -gamma on the highs
        lift(cas, 0.052980118f);         // -beta
        lift(1 - cas, 1.586134342f);     // -alpha
        memcpy(a, x, n * sizeof(float));
    }

    void dwt_decode(TileComp& tc, u32 numres, bool real) {
        if (numres <= 1) return;
        Res& top = tc.res[tc.numres - 1];
        size_t w = (size_t)(top.x1 - top.x0);
        if (w == 0) return;
        std::vector<i32> col, tmpi;
        std::vector<float> colf, tmpf;
        i32 rw = tc.res[0].x1 - tc.res[0].x0, rh = tc.res[0].y1 - tc.res[0].y0;
        for (u32 r = 1; r < numres; r++) {
            Res& rs = tc.res[r];
            i32 sn = rw, vsn = rh;
            rw = rs.x1 - rs.x0;
            rh = rs.y1 - rs.y0;
            int hcas = rs.x0 % 2, vcas = rs.y0 % 2;
            for (i32 j = 0; j < rh; j++) {
                i32* row = &tc.data[(size_t)j * w];
                if (real) idwt97_1d(reinterpret_cast<float*>(row), sn, rw - sn, hcas, tmpf);
                else idwt53_1d(row, sn, rw - sn, hcas, tmpi);
            }
            col.resize(rh);
            for (i32 i = 0; i < rw; i++) {
                for (i32 j = 0; j < rh; j++) col[j] = tc.data[(size_t)j * w + i];
                if (real)
                    idwt97_1d(reinterpret_cast<float*>(col.data()), vsn, rh - vsn, vcas, tmpf);
                else idwt53_1d(col.data(), vsn, rh - vsn, vcas, tmpi);
                for (i32 j = 0; j < rh; j++) tc.data[(size_t)j * w + i] = col[j];
            }
        }
    }

    static i32 lrintf_even(float v) {
        // opj_lrintf: round half to even (the SSE cvtss2si under the
        // default rounding mode)
        return (i32)std::nearbyint(v);
    }

    void decode_tile(u32 tileno) {
        TCP& tcp = tcps[tileno];
        init_tile(tileno);
        t2_decode(tileno);
        t1_decode(tileno);
        for (u32 c = 0; c < numcomps; c++)
            dwt_decode(tcs[c], tile_resno[c] + 1, tcp.tccps[c].qmfbid != 1);
        // MCT
        if (tcp.mct) {
            if (numcomps >= 3) {
                TileComp& c0 = tcs[0];
                Res& r0 = c0.res[c0.numres - 1];
                size_t n = (size_t)(r0.x1 - r0.x0) * (size_t)(r0.y1 - r0.y0);
                if (tcs[1].numres != c0.numres || tcs[2].numres != c0.numres)
                    fail("Tiles don't all have the same dimension. Skip the MCT step.");
                Res& r1 = tcs[1].res[c0.numres - 1];
                Res& r2 = tcs[2].res[c0.numres - 1];
                if (tile_resno[0] != tile_resno[1] || tile_resno[0] != tile_resno[2] ||
                    (size_t)(r1.x1 - r1.x0) * (size_t)(r1.y1 - r1.y0) != n ||
                    (size_t)(r2.x1 - r2.x0) * (size_t)(r2.y1 - r2.y0) != n)
                    fail("Tiles don't all have the same dimension. Skip the MCT step.");
                i32 *a = tcs[0].data.data(), *b = tcs[1].data.data(), *d = tcs[2].data.data();
                if (tcp.tccps[0].qmfbid == 1) {
                    for (size_t i = 0; i < n; i++) {
                        i32 y = a[i], u = b[i], v = d[i];
                        i32 g = y - ((u + v) >> 2);
                        a[i] = v + g;
                        b[i] = g;
                        d[i] = u + g;
                    }
                } else {
                    float *fa = reinterpret_cast<float*>(a), *fb = reinterpret_cast<float*>(b),
                          *fd = reinterpret_cast<float*>(d);
                    for (size_t i = 0; i < n; i++) {
                        float y = fa[i], u = fb[i], v = fd[i];
                        float r = y + (v * 1.402f);
                        float g = y - (u * 0.34413f) - (v * 0.71414f);
                        float bb = y + (u * 1.772f);
                        fa[i] = r;
                        fb[i] = g;
                        fd[i] = bb;
                    }
                }
            }
        }
        // DC level shift and clamp, over the decoded resolution
        for (u32 c = 0; c < numcomps; c++) {
            TileComp& tc = tcs[c];
            const TCCP& tccp = tcp.tccps[c];
            const Comp& ic = comps[c];
            Res& rr = tc.res[tile_resno[c]];
            Res& top = tc.res[tc.numres - 1];
            i32 w = rr.x1 - rr.x0, h = rr.y1 - rr.y0;
            size_t stride = (size_t)(top.x1 - top.x0);
            i32 lo, hi;
            if (ic.sgnd) {
                lo = -(1 << (ic.prec - 1));
                hi = (1 << (ic.prec - 1)) - 1;
            } else {
                lo = 0;
                hi = (i32)((1u << ic.prec) - 1);
            }
            for (i32 j = 0; j < h; j++) {
                i32* p = &tc.data[(size_t)j * stride];
                if (tccp.qmfbid == 1) {
                    // OpenJPEG adds in 32 bits (an MCC offset may wrap it)
                    for (i32 i = 0; i < w; i++) {
                        i32 v = (i32)((u32)p[i] + (u32)tccp.dc_shift);
                        p[i] = v < lo ? lo : (v > hi ? hi : v);
                    }
                } else {
                    for (i32 i = 0; i < w; i++) {
                        float f;
                        memcpy(&f, &p[i], 4);
                        if (f > (float)INT_MAX) p[i] = hi;
                        else if (f < (float)INT_MIN) p[i] = lo;
                        else {
                            i64 v = (i64)lrintf_even(f) + tccp.dc_shift;
                            p[i] = (i32)(v < lo ? lo : (v > hi ? hi : v));
                        }
                    }
                }
            }
        }
    }

    void update_image(u32 tileno) {
        (void)tileno;
        for (u32 c = 0; c < numcomps; c++) {
            Comp& ic = comps[c];
            TileComp& tc = tcs[c];
            if (!ic.has_data) {
                ic.data.assign((size_t)ic.w * ic.h, 0);
                ic.has_data = true;
            }
            Res& top = tc.res[tc.numres - 1];
            size_t stride = (size_t)(top.x1 - top.x0);
            for (i32 y = tc.y0; y < tc.y1; y++) {
                i64 dy = (i64)y - ic.y0;
                if (dy < 0 || dy >= ic.h) continue;
                for (i32 x = tc.x0; x < tc.x1; x++) {
                    i64 dx = (i64)x - ic.x0;
                    if (dx < 0 || dx >= ic.w) continue;
                    ic.data[(size_t)dy * ic.w + dx] =
                        tc.data[(size_t)(y - tc.y0) * stride + (x - tc.x0)];
                }
            }
        }
    }

    // opj_j2k_decode_tile's tail: the next marker is SOT or EOC
    void after_tile() {
        can_decode = false;
        state &= ~ST_DATA;
        if (left() == 0 && state == ST_NEOC) return;
        if (state != ST_EOC) {
            u32 m = read_marker_or_fail();
            if (m == M_EOC) {
                cur_tile = 0;
                state = ST_EOC;
            } else if (m != M_SOT) {
                if (left() == 0) {   // "Stream does not end with EOC"
                    state = ST_NEOC;
                    return;
                }
                fail("Stream too short, expected SOT");
            }
        }
    }

    void decode_all() {
        init_luts();
        read_main_header();
        bool single = tw == 1 && th == 1 && tx0 == 0 && ty0 == 0 && x0 == 0 && y0 == 0 &&
                      (u32)x1 == tdx && (u32)y1 == tdy;
        if (single) {
            if (!read_tile_header()) fail("Failed to decode tile 1/1");
            u32 t = cur_tile;
            if (!tcps[t].has_data) fail("Failed to decode tile 1/1");
            decode_tile(t);
            update_image(t);
            tcps[t].data.clear();
            tcps[t].has_data = false;
            after_tile();
            return;
        }
        u32 ntiles = tw * th, done = 0;
        for (;;) {
            if (!read_tile_header()) break;
            u32 t = cur_tile;
            if (!tcps[t].has_data) fail("Failed to decode tile");
            decode_tile(t);
            update_image(t);
            tcps[t].data.clear();
            tcps[t].data.shrink_to_fit();
            tcps[t].has_data = false;
            after_tile();
            if (left() == 0 && state == ST_NEOC) break;
            if (++done == ntiles) break;
        }
        for (u32 c = 0; c < numcomps; c++)
            if (!comps[c].has_data) fail("Failed to decode all used components");
    }
};

// ---------------------------------------------------------------- encoder

struct MQEnc {
    std::vector<u8> buf;   // buf[0] is OpenJPEG's fake byte before the data
    size_t bp;
    u32 a, c, ct;
    void init() {
        buf.assign(1, 0);
        bp = 0;
        a = 0x8000;
        c = 0;
        ct = 12;
    }
    u8& at(size_t i) {
        if (i >= buf.size()) buf.resize(i + 1, 0);
        return buf[i];
    }
    void byteout() {
        if (buf[bp] == 0xFF) {
            bp++;
            at(bp) = (u8)(c >> 20);
            c &= 0xFFFFF;
            ct = 7;
        } else if ((c & 0x8000000) == 0) {
            bp++;
            at(bp) = (u8)(c >> 19);
            c &= 0x7FFFF;
            ct = 8;
        } else {
            buf[bp]++;
            if (buf[bp] == 0xFF) {
                c &= 0x7FFFFFF;
                bp++;
                at(bp) = (u8)(c >> 20);
                c &= 0xFFFFF;
                ct = 7;
            } else {
                bp++;
                at(bp) = (u8)(c >> 19);
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }
    void renorme() {
        do {
            a <<= 1;
            c <<= 1;
            ct--;
            if (ct == 0) byteout();
        } while ((a & 0x8000) == 0);
    }
    void encode(Ctx& cx, int d) {
        const MQState& s = kMQ[cx.state];
        if (cx.mps == d) {
            a -= s.qe;
            if ((a & 0x8000) == 0) {
                if (a < s.qe) a = s.qe;
                else c += s.qe;
                cx.state = s.nmps;
                renorme();
            } else {
                c += s.qe;
            }
        } else {
            a -= s.qe;
            if (a < s.qe) c += s.qe;
            else a = s.qe;
            if (s.sw) cx.mps = !cx.mps;
            cx.state = s.nlps;
            renorme();
        }
    }
    // OpenJPEG's opj_mqc_flush; returns the code-block's byte count
    u32 flush() {
        u32 tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c <<= ct;
        byteout();
        c <<= ct;
        byteout();
        if (buf[bp] != 0xFF) bp++;
        return (u32)(bp - 1);   // data start at buf[1]
    }
};

// one coding pass as OpenJPEG's rate allocation sees it: the bytes of the
// code-block up to its end, the distortion removed up to its end
struct EncPass {
    u32 rate;
    double dist;
};

// OpenJPEG's opj_dwt_norms: the 5/3 synthesis gains by orientation and
// level (the level a band's resolution is below the top)
const double kNorms53[4][10] = {
    {1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9},
    {.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 48.00, 96.00}};

// one code-block's coefficients (w x h, row-major) -> its MQ bytes, the
// number of magnitude bit-planes and each pass's rate and distortion
// (opj_t1_encode_cblk: every pass, only the last terminated; a pass's rate
// is the coder's byte count + 3, or its flushed count for the last, then
// made non-decreasing and kept off a 0xFF; its distortion opj_t1_getwmsedec
// of the pass's nmsedec, with the band's 5/3 norm and step 1)
u32 t1_encode(const i32* coef, int w, int h, u32 orient, u32 level, std::vector<u8>& out,
              std::vector<EncPass>& passes) {
    u32 mx = 0;
    for (int i = 0; i < w * h; i++) {
        u32 m = coef[i] < 0 ? (u32)(-(i64)coef[i]) : (u32)coef[i];
        if (m > mx) mx = m;
    }
    u32 numbps = mx ? ufloorlog2(mx) + 1 : 0;
    out.clear();
    passes.clear();
    if (!numbps) return 0;
    T1 t;
    t.setup(w, h);
    t.zc = g_zc[orient];
    reset_contexts(t.ctx);
    MQEnc mq;
    mq.init();
    const double norm = kNorms53[orient][level];
    auto mag = [&](int x, int y) {
        i32 v = coef[(size_t)y * w + x];
        return v < 0 ? (u32)(-(i64)v) : (u32)v;
    };
    auto neg = [&](int x, int y) { return coef[(size_t)y * w + x] < 0 ? 1 : 0; };
    i32 nmsedec = 0;
    int bp = 0;
    // OpenJPEG keeps the magnitudes with 6 fraction bits below bit 0
    auto nmse_sig = [&](int x, int y) {
        u32 m = mag(x, y) << NMSE_FRAC;
        return bp > 0 ? g_nmse_sig[(m >> bp) & ((1 << NMSE_BITS) - 1)]
                      : g_nmse_sig0[m & ((1 << NMSE_BITS) - 1)];
    };
    auto nmse_ref = [&](int x, int y) {
        u32 m = mag(x, y) << NMSE_FRAC;
        return bp > 0 ? g_nmse_ref[(m >> bp) & ((1 << NMSE_BITS) - 1)]
                      : g_nmse_ref0[m & ((1 << NMSE_BITS) - 1)];
    };
    auto code_sign = [&](int x, int y) {
        u8 lu = g_sc[sc_index(*t.fl(x, y))];
        int s = neg(x, y);
        mq.encode(t.ctx[lu & 0x7F], s ^ (lu >> 7));
        nmsedec += nmse_sig(x, y);
        t.set_sig(x, y, s);
    };
    double cum = 0.0;
    auto end_pass = [&](bool last) {
        // (w1 · norm · step · 2^bp)^2 · nmsedec / 8192, w1 = step = 1
        double wmse = norm * (double)(1 << bp);
        wmse *= wmse * nmsedec / 8192.0;
        cum += wmse;
        // bytes out so far (bp less the fake byte) + 3, or the flushed count
        u32 rate = last ? mq.flush() : (u32)((i64)mq.bp - 1 + 3);
        passes.push_back({rate, cum});
        nmsedec = 0;
    };
    for (bp = (int)numbps - 1; bp >= 0; bp--) {
        u32 one = 1u << bp;
        if (bp != (int)numbps - 1) {
            // significance propagation
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; x++)
                    for (int y = k; y < k + 4 && y < h; y++) {
                        u32 f = *t.fl(x, y);
                        if ((f & (F_SIG | F_PI)) || !(f & F_NEIGH)) continue;
                        int v = (mag(x, y) & one) ? 1 : 0;
                        mq.encode(t.ctx[t.zc[f & F_NEIGH]], v);
                        if (v) code_sign(x, y);
                        *t.fl(x, y) |= F_PI;
                    }
            end_pass(false);
            // magnitude refinement
            for (int k = 0; k < h; k += 4)
                for (int x = 0; x < w; x++)
                    for (int y = k; y < k + 4 && y < h; y++) {
                        u32& f = *t.fl(x, y);
                        if ((f & (F_SIG | F_PI)) != F_SIG) continue;
                        nmsedec += nmse_ref(x, y);
                        int cx = (f & F_MU) ? CTX_MAG + 2 : ((f & F_NEIGH) ? CTX_MAG + 1 : CTX_MAG);
                        mq.encode(t.ctx[cx], (mag(x, y) & one) ? 1 : 0);
                        f |= F_MU;
                    }
            end_pass(false);
        }
        // cleanup
        int full = h & ~3;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; x++) {
                int y0 = k;
                if (k < full && !*t.fl(x, k) && !*t.fl(x, k + 1) && !*t.fl(x, k + 2) &&
                    !*t.fl(x, k + 3)) {
                    int r = 0;
                    while (r < 4 && !(mag(x, k + r) & one)) r++;
                    mq.encode(t.ctx[CTX_AGG], r != 4);
                    if (r == 4) continue;
                    mq.encode(t.ctx[CTX_UNI], r >> 1);
                    mq.encode(t.ctx[CTX_UNI], r & 1);
                    code_sign(x, k + r);
                    y0 = k + r + 1;
                    for (int y = y0; y < k + 4; y++) {
                        int v = (mag(x, y) & one) ? 1 : 0;
                        mq.encode(t.ctx[t.zc[*t.fl(x, y) & F_NEIGH]], v);
                        if (v) code_sign(x, y);
                    }
                    y0 = k + 4;
                }
                for (int y = y0; y < k + 4 && y < h; y++) {
                    u32 f = *t.fl(x, y);
                    if (f & (F_SIG | F_PI)) continue;
                    int v = (mag(x, y) & one) ? 1 : 0;
                    mq.encode(t.ctx[t.zc[f & F_NEIGH]], v);
                    if (v) code_sign(x, y);
                }
                for (int y = k; y < k + 4 && y < h; y++) *t.fl(x, y) &= ~F_PI;
            }
        end_pass(bp == 0);
    }
    u32 n = passes.back().rate;
    out.assign(mq.buf.begin() + 1, mq.buf.begin() + 1 + n);
    // rates made non-decreasing from the end, then kept off a 0xFF
    u32 last = n;
    for (size_t i = passes.size(); i-- > 0;) {
        if (passes[i].rate > last) passes[i].rate = last;
        else last = passes[i].rate;
    }
    for (auto& p : passes)
        if (out[p.rate - 1] == 0xFF) p.rate--;
    return numbps;
}

// forward 5/3 on one line (lows first, then highs), even first sample
void fdwt53_1d(i32* a, i32 n, std::vector<i32>& tmp) {
    if (n <= 1) return;
    i32 sn = (n + 1) / 2, dn = n / 2;
    tmp.assign(a, a + n);
    i32* x = tmp.data();
    auto S = [&](i32 i) { return x[2 * (i < 0 ? 0 : (i >= sn ? sn - 1 : i))]; };
    for (i32 i = 0; i < dn; i++) x[2 * i + 1] -= (S(i) + S(i + 1)) >> 1;
    auto D = [&](i32 i) { return x[2 * (i < 0 ? 0 : (i >= dn ? dn - 1 : i)) + 1]; };
    for (i32 i = 0; i < sn; i++) x[2 * i] += (D(i - 1) + D(i) + 2) >> 2;
    for (i32 i = 0; i < sn; i++) a[i] = x[2 * i];
    for (i32 i = 0; i < dn; i++) a[sn + i] = x[2 * i + 1];
}

struct BioW {
    std::vector<u8>& out;
    u32 buf = 0, ct = 8;
    explicit BioW(std::vector<u8>& o) : out(o) {}
    void byteout() {
        buf = (buf << 8) & 0xFFFF;
        ct = buf == 0xFF00 ? 7 : 8;
        out.push_back((u8)(buf >> 8));
    }
    void put(u32 b) {
        if (ct == 0) byteout();
        ct--;
        buf |= b << ct;
    }
    void write(u32 v, int n) {
        for (int i = n - 1; i >= 0; i--) put((v >> i) & 1);
    }
    void flush() {
        byteout();
        if (ct == 7) byteout();
    }
};

struct TagTreeW {
    struct Node {
        i32 parent, value, low, known;
    };
    std::vector<Node> nodes;
    void build(u32 w, u32 h) {
        TagTree t;
        t.build(w, h);
        nodes.clear();
        for (auto& n : t.nodes) nodes.push_back({n.parent, 999, 0, 0});
    }
    void setvalue(u32 leaf, i32 v) {
        i32 n = (i32)leaf;
        while (n >= 0 && nodes[n].value > v) {
            nodes[n].value = v;
            n = nodes[n].parent;
        }
    }
    void encode(BioW& bio, u32 leaf, i32 threshold) {
        i32 stk[40];
        int sp = 0;
        i32 node = (i32)leaf;
        while (nodes[node].parent >= 0) {
            stk[sp++] = node;
            node = nodes[node].parent;
        }
        i32 low = 0;
        for (;;) {
            Node& nd = nodes[node];
            if (low > nd.low) nd.low = low;
            else low = nd.low;
            while (low < threshold) {
                if (low >= nd.value) {
                    if (!nd.known) {
                        bio.write(1, 1);
                        nd.known = 1;
                    }
                    break;
                }
                bio.write(0, 1);
                ++low;
            }
            nd.low = low;
            if (sp == 0) break;
            node = stk[--sp];
        }
    }
};

void put16(std::vector<u8>& o, u32 v) {
    o.push_back((u8)(v >> 8));
    o.push_back((u8)v);
}
void put32(std::vector<u8>& o, u32 v) {
    put16(o, v >> 16);
    put16(o, v & 0xFFFF);
}

constexpr int ENC_LEVELS = 5, ENC_CBLK = 6;
const char kComment[] = "Created by OpenJPEG version 2.5.3";
// the JP2 boxes before the codestream: jP, ftyp, jp2h (ihdr, colr) and the
// jp2c box's header
constexpr u32 JP2_HEAD = 12 + 20 + 45 + 8;

struct ECB {
    i32 x0, y0, x1, y1;
    u32 numbps = 0;
    std::vector<u8> data;
    std::vector<EncPass> passes;
    u32 npass = 0;   // the passes in the layer
};

struct EBand {
    u32 bandno, cw, ch, comp, level;
    i32 x0, y0, offx, offy, numbps;
    bool empty;
    std::vector<ECB> cbs;
};

// the tile's packets for each code-block's npass (LRCP: resolution, then
// component; one layer, one precinct a resolution), appended to out, or
// with out null only counted (opj_t2_encode_packet; OpenJPEG writes no
// empty packet: the first bit is always 1)
size_t write_packets(const std::vector<EBand>& bands, u32 numres, u32 nc, std::vector<u8>* out) {
    size_t total = 0, bi = 0;
    std::vector<u8> hdr;
    TagTreeW incl, imsb;
    for (u32 r = 0; r < numres; r++) {
        for (u32 c = 0; c < nc; c++) {
            u32 nb = r == 0 ? 1 : 3;
            const EBand* eb = &bands[bi];
            bi += nb;
            hdr.clear();
            BioW bio(hdr);
            bio.write(1, 1);
            for (u32 b = 0; b < nb; b++) {
                const EBand& e = eb[b];
                if (e.empty) continue;
                u32 ncb = e.cw * e.ch;
                incl.build(e.cw, e.ch);
                imsb.build(e.cw, e.ch);
                for (u32 k = 0; k < ncb; k++) imsb.setvalue(k, e.numbps - (i32)e.cbs[k].numbps);
                for (u32 k = 0; k < ncb; k++)
                    if (e.cbs[k].npass) incl.setvalue(k, 0);
                for (u32 k = 0; k < ncb; k++) {
                    const ECB& cb = e.cbs[k];
                    incl.encode(bio, k, 1);
                    if (!cb.npass) continue;
                    imsb.encode(bio, k, 999);
                    u32 np = cb.npass;   // one segment: only the last pass terminates
                    if (np == 1) bio.write(0, 1);
                    else if (np == 2) bio.write(2, 2);
                    else if (np <= 5) bio.write(0xC | (np - 3), 4);
                    else if (np <= 36) bio.write(0x1E0 | (np - 6), 9);
                    else bio.write(0xFF80 | (np - 37), 16);
                    u32 len = cb.passes[np - 1].rate;
                    // Lblock starts at 3: the comma code of its increment
                    i32 inc = (i32)ufloorlog2(len) + 1 - (3 + (i32)ufloorlog2(np));
                    if (inc < 0) inc = 0;
                    for (i32 i = 0; i < inc; i++) bio.write(1, 1);
                    bio.write(0, 1);
                    bio.write(len, 3 + inc + (int)ufloorlog2(np));
                }
            }
            bio.flush();
            total += hdr.size();
            if (out) out->insert(out->end(), hdr.begin(), hdr.end());
            for (u32 b = 0; b < nb; b++)
                for (const ECB& cb : eb[b].cbs) {
                    if (!cb.npass) continue;
                    u32 len = cb.passes[cb.npass - 1].rate;
                    total += len;
                    if (out) out->insert(out->end(), cb.data.begin(), cb.data.begin() + len);
                }
        }
    }
    return total;
}

// opj_tcd_makelayer for the one layer: in each code-block the passes up to
// the last whose rate-distortion slope, taken from the last pass kept so
// far, reaches thresh (all of them for thresh < 0).  Returns whether no
// code-block's count changed.
bool make_layer(std::vector<EBand>& bands, double thresh) {
    bool same = true;
    for (EBand& e : bands)
        for (ECB& cb : e.cbs) {
            u32 n = 0, total = (u32)cb.passes.size();
            if (thresh < 0) {
                n = total;
            } else {
                for (u32 p = 0; p < total; p++) {
                    u32 dr = cb.passes[p].rate - (n ? cb.passes[n - 1].rate : 0);
                    double dd = cb.passes[p].dist - (n ? cb.passes[n - 1].dist : 0.0);
                    if (!dr) {
                        if (dd != 0) n = p + 1;
                        continue;
                    }
                    if (thresh - dd / dr < DBL_EPSILON) n = p + 1;
                }
            }
            if (cb.npass != n) {
                same = false;
                cb.npass = n;
            }
        }
    return same;
}

// OpenJPEG 2.5.3's opj_tcd_rateallocate for one layer of at most maxlen
// bytes of packets: bisect the threshold between the least and the
// greatest slope of any pass, sizing the packets (opj_t2_encode_packets in
// THRESH_CALC mode) only where the layer changed, until the threshold moves
// by no more than 5e-6 of itself; then keep the passes of the least
// threshold that fitted.
void rate_allocate(std::vector<EBand>& bands, u32 numres, u32 nc, u32 maxlen) {
    double mn = DBL_MAX, mx = 0;
    for (const EBand& e : bands)
        for (const ECB& cb : e.cbs)
            for (size_t p = 0; p < cb.passes.size(); p++) {
                i32 dr = (i32)(cb.passes[p].rate - (p ? cb.passes[p - 1].rate : 0));
                double dd = cb.passes[p].dist - (p ? cb.passes[p - 1].dist : 0.0);
                if (dr == 0) continue;
                double slope = dd / dr;
                if (slope < mn) mn = slope;
                if (slope > mx) mx = slope;
            }
    double lo = mn, hi = mx, thresh = 0, stable = 0;
    bool last_ok = false;
    for (int i = 0; i < 128; i++) {
        double next = (lo + hi) / 2;
        if (std::fabs(next - thresh) <= 0.5 * 1e-5 * thresh) break;
        thresh = next;
        // a layer unchanged since the last sizing fits as it did then
        bool same = make_layer(bands, thresh) && i != 0;
        if (!same) last_ok = write_packets(bands, numres, nc, nullptr) <= maxlen;
        if (last_ok) {
            hi = thresh;
            stable = thresh;
        } else {
            lo = thresh;
        }
    }
    make_layer(bands, stable == 0 ? thresh : stable);
}

// the JP2 file cv2.imwrite(x.jp2, bgr, [IMWRITE_JPEG2000_COMPRESSION_X1000,
// x1000]) writes for an 8-bit colour image (R, G, B in the codestream):
// every pass at 1000, else one layer at rate 1000 / x1000
void encode_jp2(const u8* px, u32 w, u32 h, int x1000, std::vector<u8>& file) {
    const u32 nc = 3;
    init_luts();
    const u32 numres = ENC_LEVELS + 1;
    // the components: DC shift, then 5 levels of the forward 5/3 (per
    // level the columns, then the rows), Mallat layout
    std::vector<std::vector<i32>> planes(nc, std::vector<i32>((size_t)w * h));
    for (u32 c = 0; c < nc; c++)
        for (size_t i = 0; i < (size_t)w * h; i++) planes[c][i] = (i32)px[i * nc + c] - 128;
    // resolution sizes (image origin 0: every resolution starts at 0)
    std::vector<u32> rw(numres), rh(numres);
    for (u32 r = 0; r < numres; r++) {
        u32 lev = numres - 1 - r;
        rw[r] = (u32)ceildivpow2((i32)w, lev);
        rh[r] = (u32)ceildivpow2((i32)h, lev);
    }
    std::vector<i32> line, tmp;
    for (u32 c = 0; c < nc; c++) {
        i32* d = planes[c].data();
        for (u32 r = numres - 1; r >= 1; r--) {
            u32 cw = rw[r], ch = rh[r];
            line.resize(ch);
            for (u32 x = 0; x < cw; x++) {
                for (u32 y = 0; y < ch; y++) line[y] = d[(size_t)y * w + x];
                fdwt53_1d(line.data(), (i32)ch, tmp);
                for (u32 y = 0; y < ch; y++) d[(size_t)y * w + x] = line[y];
            }
            for (u32 y = 0; y < ch; y++) fdwt53_1d(&d[(size_t)y * w], (i32)cw, tmp);
        }
    }
    // main header
    std::vector<u8> cs;
    put16(cs, M_SOC);
    put16(cs, M_SIZ);
    put16(cs, 38 + 3 * nc);
    put16(cs, 0);
    put32(cs, w);
    put32(cs, h);
    put32(cs, 0);
    put32(cs, 0);
    put32(cs, w);
    put32(cs, h);
    put32(cs, 0);
    put32(cs, 0);
    put16(cs, nc);
    for (u32 c = 0; c < nc; c++) {
        cs.push_back(7);
        cs.push_back(1);
        cs.push_back(1);
    }
    put16(cs, M_COD);
    put16(cs, 12);
    cs.push_back(0);                 // Scod
    cs.push_back(0);                 // LRCP
    put16(cs, 1);                    // one layer
    cs.push_back(0);                 // no MCT
    cs.push_back(ENC_LEVELS);
    cs.push_back(ENC_CBLK - 2);
    cs.push_back(ENC_CBLK - 2);
    cs.push_back(0);                 // code-block style
    cs.push_back(1);                 // 5/3
    const u32 nbands = 3 * numres - 2;
    put16(cs, M_QCD);
    put16(cs, 3 + nbands);
    cs.push_back(2 << 5);            // 2 guard bits, no quantisation
    std::vector<i32> expn(nbands);
    for (u32 b = 0; b < nbands; b++) {
        u32 orient = b == 0 ? 0 : (b - 1) % 3 + 1;
        u32 gain = orient == 0 ? 0 : (orient == 3 ? 2 : 1);
        expn[b] = (i32)(8 + gain);
        cs.push_back((u8)(expn[b] << 3));
    }
    put16(cs, M_COM);
    put16(cs, (u32)(4 + strlen(kComment)));
    put16(cs, 1);                    // Latin-1 text
    cs.insert(cs.end(), kComment, kComment + strlen(kComment));
    // the bands (LRCP order: resolution, component, band), their
    // code-blocks coded in parallel
    std::vector<EBand> bands;
    for (u32 r = 0; r < numres; r++) {
        u32 lev = numres - 1 - r;
        for (u32 c = 0; c < nc; c++)
            for (u32 b = 0; b < (r == 0 ? 1u : 3u); b++) {
                EBand e;
                e.bandno = r == 0 ? 0 : b + 1;
                e.comp = c;
                e.level = lev;
                i32 bx1, by1;
                if (r == 0) {
                    e.x0 = 0;
                    e.y0 = 0;
                    bx1 = ceildivpow2((i32)w, lev);
                    by1 = ceildivpow2((i32)h, lev);
                } else {
                    i64 xob = e.bandno & 1, yob = e.bandno >> 1;
                    e.x0 = ceildivpow2_64(0 - (xob << lev), lev + 1);
                    e.y0 = ceildivpow2_64(0 - (yob << lev), lev + 1);
                    bx1 = ceildivpow2_64((i64)w - (xob << lev), lev + 1);
                    by1 = ceildivpow2_64((i64)h - (yob << lev), lev + 1);
                }
                e.empty = bx1 - e.x0 == 0 || by1 - e.y0 == 0;
                e.numbps = expn[r == 0 ? 0 : 3 * (r - 1) + b + 1] + 2 - 1;
                e.offx = (e.bandno & 1) ? (i32)rw[r - 1] : 0;
                e.offy = (e.bandno & 2) ? (i32)rh[r - 1] : 0;
                // code-blocks (the one precinct covers the band)
                i32 tbx = floordivpow2(e.x0, ENC_CBLK) << ENC_CBLK;
                i32 tby = floordivpow2(e.y0, ENC_CBLK) << ENC_CBLK;
                i32 bbx = ceildivpow2(bx1, ENC_CBLK) << ENC_CBLK;
                i32 bby = ceildivpow2(by1, ENC_CBLK) << ENC_CBLK;
                e.cw = (u32)((bbx - tbx) >> ENC_CBLK);
                e.ch = (u32)((bby - tby) >> ENC_CBLK);
                if (!e.empty) {
                    e.cbs.resize(e.cw * e.ch);
                    for (u32 k = 0; k < e.cw * e.ch; k++) {
                        ECB& cb = e.cbs[k];
                        cb.x0 = std::max(tbx + (i32)(k % e.cw) * (1 << ENC_CBLK), e.x0);
                        cb.y0 = std::max(tby + (i32)(k / e.cw) * (1 << ENC_CBLK), e.y0);
                        cb.x1 = std::min(tbx + (i32)(k % e.cw + 1) * (1 << ENC_CBLK), bx1);
                        cb.y1 = std::min(tby + (i32)(k / e.cw + 1) * (1 << ENC_CBLK), by1);
                    }
                }
                bands.push_back(std::move(e));
            }
    }
    std::vector<std::pair<u32, u32>> jobs;
    for (u32 i = 0; i < bands.size(); i++)
        for (u32 k = 0; k < bands[i].cbs.size(); k++) jobs.push_back({i, k});
    parallel_for(jobs.size(), [&](size_t j) {
        EBand& e = bands[jobs[j].first];
        ECB& cb = e.cbs[jobs[j].second];
        const i32* d = planes[e.comp].data();
        int cw = cb.x1 - cb.x0, ch = cb.y1 - cb.y0;
        std::vector<i32> coef((size_t)cw * ch);
        for (int y = 0; y < ch; y++)
            for (int x = 0; x < cw; x++)
                coef[(size_t)y * cw + x] =
                    d[(size_t)(e.offy + cb.y0 - e.y0 + y) * w + (e.offx + cb.x0 - e.x0 + x)];
        cb.numbps = t1_encode(coef.data(), cw, ch, e.bandno, e.level, cb.data, cb.passes);
    });
    // the layer: cv2's rate 1000.f / x1000 (1 and below: every pass);
    // OpenJPEG's budget (opj_j2k_update_rates) is the image's bytes over
    // the rate, less every byte written before the tile, at least 30
    x1000 = x1000 < 1 ? 1 : (x1000 > 1000 ? 1000 : x1000);
    const float rate = 1000.f / (float)x1000;
    if (rate <= 1.0f) {
        make_layer(bands, -1.0);
    } else {
        float budget = (float)(((double)(nc * 8) * w * h) / (rate * 8.0f)) - 0.0f;
        budget -= (float)(JP2_HEAD + cs.size());
        if (budget < 30.0f) budget = 30.0f;
        rate_allocate(bands, numres, nc, (u32)std::ceil((double)budget));
    }
    std::vector<u8> tile;
    write_packets(bands, numres, nc, &tile);
    put16(cs, M_SOT);
    put16(cs, 10);
    put16(cs, 0);
    put32(cs, (u32)(12 + 2 + tile.size()));
    cs.push_back(0);
    cs.push_back(1);
    put16(cs, M_SOD);
    cs.insert(cs.end(), tile.begin(), tile.end());
    put16(cs, M_EOC);
    // the JP2 boxes
    file.clear();
    put32(file, 12);
    file.insert(file.end(), {'j', 'P', ' ', ' ', 0x0D, 0x0A, 0x87, 0x0A});
    put32(file, 20);
    file.insert(file.end(),
                {'f', 't', 'y', 'p', 'j', 'p', '2', ' ', 0, 0, 0, 0, 'j', 'p', '2', ' '});
    put32(file, 8 + 22 + 15);
    file.insert(file.end(), {'j', 'p', '2', 'h'});
    put32(file, 22);
    file.insert(file.end(), {'i', 'h', 'd', 'r'});
    put32(file, h);
    put32(file, w);
    put16(file, nc);
    file.insert(file.end(), {7, 7, 0, 0});
    put32(file, 15);
    file.insert(file.end(), {'c', 'o', 'l', 'r', 1, 0, 0});
    put32(file, 16);                 // sRGB
    put32(file, (u32)(8 + cs.size()));
    file.insert(file.end(), {'j', 'p', '2', 'c'});
    file.insert(file.end(), cs.begin(), cs.end());
}

}  // namespace

extern "C" {

// Decodes a codestream.  Returns a handle, or null with the reason in err.
// ihdr_w / ihdr_h: the JP2 ihdr box's size (0 for a raw codestream).
void* j2k_decode(const u8* data, long long len, unsigned ihdr_w, unsigned ihdr_h,
                 char* err, int errlen) {
    Decoder* d = new Decoder();
    d->buf = data;
    d->len = (size_t)len;
    d->ihdr_w = ihdr_w;
    d->ihdr_h = ihdr_h;
    try {
        d->decode_all();
    } catch (const Fail& f) {
        snprintf(err, errlen, "%s", f.msg.c_str());
        delete d;
        return nullptr;
    } catch (const std::bad_alloc&) {
        snprintf(err, errlen, "out of memory");
        delete d;
        return nullptr;
    }
    return d;
}

// Header only (SIZ), what cv2's readHeader sees: returns 1, or 0 with err.
// info: x0, y0, x1, y1, numcomps; comp: prec, sgnd, dx, dy per component
// (at most maxcomps)
int j2k_header(const u8* data, long long len, unsigned ihdr_w, unsigned ihdr_h,
               long long* info, long long* comp, int maxcomps, char* err, int errlen) {
    Decoder d;
    d.buf = data;
    d.len = (size_t)len;
    d.ihdr_w = ihdr_w;
    d.ihdr_h = ihdr_h;
    try {
        d.read_main_header();
    } catch (const Fail& f) {
        snprintf(err, errlen, "%s", f.msg.c_str());
        return 0;
    }
    info[0] = (u32)d.x0;
    info[1] = (u32)d.y0;
    info[2] = (u32)d.x1;
    info[3] = (u32)d.y1;
    info[4] = d.numcomps;
    for (u32 c = 0; c < d.numcomps && (int)c < maxcomps; c++) {
        comp[4 * c] = d.comps[c].prec;
        comp[4 * c + 1] = d.comps[c].sgnd;
        comp[4 * c + 2] = d.comps[c].dx;
        comp[4 * c + 3] = d.comps[c].dy;
    }
    return 1;
}

// per component: x0, y0, w, h, dx, dy
void j2k_comp_info(void* h, int c, long long* out) {
    Decoder* d = static_cast<Decoder*>(h);
    const Comp& k = d->comps[c];
    out[0] = k.x0;
    out[1] = k.y0;
    out[2] = k.w;
    out[3] = k.h;
    out[4] = k.dx;
    out[5] = k.dy;
}

void j2k_comp_data(void* h, int c, int32_t* out) {
    Decoder* d = static_cast<Decoder*>(h);
    const Comp& k = d->comps[c];
    memcpy(out, k.data.data(), k.data.size() * sizeof(int32_t));
}

void j2k_free(void* h) { delete static_cast<Decoder*>(h); }

// cv2's JP2 file for an (h, w, 3) uint8 RGB image at
// IMWRITE_JPEG2000_COMPRESSION_X1000 = x1000 (1000 lossless, cv2's default
// 250).  Returns the file's length, or minus it when it does not fit cap
// (call again with a buffer that large).
long long j2k_encode(const uint8_t* px, int w, int h, int x1000, uint8_t* out, long long cap) {
    std::vector<u8> file;
    encode_jp2(px, (u32)w, (u32)h, x1000, file);
    if ((long long)file.size() > cap) return -(long long)file.size();
    memcpy(out, file.data(), file.size());
    return (long long)file.size();
}

}  // extern "C"
