// JPEG 2000 codec (ctypes ABI) for utils/image_io.py, which parses the JP2
// boxes itself and hands this file the codestream.
//
// Decoder: a Part-1 codestream as OpenJPEG 2.5.3 (the copy cv2 5.0.0 links)
// decodes it, in its order and with its rules for what it refuses:
//   1. the main and tile-part headers (SIZ, COD, COC, QCD, QCC, RGN, POC,
//      PPM, PPT, TLM, PLM, PLT, CRG, COM; several tile-parts a tile);
//   2. tier-2: packet headers in the five progression orders and POC, tag
//      trees, Lblock, SOP/EPH, precincts, code-word segments;
//   3. tier-1: EBCOT's three passes with the MQ decoder, every code-block
//      style (BYPASS, RESET, TERMALL, VSC, PTERM, SEGSYM);
//   4. dequantisation (OpenJPEG's mid-point values, 5/3's truncating / 2,
//      9/7's float step sizes), RGN maxshift;
//   5. the 5/3 integer and 9/7 float inverse wavelet transforms, the
//      inverse RCT and ICT, the DC level shift and OpenJPEG's rounding.
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

struct TCP {
    u32 csty = 0, numlayers = 0, mct = 0;
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
            default: {
                char b[96];
                snprintf(b, sizeof b, "a Part 2 or Part 15 marker (0x%04X)", m);
                fail(std::string("unported: ") + b);
            }
        }
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
                if (nprec > (1u << 26)) fail("unported: more than 2^26 precincts in a resolution");
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
                            fail("unported: a precinct of more than 2^24 code-blocks");
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
        if (incsize > (1ull << 31)) fail("unported: a packet iterator of more than 2^31 packets");
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
        if (cblksty & STY_HT) fail("unported: HT (Part 15) code-blocks");
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
                    do {
                        Seg& s = cb.segs[segno];
                        s.numnewpasses = (u32)std::min<i32>((i32)(s.maxpasses - s.numpasses), n);
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
            if (tw_ * th_ > (size_t)1 << 31) fail("unported: a tile-component past 2^31 samples");
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
                    for (i32 i = 0; i < w; i++) {
                        i64 v = (i64)p[i] + tccp.dc_shift;
                        p[i] = (i32)(v < lo ? lo : (v > hi ? hi : v));
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
