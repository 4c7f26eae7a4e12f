// JPEG decoder and encoder (ctypes ABI), integer for integer the default
// paths of libjpeg-turbo, the library behind cv2.imread / cv2.imwrite.
//
// Decoder (jpeg_info, jpeg_decode): baseline, extended sequential and
// progressive Huffman frames (SOF0, SOF1, SOF2), 8-bit samples, 1 or 3
// components, integral sampling factors; restart markers, 0xFF00 stuffing,
// fill bytes.  It follows jdhuff.c / jdphuff.c (entropy decoding),
// jidctint.c (JDCT_ISLOW inverse DCT and its range limit), jdsample.c
// (fancy upsampling: h2v1, h1v2, h2v2 triangle filters, box filters
// elsewhere), jdcolor.c (fixed-point YCbCr -> RGB) and jdapimin.c (JFIF vs
// Adobe APP14 transform for 3 components).  A grayscale file comes out as
// three equal channels, as IMREAD_COLOR gives it.  jpeg_info also reports
// the EXIF orientation tag (as OpenCV's ExifReader reads it from the first
// APP1 segment); the caller applies it.
//
// Encoder (jpeg_encode): what cv2.imwrite(name.jpg, img) writes with its
// defaults: the IJG tables scaled to quality 95 with force_baseline,
// 4:2:0 sampling (jcsample.c h2v2_downsample, right and bottom edges
// replicated), jccolor.c RGB -> YCbCr, jfdctint.c forward DCT, jcdctmgr.c
// reciprocal quantizer, the standard Huffman tables (jstdhuff.c) and a
// JFIF 1.01 APP0 header, no restart markers.
//
// Not supported (each raises): arithmetic coding, lossless and
// hierarchical frames, 12-bit samples, 2 or 4 components (CMYK, YCCK), a
// progressive file that stops before every coefficient is complete, and
// truncated or malformed data.  Built at first use with the system C++
// compiler (ops/cuda_build.load_host_library) and loaded by
// utils/image_io.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

using u8 = uint8_t;

struct Error : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw Error(msg); }

// zigzag index -> natural (row-major) index (jutils.c jpeg_natural_order)
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------- Huffman

struct HuffTable {
    bool present = false;
    u8 bits[17] = {};       // bits[l]: number of codes of length l
    u8 vals[256] = {};
    int nvals = 0;
    // decoding (jdhuff.c jpeg_make_d_derived_tbl)
    int32_t maxcode[18] = {};
    int valoffset[17] = {};
    // 9-bit lookahead: (length << 8) | value, 0 when longer than 9 bits
    uint16_t look[512] = {};
    // encoding: code and length of each symbol
    uint32_t ehufco[256] = {};
    u8 ehufsi[256] = {};

    void derive() {
        int huffsize[257], huffcode[257];
        int p = 0;
        for (int l = 1; l <= 16; l++)
            for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
        huffsize[p] = 0;
        int numsymbols = p;
        int code = 0, si = huffsize[0];
        p = 0;
        while (huffsize[p]) {
            while (huffsize[p] == si) huffcode[p++] = code++;
            if (code >= (1 << si)) fail("bad Huffman table");
            code <<= 1;
            si++;
        }
        p = 0;
        for (int l = 1; l <= 16; l++) {
            if (bits[l]) {
                valoffset[l] = p - huffcode[p];
                p += bits[l];
                maxcode[l] = huffcode[p - 1];
            } else {
                maxcode[l] = -1;
            }
        }
        maxcode[17] = 0x7FFFFFFF;
        std::memset(look, 0, sizeof(look));
        p = 0;
        for (int l = 1; l <= 9; l++)
            for (int i = 0; i < bits[l]; i++, p++) {
                int lookbits = huffcode[p] << (9 - l);
                for (int ctr = 1 << (9 - l); ctr > 0; ctr--)
                    look[lookbits++] = uint16_t((l << 8) | vals[p]);
            }
        std::memset(ehufsi, 0, sizeof(ehufsi));
        for (p = 0; p < numsymbols; p++) {
            ehufco[vals[p]] = uint32_t(huffcode[p]);
            ehufsi[vals[p]] = u8(huffsize[p]);
        }
    }
};

// ---------------------------------------------------------- entropy input

struct BitReader {
    const u8* data;
    size_t size;
    size_t pos;          // next byte to read
    uint64_t acc = 0;    // bits, most significant first, in the low nbits
    int nbits = 0;
    int fake = 0;        // zero bits appended past a marker or the end
    bool stopped = false;

    BitReader(const u8* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

    void fill() {
        while (nbits <= 56) {
            int c = 0;
            if (!stopped) {
                if (pos >= size) {
                    stopped = true;
                } else if (data[pos] != 0xFF) {
                    c = data[pos++];
                } else {
                    size_t q = pos + 1;
                    while (q < size && data[q] == 0xFF) q++;  // fill bytes
                    if (q < size && data[q] == 0x00) {
                        c = 0xFF;
                        pos = q + 1;
                    } else {
                        stopped = true;   // a marker: pos stays on its 0xFF
                    }
                }
            }
            if (stopped) fake += 8;
            acc = (acc << 8) | uint64_t(c);
            nbits += 8;
        }
    }
    void check() const {
        if (nbits < fake)
            fail("truncated or corrupt entropy-coded data");
    }
    int peek(int n) {
        if (nbits < n) fill();
        return int((acc >> (nbits - n)) & ((1u << n) - 1));
    }
    void skip(int n) {
        nbits -= n;
        check();
    }
    int get(int n) {
        if (n == 0) return 0;
        int v = peek(n);
        skip(n);
        return v;
    }
    int bit() { return get(1); }
    int decode(const HuffTable& t) {
        int look = peek(9);
        int e = t.look[look];
        if (e) {
            skip(e >> 8);
            return e & 0xFF;
        }
        int l = 10;
        int code = peek(l);
        while (code > t.maxcode[l]) {
            if (++l > 16) fail("corrupt Huffman code");
            code = peek(l);
        }
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    // Drop the buffered bits before a restart marker or at a scan's end.
    void reset() {
        acc = 0;
        nbits = 0;
        fake = 0;
        stopped = false;
    }
};

// HUFF_EXTEND
inline int extend(int r, int s) {
    return s == 0 ? 0 : (r < (1 << (s - 1)) ? r - (1 << s) + 1 : r);
}

// ----------------------------------------------------------------- frames

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dc_tbl = 0, ac_tbl = 0;
    int wib = 0, hib = 0;      // width / height in blocks (jdinput.c)
    int bw = 0, bh = 0;        // blocks allocated: whole MCUs
    int dw = 0, dh = 0;        // downsampled width / height
    bool latched = false;      // quant table latched at its first scan
    uint16_t quant[64] = {};   // natural order
    std::vector<int16_t> coef; // bw * bh blocks of 64, natural order
    int coef_bits[64];         // progressive: current Al, -1 = not yet seen
    int16_t* block(int bx, int by) {
        return coef.data() + (size_t(by) * bw + bx) * 64;
    }
};

struct Decoder {
    const u8* data;
    size_t size;
    size_t pos = 0;
    HuffTable dc[4], ac[4];
    uint16_t qt[4][64] = {};
    bool qt_present[4] = {};
    int restart_interval = 0;
    bool progressive = false;
    bool have_frame = false;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;
    int orientation = 1;
    bool saw_app1 = false;
    int width = 0, height = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    std::vector<Component> comps;
    bool eoi = false;

    Decoder(const u8* d, size_t n) : data(d), size(n) {}

    int u16(size_t p) const {
        if (p + 2 > size) fail("truncated file");
        return (data[p] << 8) | data[p + 1];
    }

    // next marker code: garbage before 0xFF and fill bytes skipped, as
    // jdmarker.c next_marker does
    int next_marker() {
        for (;;) {
            while (pos < size && data[pos] != 0xFF) pos++;
            while (pos < size && data[pos] == 0xFF) pos++;
            if (pos >= size) fail("truncated file (no EOI marker)");
            int c = data[pos++];
            if (c != 0) return c;
        }
    }

    // ---- marker segments
    void read_dqt(size_t p, size_t end) {
        while (p < end) {
            int pq = data[p] >> 4, tq = data[p] & 15;
            p++;
            if (tq > 3 || pq > 1) fail("bad DQT segment");
            if (p + size_t(64 * (pq + 1)) > end) fail("bad DQT length");
            for (int i = 0; i < 64; i++) {
                int v = pq ? (data[p] << 8) | data[p + 1] : data[p];
                p += pq + 1;
                qt[tq][kNatural[i]] = uint16_t(v);
            }
            qt_present[tq] = true;
        }
    }

    void read_dht(size_t p, size_t end) {
        while (p < end) {
            int tc = data[p] >> 4, th = data[p] & 15;
            p++;
            if (tc > 1 || th > 3) fail("bad DHT segment");
            if (p + 16 > end) fail("bad DHT length");
            HuffTable& t = tc ? ac[th] : dc[th];
            t.bits[0] = 0;
            int count = 0;
            for (int l = 1; l <= 16; l++) {
                t.bits[l] = data[p++];
                count += t.bits[l];
            }
            if (count > 256 || p + size_t(count) > end)
                fail("bad DHT length");
            std::memset(t.vals, 0, sizeof(t.vals));
            for (int i = 0; i < count; i++) t.vals[i] = data[p++];
            t.nvals = count;
            t.derive();
            t.present = true;
        }
    }

    void read_app(int marker, size_t p, size_t len) {
        const u8* d = data + p;
        if (marker == 0xE0 && len >= 14 && std::memcmp(d, "JFIF\0", 5) == 0)
            saw_jfif = true;
        if (marker == 0xEE && len >= 12 && std::memcmp(d, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = d[11];
        }
        if (marker == 0xE1 && !saw_app1) {   // the first APP1 only
            saw_app1 = true;
            if (len > 6) orientation = exif_orientation(d + 6, len - 6);
        }
    }

    // OpenCV's ExifReader: a TIFF header, IFD0, tag 0x0112 (SHORT)
    static int exif_orientation(const u8* t, size_t n) {
        if (n < 8) return 1;
        bool le;
        if (t[0] == 'I' && t[1] == 'I') le = true;
        else if (t[0] == 'M' && t[1] == 'M') le = false;
        else return 1;
        auto r16 = [&](size_t o) -> int {
            return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
        };
        auto r32 = [&](size_t o) -> uint32_t {
            return le ? uint32_t(t[o]) | (uint32_t(t[o + 1]) << 8) |
                            (uint32_t(t[o + 2]) << 16) |
                            (uint32_t(t[o + 3]) << 24)
                      : (uint32_t(t[o]) << 24) | (uint32_t(t[o + 1]) << 16) |
                            (uint32_t(t[o + 2]) << 8) | uint32_t(t[o + 3]);
        };
        size_t ifd = r32(4);
        if (ifd + 2 > n) return 1;
        int count = r16(ifd);
        for (int i = 0; i < count; i++) {
            size_t e = ifd + 2 + size_t(i) * 12;
            if (e + 12 > n) return 1;
            if (r16(e) == 0x0112) {
                int v = r16(e + 8);
                return (v >= 1 && v <= 8) ? v : 1;
            }
        }
        return 1;
    }

    void read_sof(int marker, size_t p, size_t len) {
        if (have_frame) fail("more than one frame");
        if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB ||
            marker == 0xCF)
            fail("lossless JPEG is not supported");
        if (marker >= 0xC9) fail("arithmetic-coded JPEG is not supported");
        if (marker == 0xC5 || marker == 0xC6)
            fail("hierarchical JPEG is not supported");
        progressive = marker == 0xC2;
        if (len < 6) fail("bad SOF segment");
        int precision = data[p];
        if (precision != 8)
            fail(std::to_string(precision) +
                 "-bit JPEG samples are not supported");
        height = u16(p + 1);
        width = u16(p + 3);
        int nc = data[p + 5];
        if (height <= 0 || width <= 0) fail("bad image size in SOF");
        if (nc == 4) fail("CMYK/YCCK JPEG is not supported");
        if (nc != 1 && nc != 3)
            fail(std::to_string(nc) + "-component JPEG is not supported");
        if (len != size_t(6 + 3 * nc)) fail("bad SOF length");
        comps.resize(nc);
        for (int i = 0; i < nc; i++) {
            Component& c = comps[i];
            c.id = data[p + 6 + 3 * i];
            c.h = data[p + 7 + 3 * i] >> 4;
            c.v = data[p + 7 + 3 * i] & 15;
            c.tq = data[p + 8 + 3 * i];
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail("bad sampling factor or table in SOF");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (Component& c : comps) {
            if (hmax % c.h || vmax % c.v)
                fail("sampling factors that are not integral ratios are "
                     "not supported");
            c.wib = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
            c.hib = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
            c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
            c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
            c.bw = mcux * c.h;
            c.bh = mcuy * c.v;
            for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
        }
        have_frame = true;
    }

    // Walk the markers up to the first SOS (returns true) or EOI.
    bool read_headers() {
        for (;;) {
            int m = next_marker();
            if (m == 0xD8) continue;                 // SOI
            if (m == 0xD9) { eoi = true; return false; }
            if (m >= 0xD0 && m <= 0xD7) continue;    // stray RSTn
            if (m == 0x01) continue;                 // TEM
            size_t len = size_t(u16(pos));
            if (len < 2 || pos + len > size) fail("truncated marker segment");
            size_t p = pos + 2, body = len - 2;
            if (m == 0xDA) return true;              // pos on the length
            pos += len;
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                m != 0xCC)
                read_sof(m, p, body);
            else if (m == 0xC4) read_dht(p, p + body);
            else if (m == 0xCC) fail("arithmetic-coded JPEG is not supported");
            else if (m == 0xDB) read_dqt(p, p + body);
            else if (m == 0xDD) {
                if (body < 2) fail("bad DRI segment");
                restart_interval = u16(p);
            } else if (m == 0xDC) {
                fail("DNL marker is not supported");
            } else if (m >= 0xE0 && m <= 0xEF) {
                read_app(m, p, body);
            }
        }
    }

    // ---- one scan (pos on the SOS length)
    void read_scan() {
        if (!have_frame) fail("SOS before SOF");
        size_t len = size_t(u16(pos));
        size_t p = pos + 2;
        int ns = data[p];
        if (ns < 1 || ns > 4 || len != size_t(6 + 2 * ns))
            fail("bad SOS segment");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; i++) {
            int id = data[p + 1 + 2 * i], tbl = data[p + 2 + 2 * i];
            Component* c = nullptr;
            for (Component& k : comps)
                if (k.id == id) c = &k;
            if (!c) fail("SOS names an unknown component");
            c->dc_tbl = tbl >> 4;
            c->ac_tbl = tbl & 15;
            if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("bad SOS table");
            sc.push_back(c);
        }
        int Ss = data[p + 1 + 2 * ns], Se = data[p + 2 + 2 * ns];
        int Ah = data[p + 3 + 2 * ns] >> 4, Al = data[p + 3 + 2 * ns] & 15;
        pos += len;
        if (progressive) {
            bool bad = Ss > Se || Se > 63 || Al > 13 || (Ah && Ah != Al + 1);
            if (Ss == 0 ? Se != 0 : ns != 1) bad = true;
            if (bad) fail("bad progressive scan parameters");
        } else if (Ss != 0 || Se != 63 || Ah != 0 || Al != 0) {
            fail("bad sequential scan parameters");
        }
        for (Component* c : sc) {
            if (!c->latched) {                    // jdinput.c latch_quant_tables
                if (!qt_present[c->tq]) fail("missing quantization table");
                std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
                c->latched = true;
            }
            if (c->coef.empty()) c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
            bool need_dc = !progressive || (Ss == 0 && Ah == 0);
            bool need_ac = !progressive || Ss > 0;
            if (need_dc && !dc[c->dc_tbl].present)
                fail("missing DC Huffman table");
            if (need_ac && !ac[c->ac_tbl].present)
                fail("missing AC Huffman table");
            if (progressive) {   // jdphuff.c start_pass_phuff_decoder
                if (Ss > 0 && c->coef_bits[0] < 0)
                    fail("bad progression sequence (AC before DC)");
                for (int k = Ss; k <= Se; k++) {
                    int expected = c->coef_bits[k] < 0 ? 0 : c->coef_bits[k];
                    if (Ah != expected) fail("bad progression sequence");
                    c->coef_bits[k] = Al;
                }
            }
        }

        int mx, my;
        if (ns == 1) { mx = sc[0]->wib; my = sc[0]->hib; }
        else { mx = mcux; my = mcuy; }
        BitReader br(data, size, pos);
        int pred[4] = {0, 0, 0, 0};
        int eobrun = 0, next_rst = 0;
        long long m = 0;
        for (int y = 0; y < my; y++)
            for (int x = 0; x < mx; x++, m++) {
                if (restart_interval && m > 0 && m % restart_interval == 0) {
                    restart(br, next_rst);
                    next_rst = (next_rst + 1) & 7;
                    std::fill(pred, pred + 4, 0);
                    eobrun = 0;
                }
                for (int ci = 0; ci < ns; ci++) {
                    Component* c = sc[ci];
                    if (ns == 1) {
                        decode_block(br, *c, c->block(x, y), pred[ci], eobrun,
                                     Ss, Se, Ah, Al);
                        continue;
                    }
                    for (int by = 0; by < c->v; by++)
                        for (int bx = 0; bx < c->h; bx++)
                            decode_block(br, *c,
                                         c->block(x * c->h + bx, y * c->v + by),
                                         pred[ci], eobrun, Ss, Se, Ah, Al);
                }
            }
        pos = br.pos;      // the scan ends at the next marker
    }

    void restart(BitReader& br, int expected) {
        size_t q = br.pos;
        while (q < size && data[q] != 0xFF) q++;
        while (q < size && data[q] == 0xFF) q++;
        if (q >= size) fail("truncated file (missing restart marker)");
        if (data[q] != 0xD0 + expected) fail("missing or out-of-order restart marker");
        br.pos = q + 1;
        br.reset();
    }

    void decode_block(BitReader& br, Component& c, int16_t* blk, int& pred,
                      int& eobrun, int Ss, int Se, int Ah, int Al) {
        if (!progressive) {                        // jdhuff.c decode_mcu
            int s = br.decode(dc[c.dc_tbl]);
            if (s > 15) fail("corrupt DC coefficient");
            int r = br.get(s);
            pred += extend(r, s);
            blk[0] = int16_t(pred);
            const HuffTable& t = ac[c.ac_tbl];
            for (int k = 1; k < 64; k++) {
                int rs = br.decode(t);
                r = rs >> 4;
                s = rs & 15;
                if (s) {
                    k += r;
                    if (k > 63) fail("corrupt AC coefficient run");
                    r = br.get(s);
                    blk[kNatural[k]] = int16_t(extend(r, s));
                } else {
                    if (r != 15) break;
                    k += 15;
                }
            }
            return;
        }
        if (Ss == 0) {                             // jdphuff.c DC scans
            if (Ah == 0) {
                int s = br.decode(dc[c.dc_tbl]);
                if (s > 15) fail("corrupt DC coefficient");
                int r = br.get(s);
                pred += extend(r, s);
                blk[0] = int16_t(int(unsigned(pred) << Al));
            } else if (br.bit()) {
                blk[0] = int16_t(blk[0] | (1 << Al));
            }
            return;
        }
        const HuffTable& t = ac[c.ac_tbl];
        if (Ah == 0) {                             // AC first
            if (eobrun > 0) { eobrun--; return; }
            for (int k = Ss; k <= Se; k++) {
                int rs = br.decode(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    k += r;
                    if (k > Se) fail("corrupt AC coefficient run");
                    r = br.get(s);
                    blk[kNatural[k]] = int16_t(int(unsigned(extend(r, s)) << Al));
                } else if (r == 15) {
                    k += 15;
                } else {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    eobrun--;
                    break;
                }
            }
            return;
        }
        // AC refinement (jdphuff.c decode_mcu_AC_refine)
        int p1 = 1 << Al, m1 = -(1 << Al);
        int k = Ss;
        if (eobrun == 0) {
            for (; k <= Se; k++) {
                int rs = br.decode(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    if (s != 1) fail("corrupt AC refinement");
                    s = br.bit() ? p1 : m1;
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += br.get(r);
                    break;
                }
                do {
                    int16_t* co = blk + kNatural[k];
                    if (*co != 0) {
                        if (br.bit() && (*co & p1) == 0)
                            *co = int16_t(*co >= 0 ? *co + p1 : *co + m1);
                    } else {
                        if (--r < 0) break;
                    }
                    k++;
                } while (k <= Se);
                if (s) {
                    if (k > Se) fail("corrupt AC refinement");
                    blk[kNatural[k]] = int16_t(s);
                }
            }
        }
        if (eobrun > 0) {
            for (; k <= Se; k++) {
                int16_t* co = blk + kNatural[k];
                if (*co != 0 && br.bit() && (*co & p1) == 0)
                    *co = int16_t(*co >= 0 ? *co + p1 : *co + m1);
            }
            eobrun--;
        }
    }

    // Every scan up to EOI; then the checks that all coefficients came.
    void read_all() {
        if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
            fail("not a JPEG file (no SOI marker)");
        pos = 2;
        int scans = 0;
        for (;;) {
            bool sos;
            try {
                sos = read_headers();
            } catch (const Error&) {
                // a file that ends after its last scan without EOI decodes,
                // as libjpeg's source manager supplies a fake EOI there
                if (scans == 0 || pos < size) throw;
                break;
            }
            if (!sos) break;
            read_scan();
            scans++;
        }
        if (!have_frame) fail("no SOF marker");
        for (Component& c : comps) {
            if (c.coef.empty())
                fail("a component is missing from the scans (truncated)");
            if (progressive)
                for (int k = 0; k < 64; k++)
                    if (c.coef_bits[k] != 0)
                        fail("incomplete progressive JPEG (the file stops "
                             "before all of its scans)");
        }
    }
};

// ------------------------------------------------- inverse DCT (jidctint.c)

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
    return (x + (int64_t(1) << (n - 1))) >> n;
}

// jdmaster.c prepare_range_limit_table, the post-IDCT part: index
// (x & 1023) for an IDCT output x before the +128 level shift
struct IdctLimit {
    u8 t[1024];
    IdctLimit() {
        for (int i = 0; i < 1024; i++) {
            if (i < 128) t[i] = u8(i + 128);
            else if (i < 512) t[i] = 255;
            else if (i < 896) t[i] = 0;
            else t[i] = u8(i - 896);
        }
    }
};
const IdctLimit kIdctLimit;

void idct_islow(const int16_t* in, const uint16_t* q, u8* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {                 // pass 1: columns
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
            !ip[56]) {
            int dc = int(ip[0] * int(qp[0])) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = int64_t(ip[0]) * qp[0];
        z3 = int64_t(ip[32]) * qp[32];
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = int64_t(ip[56]) * qp[56];
        tmp1 = int64_t(ip[40]) * qp[40];
        tmp2 = int64_t(ip[24]) * qp[24];
        tmp3 = int64_t(ip[8]) * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS - PASS1_BITS;
        wp[0] = int(descale(tmp10 + tmp3, n));
        wp[56] = int(descale(tmp10 - tmp3, n));
        wp[8] = int(descale(tmp11 + tmp2, n));
        wp[48] = int(descale(tmp11 - tmp2, n));
        wp[16] = int(descale(tmp12 + tmp1, n));
        wp[40] = int(descale(tmp12 - tmp1, n));
        wp[24] = int(descale(tmp13 + tmp0, n));
        wp[32] = int(descale(tmp13 - tmp0, n));
    }
    const u8* lim = kIdctLimit.t;
    for (int r = 0; r < 8; r++) {                 // pass 2: rows
        const int* wp = ws + 8 * r;
        u8* op = out + size_t(r) * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
            !wp[7]) {
            u8 dc = lim[int(descale(wp[0], PASS1_BITS + 3)) & 1023];
            for (int c = 0; c < 8; c++) op[c] = dc;
            continue;
        }
        int64_t z2 = wp[2], z3 = wp[6];
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * (1 << CONST_BITS);
        int64_t tmp1 = (int64_t(wp[0]) - wp[4]) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = wp[7];
        tmp1 = wp[5];
        tmp2 = wp[3];
        tmp3 = wp[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int64_t z4 = tmp1 + tmp3;
        int64_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = lim[int(descale(tmp10 + tmp3, n)) & 1023];
        op[7] = lim[int(descale(tmp10 - tmp3, n)) & 1023];
        op[1] = lim[int(descale(tmp11 + tmp2, n)) & 1023];
        op[6] = lim[int(descale(tmp11 - tmp2, n)) & 1023];
        op[2] = lim[int(descale(tmp12 + tmp1, n)) & 1023];
        op[5] = lim[int(descale(tmp12 - tmp1, n)) & 1023];
        op[3] = lim[int(descale(tmp13 + tmp0, n)) & 1023];
        op[4] = lim[int(descale(tmp13 - tmp0, n)) & 1023];
    }
}

// ------------------------------------------- upsampling (jdsample.c)
//
// The component's own samples are rows < dh, columns < dw of `in`; the
// context row above the first and below the last repeats the edge row
// (jdmainct.c), and the triangle filters' first and last columns are the
// edge cases of jdsample.c.

void upsample(const Component& c, const u8* in, int stride, int hmax,
              int vmax, int width, int height, u8* out) {
    int rh = hmax / c.h, rv = vmax / c.v;
    int dw = c.dw, dh = c.dh;
    auto row = [&](int y) { return in + size_t(std::clamp(y, 0, dh - 1)) * stride; };
    for (int y = 0; y < height; y++) {
        u8* op = out + size_t(y) * width;
        if (rh == 1 && rv == 1) {
            std::memcpy(op, row(y), size_t(width));
        } else if (rh == 2 && rv == 1 && dw > 2) {          // h2v1 fancy
            const u8* ip = row(y);
            for (int x = 0; x < width; x++) {
                int cx = x >> 1;
                int v3 = ip[cx] * 3;
                op[x] = (x & 1) ? u8((v3 + ip[std::min(cx + 1, dw - 1)] + 2) >> 2)
                                : u8((v3 + ip[std::max(cx - 1, 0)] + 1) >> 2);
            }
        } else if (rh == 1 && rv == 2) {                    // h1v2 fancy
            int r = y >> 1;
            const u8* i0 = row(r);
            const u8* i1 = row((y & 1) ? r + 1 : r - 1);
            int bias = (y & 1) ? 2 : 1;
            for (int x = 0; x < width; x++)
                op[x] = u8((i0[x] * 3 + i1[x] + bias) >> 2);
        } else if (rh == 2 && rv == 2 && dw > 2) {          // h2v2 fancy
            int r = y >> 1;
            const u8* i0 = row(r);
            const u8* i1 = row((y & 1) ? r + 1 : r - 1);
            auto colsum = [&](int cx) {
                cx = std::clamp(cx, 0, dw - 1);
                return i0[cx] * 3 + i1[cx];
            };
            for (int x = 0; x < width; x++) {
                int cx = x >> 1;
                int t = colsum(cx) * 3;
                op[x] = (x & 1) ? u8((t + colsum(cx + 1) + 7) >> 4)
                                : u8((t + colsum(cx - 1) + 8) >> 4);
            }
        } else {                                  // box: h2v1, h2v2, int
            const u8* ip = in + size_t(y / rv) * stride;
            for (int x = 0; x < width; x++) op[x] = ip[x / rh];
        }
    }
}

// ------------------------------------------ color conversion (jdcolor.c)

struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        const int SCALEBITS = 16;
        const int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
        for (int i = 0, x = -128; i < 256; i++, x++) {
            cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
    }
};
const YccTables kYcc;

inline u8 clamp255(int v) { return u8(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// The decoded coefficients of `d` (read_all) -> (height, width, 3) RGB in
// the stored orientation.
void decode(Decoder& d, u8* rgb) {
    int W = d.width, H = d.height, nc = int(d.comps.size());
    std::vector<std::vector<u8>> full(nc);
    for (int ci = 0; ci < nc; ci++) {
        Component& c = d.comps[ci];
        int stride = c.bw * 8;
        std::vector<u8> plane(size_t(stride) * c.bh * 8);
        for (int by = 0; by < c.hib; by++)
            for (int bx = 0; bx < c.wib; bx++)
                idct_islow(c.block(bx, by), c.quant,
                           plane.data() + size_t(by) * 8 * stride + bx * 8,
                           stride);
        full[ci].resize(size_t(W) * H);
        upsample(c, plane.data(), stride, d.hmax, d.vmax, W, H,
                 full[ci].data());
    }
    size_t n = size_t(W) * H;
    if (nc == 1) {
        const u8* g = full[0].data();
        for (size_t i = 0; i < n; i++)
            rgb[3 * i] = rgb[3 * i + 1] = rgb[3 * i + 2] = g[i];
        return;
    }
    // jdapimin.c default_decompress_parms
    bool ycc;
    if (d.saw_jfif) ycc = true;
    else if (d.saw_adobe) ycc = d.adobe_transform != 0;
    else ycc = !(d.comps[0].id == 82 && d.comps[1].id == 71 &&
                 d.comps[2].id == 66);
    const u8 *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    for (size_t i = 0; i < n; i++) {
        if (!ycc) {
            rgb[3 * i] = p0[i];
            rgb[3 * i + 1] = p1[i];
            rgb[3 * i + 2] = p2[i];
            continue;
        }
        int y = p0[i], cb = p1[i], cr = p2[i];
        rgb[3 * i] = clamp255(y + kYcc.cr_r[cr]);
        rgb[3 * i + 1] =
            clamp255(y + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        rgb[3 * i + 2] = clamp255(y + kYcc.cb_b[cb]);
    }
}

// ------------------------------------------------------------------ encoder

// jcparam.c std_luminance_quant_tbl / std_chrominance_quant_tbl (natural)
const int kStdLuma[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: bits[1..16] and values
const u8 kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const u8 kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const u8 kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const u8 kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const u8 kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const u8 kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const u8 kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

HuffTable std_table(const u8* bits, const u8* vals, int n) {
    HuffTable t;
    std::memcpy(t.bits, bits, 17);
    std::memcpy(t.vals, vals, size_t(n));
    t.nvals = n;
    t.derive();
    t.present = true;
    return t;
}

// jfdctint.c jpeg_fdct_islow, in place on level-shifted samples
void fdct_islow(int* d) {
    for (int pass = 0; pass < 2; pass++) {
        const int step = pass ? 8 : 1, stride = pass ? 1 : 8;
        for (int i = 0; i < 8; i++) {
            int* p = d + i * stride;
            int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
            int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
            int64_t tmp2 = p[2 * step] + p[5 * step],
                    tmp5 = p[2 * step] - p[5 * step];
            int64_t tmp3 = p[3 * step] + p[4 * step],
                    tmp4 = p[3 * step] - p[4 * step];
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            const int n = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
            if (pass) {
                p[0] = int(descale(tmp10 + tmp11, PASS1_BITS));
                p[4 * step] = int(descale(tmp10 - tmp11, PASS1_BITS));
            } else {
                p[0] = int((tmp10 + tmp11) * (1 << PASS1_BITS));
                p[4 * step] = int((tmp10 - tmp11) * (1 << PASS1_BITS));
            }
            int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
            p[2 * step] = int(descale(z1 + tmp13 * FIX_0_765366865, n));
            p[6 * step] = int(descale(z1 + tmp12 * -FIX_1_847759065, n));
            z1 = tmp4 + tmp7;
            int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
            int64_t z5 = (z3 + z4) * FIX_1_175875602;
            tmp4 *= FIX_0_298631336;
            tmp5 *= FIX_2_053119869;
            tmp6 *= FIX_3_072711026;
            tmp7 *= FIX_1_501321110;
            z1 *= -FIX_0_899976223;
            z2 *= -FIX_2_562915447;
            z3 *= -FIX_1_961570560;
            z4 *= -FIX_0_390180644;
            z3 += z5;
            z4 += z5;
            p[7 * step] = int(descale(tmp4 + z1 + z3, n));
            p[5 * step] = int(descale(tmp5 + z2 + z4, n));
            p[3 * step] = int(descale(tmp6 + z2 + z3, n));
            p[step] = int(descale(tmp7 + z1 + z4, n));
        }
    }
}

// jcdctmgr.c compute_reciprocal / quantize with 16-bit DCT elements
struct Divisor {
    uint32_t recip, corr;
    int shift;
};

Divisor reciprocal(uint32_t divisor) {
    if (divisor == 1) return {1, 0, -16};
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
    uint32_t c = divisor / 2;
    if (fr == 0) {
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2) {
        c++;
    } else {
        fq++;
    }
    return {fq & 0xFFFF, c & 0xFFFF, r - 16};
}

inline int quantize(int v, const Divisor& q) {
    int16_t t = int16_t(v);
    bool neg = t < 0;
    uint32_t a = uint16_t(neg ? -t : t);
    uint32_t prod = (a + q.corr) * q.recip;
    int16_t out = int16_t(prod >> (q.shift + 16));
    return neg ? -out : out;
}

struct BitWriter {
    std::vector<u8>& out;
    uint64_t acc = 0;
    int n = 0;
    explicit BitWriter(std::vector<u8>& o) : out(o) {}
    void put(uint32_t code, int size) {
        if (!size) return;
        acc = (acc << size) | (code & ((1u << size) - 1));
        n += size;
        while (n >= 8) {
            u8 b = u8(acc >> (n - 8));
            out.push_back(b);
            if (b == 0xFF) out.push_back(0);
            n -= 8;
        }
    }
    void flush() {                 // pad the last byte with ones
        if (n) put(0x7F, 8 - n);
    }
};

inline int nbits_of(int v) { return v ? 32 - __builtin_clz(unsigned(v)) : 0; }

// jchuff.c encode_one_block
void encode_block(BitWriter& bw, const int* blk, int& last_dc,
                  const HuffTable& dct, const HuffTable& act) {
    int temp = blk[0] - last_dc, temp2 = temp;
    last_dc = blk[0];
    if (temp < 0) { temp = -temp; temp2--; }
    int nb = nbits_of(temp);
    if (nb > 11) fail("DCT coefficient out of range");
    bw.put(dct.ehufco[nb], dct.ehufsi[nb]);
    bw.put(uint32_t(temp2), nb);
    int r = 0;
    for (int k = 1; k < 64; k++) {
        temp = blk[kNatural[k]];
        if (temp == 0) { r++; continue; }
        while (r > 15) {
            bw.put(act.ehufco[0xF0], act.ehufsi[0xF0]);
            r -= 16;
        }
        temp2 = temp;
        if (temp < 0) { temp = -temp; temp2--; }
        nb = nbits_of(temp);
        if (nb > 10) fail("DCT coefficient out of range");
        int i = (r << 4) + nb;
        bw.put(act.ehufco[i], act.ehufsi[i]);
        bw.put(uint32_t(temp2), nb);
        r = 0;
    }
    if (r > 0) bw.put(act.ehufco[0], act.ehufsi[0]);
}

void put16(std::vector<u8>& o, int v) {
    o.push_back(u8(v >> 8));
    o.push_back(u8(v & 0xFF));
}

void emit_dht(std::vector<u8>& o, const HuffTable& t, int index) {
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 2 + 1 + 16 + t.nvals);
    o.push_back(u8(index));
    for (int l = 1; l <= 16; l++) o.push_back(t.bits[l]);
    for (int i = 0; i < t.nvals; i++) o.push_back(t.vals[i]);
}

// cv2.imwrite's default JPEG quality (IMWRITE_JPEG_QUALITY)
constexpr int kQuality = 95;

// (H, W, 3) RGB -> the bytes of a baseline 4:2:0 JFIF file
std::vector<u8> encode(const u8* rgb, int W, int H) {
    if (W <= 0 || H <= 0 || W > 65500 || H > 65500) fail("bad image size");
    // jcparam.c jpeg_quality_scaling, jpeg_add_quant_table (force_baseline)
    const int scale = kQuality < 50 ? 5000 / kQuality : 200 - kQuality * 2;
    uint16_t qtab[2][64];
    Divisor div[2][64];
    for (int i = 0; i < 64; i++)
        for (int t = 0; t < 2; t++) {
            long v = ((t ? kStdChroma : kStdLuma)[i] * long(scale) + 50) / 100;
            v = std::clamp(v, 1L, 255L);
            qtab[t][i] = uint16_t(v);
            div[t][i] = reciprocal(uint32_t(v) << 3);
        }
    const HuffTable dct[2] = {std_table(kDcLumaBits, kDcVals, 12),
                              std_table(kDcChromaBits, kDcVals, 12)};
    const HuffTable act[2] = {std_table(kAcLumaBits, kAcLumaVals, 162),
                              std_table(kAcChromaBits, kAcChromaVals, 162)};

    // jccolor.c rgb_ycc_convert
    const int64_t ONE_HALF = int64_t(1) << 15, CBCR_OFFSET = int64_t(128) << 16;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    size_t n = size_t(W) * H;
    std::vector<u8> Y(n), Cb(n), Cr(n);
    for (size_t i = 0; i < n; i++) {
        int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        Y[i] = u8((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b +
                   ONE_HALF) >> 16);
        Cb[i] = u8((-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b +
                    CBCR_OFFSET + ONE_HALF - 1) >> 16);
        Cr[i] = u8((fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b +
                    CBCR_OFFSET + ONE_HALF - 1) >> 16);
    }
    // jcsample.c h2v2_downsample over the right edge replicated to whole
    // blocks, rows past the last real one repeating it (jcprepct.c)
    const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    const int cw = mcux * 8, ch = mcuy * 8;        // chroma plane, blocks
    const int cdh = (H + 1) / 2;                   // chroma rows with data
    std::vector<u8> sub[2] = {std::vector<u8>(size_t(cw) * ch),
                              std::vector<u8>(size_t(cw) * ch)};
    for (int t = 0; t < 2; t++) {
        const u8* src = t ? Cr.data() : Cb.data();
        u8* dst = sub[t].data();
        for (int cy = 0; cy < ch; cy++) {
            int yy = std::min(cy, cdh - 1);
            const u8* r0 = src + size_t(std::min(2 * yy, H - 1)) * W;
            const u8* r1 = src + size_t(std::min(2 * yy + 1, H - 1)) * W;
            for (int cx = 0; cx < cw; cx++) {
                int x0 = std::min(2 * cx, W - 1), x1 = std::min(2 * cx + 1, W - 1);
                int bias = (cx & 1) ? 2 : 1;
                dst[size_t(cy) * cw + cx] =
                    u8((r0[x0] + r0[x1] + r1[x0] + r1[x1] + bias) >> 2);
            }
        }
    }

    std::vector<u8> out;
    out.reserve(size_t(mcux) * mcuy * 6 * 64 + 1024);
    const u8 soi_app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I',
                           'F', 0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00,
                           0x01, 0x00, 0x00};
    out.insert(out.end(), soi_app0, soi_app0 + sizeof(soi_app0));
    for (int t = 0; t < 2; t++) {                  // jcmarker.c emit_dqt
        out.push_back(0xFF);
        out.push_back(0xDB);
        put16(out, 67);
        out.push_back(u8(t));
        for (int i = 0; i < 64; i++) out.push_back(u8(qtab[t][kNatural[i]]));
    }
    const u8 sof[] = {0xFF, 0xC0, 0x00, 17, 8, u8(H >> 8), u8(H & 0xFF),
                      u8(W >> 8), u8(W & 0xFF), 3, 1, 0x22, 0, 2, 0x11, 1,
                      3, 0x11, 1};
    out.insert(out.end(), sof, sof + sizeof(sof));
    emit_dht(out, dct[0], 0x00);
    emit_dht(out, act[0], 0x10);
    emit_dht(out, dct[1], 0x01);
    emit_dht(out, act[1], 0x11);
    const u8 sos[] = {0xFF, 0xDA, 0x00, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11,
                      0, 63, 0};
    out.insert(out.end(), sos, sos + sizeof(sos));

    // jccoefct.c compress_data: luma blocks of whole MCUs; a block past the
    // image's blocks is a dummy (AC 0, DC of the block before it)
    const int wib = (W + 7) / 8, hib = (H + 7) / 8;
    auto fdct_block = [&](auto sample, const Divisor* q, int* blk) {
        int d[64];
        for (int y = 0; y < 8; y++)
            for (int x = 0; x < 8; x++) d[8 * y + x] = sample(x, y) - 128;
        fdct_islow(d);
        for (int i = 0; i < 64; i++) blk[i] = quantize(d[i], q[i]);
    };
    BitWriter bw(out);
    int last_dc[3] = {0, 0, 0};
    int mcu[6][64];
    for (int my = 0; my < mcuy; my++)
        for (int mx = 0; mx < mcux; mx++) {
            for (int yi = 0; yi < 2; yi++)
                for (int xi = 0; xi < 2; xi++) {
                    int bx = 2 * mx + xi, by = 2 * my + yi;
                    int* blk = mcu[2 * yi + xi];
                    if (by >= hib || bx >= wib) {
                        std::fill(blk, blk + 64, 0);
                        blk[0] = by >= hib ? mcu[2 * yi - 1][0]
                                           : mcu[2 * yi + xi - 1][0];
                        continue;
                    }
                    fdct_block(
                        [&](int x, int y) {
                            int sx = std::min(bx * 8 + x, W - 1);
                            int sy = std::min(by * 8 + y, H - 1);
                            return int(Y[size_t(sy) * W + sx]);
                        },
                        div[0], blk);
                }
            for (int t = 0; t < 2; t++)
                fdct_block(
                    [&](int x, int y) {
                        return int(sub[t][size_t(my * 8 + y) * cw + mx * 8 + x]);
                    },
                    div[1], mcu[4 + t]);
            for (int b = 0; b < 4; b++)
                encode_block(bw, mcu[b], last_dc[0], dct[0], act[0]);
            encode_block(bw, mcu[4], last_dc[1], dct[1], act[1]);
            encode_block(bw, mcu[5], last_dc[2], dct[1], act[1]);
        }
    bw.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
    return out;
}

void set_error(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) {
        std::strncpy(err, msg, size_t(errlen) - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

// info[0..3] = width, height, components, EXIF orientation (1-8) of the
// stored image.  Returns 0, or -1 with a message in err.
int jpeg_info(const uint8_t* buf, long long len, int* info, char* err,
              int errlen) {
    try {
        Decoder d(buf, size_t(len));
        if (len < 2 || buf[0] != 0xFF || buf[1] != 0xD8)
            fail("not a JPEG file (no SOI marker)");
        d.pos = 2;
        while (!d.have_frame) {
            if (!d.read_headers()) fail("no SOF marker");
            if (!d.have_frame) fail("SOS before SOF");
        }
        info[0] = d.width;
        info[1] = d.height;
        info[2] = int(d.comps.size());
        info[3] = d.orientation;
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return -1;
    }
}

// Decodes into rgb, (height, width, 3) of the stored image (cap bytes).
int jpeg_decode(const uint8_t* buf, long long len, uint8_t* rgb,
                long long cap, char* err, int errlen) {
    try {
        Decoder d(buf, size_t(len));
        d.read_all();
        if (cap < (long long)d.width * d.height * 3) fail("output too small");
        decode(d, rgb);
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return -1;
    }
}

// Encodes (height, width, 3) RGB; returns the byte count written to out
// (cap bytes), or -1 with a message in err (-2 - size when out is small).
long long jpeg_encode(const uint8_t* rgb, int width, int height,
                      uint8_t* out, long long cap, char* err, int errlen) {
    try {
        std::vector<u8> bytes = encode(rgb, width, height);
        if ((long long)bytes.size() > cap) return -2 - (long long)bytes.size();
        std::memcpy(out, bytes.data(), bytes.size());
        return (long long)bytes.size();
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return -1;
    }
}

}  // extern "C"
