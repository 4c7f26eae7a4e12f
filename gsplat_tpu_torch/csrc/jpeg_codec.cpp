// JPEG decoder and encoder (ctypes ABI), integer for integer the default
// paths of libjpeg-turbo, the library behind cv2.imread / cv2.imwrite.
//
// Decoder (jpeg_info, jpeg_decode): baseline, extended sequential and
// progressive frames, Huffman (SOF0, SOF1, SOF2) or arithmetic coded
// (SOF9, SOF10, with DAC conditioning), and lossless Huffman frames (SOF3:
// predictors 1-7, point transform, 1x1 sampling); 8-bit samples, 1, 3 or 4
// components, integral sampling factors; restart markers, 0xFF00
// stuffing, fill bytes.  It follows jdhuff.c / jdphuff.c / jdarith.c /
// jdlhuff.c (entropy decoding), jddiffct.c and jdlossls.c (lossless
// prediction), jidctint.c (JDCT_ISLOW inverse DCT and its range limit),
// jdcoefct.c (block smoothing of an incomplete progressive image, the
// 5x5 version of 2.1), jdsample.c (fancy upsampling: h2v1, h1v2, h2v2
// triangle filters, box filters elsewhere), jdcolor.c (fixed-point YCbCr
// -> RGB, YCCK -> CMYK) and jdapimin.c (JFIF vs Adobe APP14 transform).
// A grayscale file comes out as three equal channels, as IMREAD_COLOR
// gives it; a 4-component one as OpenCV converts CMYK to BGR.  Data that
// ends early decodes as libjpeg decodes it: zero bits to the end of the
// MCU where the data ran out, the rest of the scan left as it was, and a
// warning.  jpeg_info also reports the EXIF orientation tag (as OpenCV's
// ExifReader reads it from the first APP1 segment); the caller applies it.
//
// Encoder (jpeg_encode): what cv2.imwrite(name.jpg, img) writes with its
// defaults: the IJG tables scaled to quality 95 with force_baseline,
// 4:2:0 sampling (jcsample.c h2v2_downsample, right and bottom edges
// replicated), jccolor.c RGB -> YCbCr, jfdctint.c forward DCT, jcdctmgr.c
// reciprocal quantizer, the standard Huffman tables (jstdhuff.c) and a
// JFIF 1.01 APP0 header, no restart markers.
//
// Not supported (each raises): hierarchical frames, 12-bit samples and 2
// components (cv2 refuses all three), lossless grayscale and lossless
// YCbCr / YCCK (libjpeg-turbo refuses to convert them to the color cv2
// asks for), arithmetic-coded lossless and subsampled lossless frames, and
// malformed data.  Built at first use with the system C++ compiler
// (ops/cuda_build.load_host_library) and loaded by utils/image_io.py.

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

// jpeg_natural_order's extra entries: a corrupt run past 63 lands on 63
inline int natural(int k) { return k < 64 ? kNatural[k] : 63; }

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

// Huffman-coded data (jdhuff.c's bit reader).  Past a marker or the end of
// the data the reader supplies zero bits; a read that needs more bits than
// the data holds sets `insufficient` (jdhuff.c jpeg_fill_bit_buffer), and
// the rest of the scan is then left undecoded, as libjpeg leaves it.
struct BitReader {
    const u8* data;
    size_t size;
    size_t pos;          // next byte to read
    uint64_t acc = 0;    // bits, most significant first, in the low nbits
    int nbits = 0;
    int fake = 0;        // zero bits appended past a marker or the end
    bool stopped = false;
    bool insufficient = false;

    BitReader(const u8* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

    void fill() {
        while (nbits <= 56) {
            int c = 0;
            if (!stopped) {
                if (pos >= size) {
                    // the fake FF D9 past the end (Decoder::at), entered
                    // at its D9 when a marker segment took the FF
                    if ((pos - size) & 1) c = 0xD9, pos++;
                    else stopped = true;
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
    int peek(int n) {
        if (nbits < n) fill();
        return int((acc >> (nbits - n)) & ((1u << n) - 1));
    }
    void skip(int n) {
        nbits -= n;
        if (nbits < fake) {       // the zeros past the data were consumed
            insufficient = true;
            fake = nbits;
        }
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
        while (l <= 16 && code > t.maxcode[l]) {
            l++;
            if (l <= 16) code = peek(l);
        }
        if (l > 16) {             // jdhuff.c: a bad code (17 bits) reads 0
            skip(17);
            return 0;
        }
        skip(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
    // Drop the buffered bits after a restart marker (the data goes on at
    // `p`) or when the marker that stops the data was not a restart one.
    void reset(size_t p, bool more_data) {
        pos = p;
        acc = 0;
        nbits = 0;
        fake = 0;
        stopped = !more_data;
    }
};

// HUFF_EXTEND
inline int extend(int r, int s) {
    return s == 0 ? 0 : (r < (1 << (s - 1)) ? r - (1 << s) + 1 : r);
}

// jaricom.c jpeg_aritab, ITU T.81 table D.2: Qe << 16 | Next_Index_MPS << 8
// | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed 0.5 bin.
const int32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// Arithmetic-coded data (jdarith.c arith_decode): the QM decoder of T.81
// section D.2; past a marker or the end of the data it reads zero bytes.
struct ArithReader {
    const u8* data;
    size_t size;
    size_t pos;
    int64_t c = 0, a = 0;
    int ct = -16;
    bool marker = false;

    ArithReader(const u8* d, size_t n, size_t p) : data(d), size(n), pos(p) {}

    int byte() {
        if (marker) return 0;
        if (pos >= size) {            // the fake FF D9 past the end
            if ((pos - size) & 1) return pos++, 0xD9;
            marker = true;
            return 0;
        }
        if (data[pos] != 0xFF) return data[pos++];
        size_t q = pos + 1;
        while (q < size && data[q] == 0xFF) q++;
        if (q < size && data[q] == 0x00) {
            pos = q + 1;
            return 0xFF;
        }
        marker = true;            // pos stays on the marker's 0xFF
        return 0;
    }
    int decode(u8* st) {
        while (a < 0x8000) {
            if (--ct < 0) {
                c = (c << 8) | byte();
                if ((ct += 8) < 0 && ++ct == 0) a = 0x8000;
            }
            a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAriTab[sv & 0x7F];
        int nl = int(qe & 0xFF), nm = int((qe >> 8) & 0xFF);
        qe >>= 16;
        int64_t temp = a - qe;
        a = temp;
        temp <<= ct;
        if (c >= temp) {
            c -= temp;
            if (a < qe) {
                a = qe;
                *st = u8((sv & 0x80) ^ nm);
            } else {
                a = qe;
                *st = u8((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (a < 0x8000) {
            if (a < qe) {
                *st = u8((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = u8((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }
    void reset(size_t p, bool more_data) {
        pos = p;
        c = a = 0;
        ct = -16;
        marker = !more_data;
    }
};

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
    std::vector<u8> samples;   // lossless: dw * dh output samples
    // progressive (zigzag index): current Al, -1 = not yet seen; and the
    // values before the component's latest scan (jdphuff.c, 2.1 and later)
    int coef_bits[64], prev_bits[64];
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
    bool progressive = false, arith = false, lossless = false;
    u8 arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];  // jdmarker.c defaults
    bool have_frame = false;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;
    int orientation = 1;
    bool saw_app1 = false;
    int width = 0, height = 0;
    int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
    std::vector<Component> comps;
    int scans = 0;
    int last_good_row = 0;     // jdcoefct.c last_good_iMCU_row
    bool hit_end = false;      // a scan's data ran out (JWRN_HIT_MARKER)
    bool premature = false;    // the file ended before its EOI

    Decoder(const u8* d, size_t n) : data(d), size(n) {
        std::fill(arith_dc_L, arith_dc_L + 16, 0);
        std::fill(arith_dc_U, arith_dc_U + 16, 1);
        std::fill(arith_ac_K, arith_ac_K + 16, 5);
    }

    // The byte at p; past the end of the data, FF D9 FF D9 ..., the fake
    // EOI markers that libjpeg's source manager supplies there
    // (jdatasrc.c fill_input_buffer), which marker segments cut short read.
    int at(size_t p) const {
        return p < size ? data[p] : ((p - size) & 1 ? 0xD9 : 0xFF);
    }
    int u16(size_t p) const { return (at(p) << 8) | at(p + 1); }

    // next marker code: garbage before 0xFF and fill bytes skipped, as
    // jdmarker.c next_marker does; at the end of the data, a fake EOI
    int next_marker() {
        for (;;) {
            while (pos < size && data[pos] != 0xFF) pos++;
            while (pos < size && data[pos] == 0xFF) pos++;
            if (pos >= size) {
                premature = true;
                return 0xD9;
            }
            int c = data[pos++];
            if (c != 0) return c;
        }
    }

    // ---- marker segments
    void read_dqt(size_t p, size_t end) {
        while (p < end) {
            int pq = at(p) >> 4, tq = at(p) & 15;
            p++;
            if (tq > 3 || pq > 1) fail("bad DQT segment");
            if (p + size_t(64 * (pq + 1)) > end) fail("bad DQT length");
            for (int i = 0; i < 64; i++) {
                int v = pq ? u16(p) : at(p);
                p += pq + 1;
                qt[tq][kNatural[i]] = uint16_t(v);
            }
            qt_present[tq] = true;
        }
    }

    void read_dht(size_t p, size_t end) {
        while (p < end) {
            int tc = at(p) >> 4, th = at(p) & 15;
            p++;
            if (tc > 1 || th > 3) fail("bad DHT segment");
            if (p + 16 > end) fail("bad DHT length");
            HuffTable& t = tc ? ac[th] : dc[th];
            t.bits[0] = 0;
            int count = 0;
            for (int l = 1; l <= 16; l++) {
                t.bits[l] = u8(at(p++));
                count += t.bits[l];
            }
            if (count > 256 || p + size_t(count) > end)
                fail("bad DHT length");
            std::memset(t.vals, 0, sizeof(t.vals));
            for (int i = 0; i < count; i++) t.vals[i] = u8(at(p++));
            t.nvals = count;
            t.derive();
            t.present = true;
        }
    }

    // jdmarker.c get_dac: arithmetic conditioning
    void read_dac(size_t p, size_t end) {
        for (; p + 1 < end; p += 2) {
            int index = at(p), val = at(p + 1);
            if (index >= 32) fail("bad DAC table index");
            if (index >= 16) {
                arith_ac_K[index - 16] = u8(val);
            } else {
                arith_dc_L[index] = u8(val & 15);
                arith_dc_U[index] = u8(val >> 4);
                if (arith_dc_L[index] > arith_dc_U[index])
                    fail("bad DAC value");
            }
        }
    }

    void read_app(int marker, size_t p, size_t len) {
        std::vector<u8> seg(len);
        for (size_t i = 0; i < len; i++) seg[i] = u8(at(p + i));
        const u8* d = seg.data();
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

    // OpenCV's ExifReader: little-endian after "II", big-endian otherwise;
    // the TIFF mark 42; IFD0's entries in order up to tag 0x0112, whose
    // value it returns (1-8; 1 otherwise, and where a read runs past the
    // segment)
    static int exif_orientation(const u8* t, size_t n) {
        const bool le = n >= 2 && t[0] == 'I' && t[1] == 'I';
        bool past = false;
        auto r16 = [&](size_t o) -> int {
            if (o + 1 >= n) {
                past = true;
                return 0;
            }
            return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
        };
        if (r16(2) != 42 || past || 4 + 3 >= n) return 1;
        const size_t ifd = le ? size_t(t[4]) | (size_t(t[5]) << 8) |
                                    (size_t(t[6]) << 16) | (size_t(t[7]) << 24)
                              : (size_t(t[4]) << 24) | (size_t(t[5]) << 16) |
                                    (size_t(t[6]) << 8) | size_t(t[7]);
        const int count = r16(ifd);
        for (int i = 0; i < count && !past; i++) {
            const size_t e = ifd + 2 + size_t(i) * 12;
            if (r16(e) == 0x0112 && !past) {
                const int v = r16(e + 8);
                return (!past && v >= 1 && v <= 8) ? v : 1;
            }
        }
        return 1;
    }

    void read_sof(int marker, size_t p, size_t len) {
        if (have_frame) fail("more than one frame");
        if (marker == 0xC5 || marker == 0xC6 || marker == 0xC7 ||
            marker == 0xCD || marker == 0xCE || marker == 0xCF)
            fail("hierarchical JPEG is not supported (nor by libjpeg)");
        if (marker == 0xCB)
            fail("arithmetic-coded lossless JPEG is not supported yet");
        lossless = marker == 0xC3;
        arith = marker >= 0xC9;
        progressive = marker == 0xC2 || marker == 0xCA;
        if (len < 6) fail("bad SOF segment");
        int precision = at(p);
        if (precision != 8)
            fail(std::to_string(precision) +
                 "-bit JPEG samples are not supported (nor by cv2)");
        height = u16(p + 1);
        width = u16(p + 3);
        int nc = at(p + 5);
        if (height <= 0 || width <= 0) fail("bad image size in SOF");
        if (nc != 1 && nc != 3 && nc != 4)
            fail(std::to_string(nc) +
                 "-component JPEG is not supported (nor by cv2)");
        if (lossless && nc == 1)
            fail("lossless grayscale JPEG does not decode to color (nor "
                 "by cv2: libjpeg-turbo refuses the conversion)");
        if (len != size_t(6 + 3 * nc)) fail("bad SOF length");
        comps.resize(nc);
        for (int i = 0; i < nc; i++) {
            Component& c = comps[i];
            c.id = at(p + 6 + 3 * i);
            c.h = at(p + 7 + 3 * i) >> 4;
            c.v = at(p + 7 + 3 * i) & 15;
            c.tq = at(p + 8 + 3 * i);
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
                fail("bad sampling factor or table in SOF");
            hmax = std::max(hmax, c.h);
            vmax = std::max(vmax, c.v);
        }
        if (lossless && (hmax > 1 || vmax > 1))
            fail("subsampled lossless JPEG is not supported yet");
        const int bs = lossless ? 1 : 8;   // a lossless "block" is a sample
        mcux = (width + bs * hmax - 1) / (bs * hmax);
        mcuy = (height + bs * vmax - 1) / (bs * vmax);
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
            for (int k = 0; k < 64; k++) c.coef_bits[k] = c.prev_bits[k] = -1;
        }
        have_frame = true;
    }

    // Walk the markers up to the first SOS (returns true) or EOI.
    bool read_headers() {
        for (;;) {
            int m = next_marker();
            if (m == 0xD8) continue;                 // SOI
            if (m == 0xD9) return false;             // EOI
            if (m >= 0xD0 && m <= 0xD7) continue;    // stray RSTn
            if (m == 0x01) continue;                 // TEM
            size_t len = size_t(u16(pos));
            if (len < 2) fail("bad marker segment length");
            size_t p = pos + 2, body = len - 2;
            if (m == 0xDA) return true;              // pos on the length
            pos += len;
            if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                m != 0xCC)
                read_sof(m, p, body);
            else if (m == 0xC4) read_dht(p, p + body);
            else if (m == 0xCC) read_dac(p, p + body);
            else if (m == 0xDB) read_dqt(p, p + body);
            else if (m == 0xDD) {
                if (body < 2) fail("bad DRI segment");
                restart_interval = u16(p);
            } else if (m == 0xDC) {
                fail("DNL marker is not supported");
            } else if (m == 0xDE || m == 0xDF) {
                fail("hierarchical JPEG is not supported (nor by libjpeg)");
            } else if (m >= 0xE0 && m <= 0xEF) {
                read_app(m, p, body);
            }
        }
    }

    // The marker after a restart interval (jdmarker.c read_restart_marker
    // with jpeg_resync_to_restart): `found` when it is the expected RSTn,
    // and the data goes on after it; otherwise the data has ended or
    // another marker stops it, and the rest of the scan reads zeros.
    size_t restart_marker(size_t q, int expected, bool& found) {
        found = false;
        for (;;) {
            while (q < size && data[q] != 0xFF) q++;
            size_t m = q;
            while (q < size && data[q] == 0xFF) q++;
            if (q >= size) return size;
            if (data[q] == 0x00) { q++; continue; }
            if (data[q] == 0xD0 + expected) {
                found = true;
                return q + 1;
            }
            if (data[q] >= 0xD0 && data[q] <= 0xD7)
                fail("missing or out-of-order restart marker");
            return m;
        }
    }

    // ---- one scan (pos on the SOS length)
    void read_scan() {
        if (!have_frame) fail("SOS before SOF");
        size_t len = size_t(u16(pos));
        size_t p = pos + 2;
        int ns = at(p);
        if (ns < 1 || ns > 4 || len != size_t(6 + 2 * ns))
            fail("bad SOS segment");
        std::vector<Component*> sc;
        for (int i = 0; i < ns; i++) {
            int id = at(p + 1 + 2 * i), tbl = at(p + 2 + 2 * i);
            Component* c = nullptr;
            for (Component& k : comps)
                if (k.id == id) c = &k;
            if (!c) fail("SOS names an unknown component");
            c->dc_tbl = tbl >> 4;
            c->ac_tbl = tbl & 15;
            if (c->dc_tbl > 3 || c->ac_tbl > 3) fail("bad SOS table");
            sc.push_back(c);
        }
        int Ss = at(p + 1 + 2 * ns), Se = at(p + 2 + 2 * ns);
        int Ah = at(p + 3 + 2 * ns) >> 4, Al = at(p + 3 + 2 * ns) & 15;
        pos += len;
        scans++;
        if (lossless) {
            if (Ss < 1 || Ss > 7 || Al > 7) fail("bad lossless scan parameters");
        } else if (progressive) {
            bool bad = Ss > Se || Se > 63 || Al > 13 || (Ah && Ah != Al + 1);
            if (Ss == 0 ? Se != 0 : ns != 1) bad = true;
            if (bad) fail("bad progressive scan parameters");
        } else {        // jdhuff.c only warns (JWRN_NOT_SEQUENTIAL)
            Ss = 0;
            Se = 63;
            Ah = Al = 0;
        }
        for (Component* c : sc) {
            if (!lossless && !c->latched) {       // jdinput.c latch_quant_tables
                if (!qt_present[c->tq]) fail("missing quantization table");
                std::memcpy(c->quant, qt[c->tq], sizeof(c->quant));
                c->latched = true;
            }
            if (lossless) {
                if (c->samples.empty())
                    c->samples.assign(size_t(c->dw) * c->dh, 0);
            } else if (c->coef.empty()) {
                c->coef.assign(size_t(c->bw) * c->bh * 64, 0);
            }
            bool need_dc = lossless || !progressive || (Ss == 0 && Ah == 0);
            bool need_ac = !lossless && (!progressive || Ss > 0);
            if (!arith && need_dc && !dc[c->dc_tbl].present)
                fail("missing DC Huffman table");
            if (!arith && need_ac && !ac[c->ac_tbl].present)
                fail("missing AC Huffman table");
            if (progressive) {   // jdphuff.c start_pass_phuff_decoder
                if (Ss > 0 && c->coef_bits[0] < 0)
                    fail("bad progression sequence (AC before DC)");
                for (int k = std::min(Ss, 1); k <= std::max(Se, 9); k++)
                    c->prev_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
                for (int k = Ss; k <= Se; k++) {
                    int expected = c->coef_bits[k] < 0 ? 0 : c->coef_bits[k];
                    if (Ah != expected) fail("bad progression sequence");
                    c->coef_bits[k] = Al;
                }
            }
        }
        if (lossless) return lossless_scan(sc, Ss, Al);
        Scan s{sc, Ss, Se, Ah, Al};
        if (arith) {
            ArithScan e(*this, s);
            mcu_loop(s, e);
            pos = e.rd.pos;
        } else {
            HuffScan e(*this, s);
            mcu_loop(s, e);
            pos = e.br.pos;           // the scan ends at the next marker
        }
    }

    struct Scan {
        std::vector<Component*> sc;
        int Ss, Se, Ah, Al;
    };

    // The MCUs of a DCT scan in order, with the restart intervals and
    // jdcoefct.c's last_good_iMCU_row; `e` decodes one block.
    template <class E>
    void mcu_loop(const Scan& s, E& e) {
        int ns = int(s.sc.size());
        int mx = ns == 1 ? s.sc[0]->wib : mcux;
        int my = ns == 1 ? s.sc[0]->hib : mcuy;
        int next_rst = 0;
        long long m = 0;
        for (int y = 0; y < my; y++)
            for (int x = 0; x < mx; x++, m++) {
                if (restart_interval && m > 0 && m % restart_interval == 0) {
                    e.restart(next_rst);
                    next_rst = (next_rst + 1) & 7;
                }
                if (!e.insufficient())
                    last_good_row = ns == 1 ? y / s.sc[0]->v : y;
                else
                    continue;           // the data ran out: leave the MCU
                for (int ci = 0; ci < ns; ci++) {
                    Component* c = s.sc[ci];
                    if (ns == 1) {
                        e.block(ci, c->block(x, y));
                        continue;
                    }
                    for (int by = 0; by < c->v; by++)
                        for (int bx = 0; bx < c->h; bx++)
                            e.block(ci, c->block(x * c->h + bx, y * c->v + by));
                }
            }
        if (e.insufficient()) hit_end = true;
    }

    // Huffman-coded DCT blocks (jdhuff.c decode_mcu, jdphuff.c).
    struct HuffScan {
        Decoder& d;
        const Scan& s;
        BitReader br;
        int pred[4] = {0, 0, 0, 0};
        int eobrun = 0;
        HuffScan(Decoder& dd, const Scan& ss)
            : d(dd), s(ss), br(dd.data, dd.size, dd.pos) {}
        bool insufficient() const { return br.insufficient; }
        void restart(int expected) {
            bool found;
            size_t q = d.restart_marker(br.pos, expected, found);
            br.reset(q, found);
            if (found) br.insufficient = false;
            std::fill(pred, pred + 4, 0);
            eobrun = 0;
        }
        void block(int ci, int16_t* blk) {
            Component& c = *s.sc[ci];
            d.decode_block(br, c, blk, pred[ci], eobrun, s.Ss, s.Se, s.Ah,
                           s.Al);
        }
    };

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
                    r = br.get(s);
                    blk[natural(k)] = int16_t(extend(r, s));
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
                    r = br.get(s);
                    blk[natural(k)] = int16_t(int(unsigned(extend(r, s)) << Al));
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
                if (s) {             // s != 1 only warns (JWRN_HUFF_BAD_CODE)
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
                if (s) blk[natural(k)] = int16_t(s);
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

    // Arithmetic-coded DCT blocks (jdarith.c decode_mcu, decode_mcu_DC_first,
    // decode_mcu_AC_first, decode_mcu_DC_refine, decode_mcu_AC_refine).
    struct ArithScan {
        Decoder& d;
        const Scan& s;
        ArithReader rd;
        u8 dc_stats[4][64], ac_stats[4][256];
        u8 fixed_bin = 113;
        int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
        bool broken = false;            // jdarith.c ct == -1: skip the rest
        ArithScan(Decoder& dd, const Scan& ss)
            : d(dd), s(ss), rd(dd.data, dd.size, dd.pos) {
            reset_stats();
        }
        bool insufficient() const { return false; }
        void reset_stats() {            // start_pass / process_restart
            for (size_t ci = 0; ci < s.sc.size(); ci++) {
                const Component& c = *s.sc[ci];
                if (!d.progressive || (s.Ss == 0 && s.Ah == 0)) {
                    std::memset(dc_stats[c.dc_tbl], 0, 64);
                    last_dc[ci] = dc_context[ci] = 0;
                }
                if (!d.progressive || s.Ss)
                    std::memset(ac_stats[c.ac_tbl], 0, 256);
            }
        }
        void restart(int expected) {
            bool found;
            size_t q = d.restart_marker(rd.pos, expected, found);
            rd.reset(q, found);
            reset_stats();
        }
        // F.1.4.4.1 / F.2.4.1: a DC difference, st on its context's bins
        int dc_diff(int ci, int tbl) {
            u8* st = dc_stats[tbl] + dc_context[ci];
            if (rd.decode(st) == 0) {
                dc_context[ci] = 0;
                return 0;
            }
            int sign = rd.decode(st + 1);
            st += 2 + sign;
            int m = rd.decode(st);
            if (m != 0) {
                st = dc_stats[tbl] + 20;
                while (rd.decode(st)) {
                    if ((m <<= 1) == 0x8000) {
                        broken = true;
                        return 0;
                    }
                    st += 1;
                }
            }
            if (m < int((1L << d.arith_dc_L[tbl]) >> 1))
                dc_context[ci] = 0;
            else if (m > int((1L << d.arith_dc_U[tbl]) >> 1))
                dc_context[ci] = 12 + sign * 4;
            else
                dc_context[ci] = 4 + sign * 4;
            int v = m;
            st += 14;
            while (m >>= 1)
                if (rd.decode(st)) v |= m;
            v += 1;
            return sign ? -v : v;
        }
        // F.2.4.2: the AC coefficients Ss..Se of one block, shifted by Al;
        // false on a spectral or magnitude overflow
        bool ac_first(int tbl, int16_t* blk, int Ss, int Se, int Al) {
            for (int k = Ss; k <= Se; k++) {
                u8* st = ac_stats[tbl] + 3 * (k - 1);
                if (rd.decode(st)) break;                 // EOB
                while (rd.decode(st + 1) == 0) {
                    st += 3;
                    if (++k > Se) return false;
                }
                int sign = rd.decode(&fixed_bin);
                st += 2;
                int m = rd.decode(st);
                if (m != 0 && rd.decode(st)) {
                    m <<= 1;
                    st = ac_stats[tbl] + (k <= d.arith_ac_K[tbl] ? 189 : 217);
                    while (rd.decode(st)) {
                        if ((m <<= 1) == 0x8000) return false;
                        st += 1;
                    }
                }
                int v = m;
                st += 14;
                while (m >>= 1)
                    if (rd.decode(st)) v |= m;
                v += 1;
                if (sign) v = -v;
                blk[kNatural[k]] = int16_t(int(unsigned(v) << Al));
            }
            return true;
        }
        void block(int ci, int16_t* blk) {
            if (broken) return;
            const Component& c = *s.sc[ci];
            if (!d.progressive) {
                int diff = dc_diff(ci, c.dc_tbl);
                if (broken) return;
                last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF;
                blk[0] = int16_t(last_dc[ci]);
                if (!ac_first(c.ac_tbl, blk, 1, 63, 0)) broken = true;
                return;
            }
            if (s.Ss == 0 && s.Ah == 0) {
                int diff = dc_diff(ci, c.dc_tbl);
                if (broken) return;
                last_dc[ci] = (last_dc[ci] + diff) & 0xFFFF;
                blk[0] = int16_t(int(unsigned(last_dc[ci]) << s.Al));
            } else if (s.Ss == 0) {
                if (rd.decode(&fixed_bin)) blk[0] = int16_t(blk[0] | (1 << s.Al));
            } else if (s.Ah == 0) {
                if (!ac_first(c.ac_tbl, blk, s.Ss, s.Se, s.Al)) broken = true;
            } else {
                ac_refine(c.ac_tbl, blk);
            }
        }
        void ac_refine(int tbl, int16_t* blk) {
            int p1 = 1 << s.Al, m1 = -(1 << s.Al);
            int kex = s.Se;
            for (; kex > 0; kex--)
                if (blk[kNatural[kex]]) break;
            for (int k = s.Ss; k <= s.Se; k++) {
                u8* st = ac_stats[tbl] + 3 * (k - 1);
                if (k > kex && rd.decode(st)) break;      // EOB
                for (;;) {
                    int16_t* co = blk + kNatural[k];
                    if (*co) {
                        if (rd.decode(st + 2))
                            *co = int16_t(*co < 0 ? *co + m1 : *co + p1);
                        break;
                    }
                    if (rd.decode(st + 1)) {
                        *co = int16_t(rd.decode(&fixed_bin) ? m1 : p1);
                        break;
                    }
                    st += 3;
                    if (++k > s.Se) {
                        broken = true;
                        return;
                    }
                }
            }
        }
    };

    // A lossless scan (jdlhuff.c, jddiffct.c, jdlossls.c): Huffman-coded
    // differences, undone row by row with predictor `psv` and point
    // transform `pt`; every component is sampled 1x1.
    void lossless_scan(const std::vector<Component*>& sc, int psv, int pt) {
        int ns = int(sc.size());
        if (restart_interval && restart_interval % width)
            fail("lossless JPEG with restarts inside a row is not supported");
        int restart_rows = restart_interval / width;
        BitReader br(data, size, pos);
        std::vector<std::vector<int>> diff(ns, std::vector<int>(width)),
            prev(ns, std::vector<int>(width)), cur(ns, std::vector<int>(width));
        bool first_row = true;
        int next_rst = 0;
        for (int y = 0; y < height; y++) {
            if (restart_rows && y > 0 && y % restart_rows == 0) {
                bool found;
                size_t q = restart_marker(br.pos, next_rst, found);
                br.reset(q, found);
                if (found) br.insufficient = false;
                next_rst = (next_rst + 1) & 7;
                first_row = true;
            }
            for (int x = 0; x < width; x++)
                for (int ci = 0; ci < ns; ci++) {
                    int d = 0;
                    if (!br.insufficient) {
                        int s = br.decode(dc[sc[ci]->dc_tbl]);
                        if (s == 16) d = 32768;
                        else if (s > 16) fail("corrupt lossless difference");
                        else if (s) d = extend(br.get(s), s);
                    }
                    diff[ci][x] = d;
                }
            for (int ci = 0; ci < ns; ci++) {
                const int* df = diff[ci].data();
                int* out = cur[ci].data();
                const int* up = prev[ci].data();
                int ra;
                if (first_row) {
                    ra = (df[0] + (1 << (8 - pt - 1))) & 0xFFFF;
                    out[0] = ra;
                    for (int x = 1; x < width; x++)
                        out[x] = ra = (df[x] + ra) & 0xFFFF;
                } else {
                    int rb = up[0], rc;
                    out[0] = ra = (df[0] + rb) & 0xFFFF;
                    for (int x = 1; x < width; x++) {
                        rc = rb;
                        rb = up[x];
                        int p;
                        switch (psv) {
                        case 1: p = ra; break;
                        case 2: p = rb; break;
                        case 3: p = rc; break;
                        case 4: p = ra + rb - rc; break;
                        case 5: p = ra + ((rb - rc) >> 1); break;
                        case 6: p = rb + ((ra - rc) >> 1); break;
                        default: p = (ra + rb) >> 1; break;
                        }
                        out[x] = ra = (df[x] + p) & 0xFFFF;
                    }
                }
                u8* dst = sc[ci]->samples.data() + size_t(y) * width;
                for (int x = 0; x < width; x++) dst[x] = u8(out[x] << pt);
                std::swap(prev[ci], cur[ci]);
            }
            first_row = false;
        }
        if (br.insufficient) hit_end = true;
        pos = br.pos;
    }

    // Every scan up to EOI, or to the end of the data (libjpeg then
    // supplies an EOI and decodes what came, with a warning).
    void read_all() {
        if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
            fail("not a JPEG file (no SOI marker)");
        pos = 2;
        while (read_headers()) read_scan();
        if (!have_frame) fail("no SOF marker");
        if (scans == 0) fail("no image data (no SOS marker)");
    }

    // jdcoefct.c smoothing_ok: block smoothing of an incomplete
    // progressive image (some of AC 1..9 not at full precision)
    bool smoothing_ok() const {
        if (!progressive) return false;
        bool useful = false;
        for (const Component& c : comps) {
            if (!c.latched) return false;
            for (int k = 0; k <= 9; k++)
                if (c.quant[k] == 0) return false;
            if (c.coef_bits[0] < 0) return false;
            for (int k = 1; k <= 9; k++)
                if (c.coef_bits[k] != 0) useful = true;
        }
        return useful;
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

// The ISLOW IDCT as libjpeg-turbo's SIMD version (jidctint-avx2.asm, the
// one cv2's build runs) computes it: the products coefficient x quantizer
// in 16 bits, the first pass's outputs saturated to 16 bits and the
// samples clamped to 0..255.  Where no value leaves 16 bits (any block of
// a well-formed file) this is jidctint.c's result; where one does (the
// junk a cut-short scan can leave), it is the SIMD one, not jidctint.c's
// wrapped range limit.
inline int64_t dequant(int16_t c, uint16_t q) { return int16_t(c * int(q)); }
inline int sat16(int64_t x) {
    return int(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}
inline u8 sample(int64_t x) { return u8(x < -128 ? 0 : (x > 127 ? 255 : x + 128)); }

void idct_islow(const int16_t* in, const uint16_t* q, u8* out, int stride) {
    int ws[64];
    for (int c = 0; c < 8; c++) {                 // pass 1: columns
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] &&
            !ip[56]) {
            int dc = sat16(dequant(ip[0], qp[0]) * (1 << PASS1_BITS));
            for (int r = 0; r < 8; r++) wp[8 * r] = dc;
            continue;
        }
        int64_t z2 = dequant(ip[16], qp[16]), z3 = dequant(ip[48], qp[48]);
        int64_t z1 = (z2 + z3) * FIX_0_541196100;
        int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int64_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = dequant(ip[0], qp[0]);
        z3 = dequant(ip[32], qp[32]);
        int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
        int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
        int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = dequant(ip[56], qp[56]);
        tmp1 = dequant(ip[40], qp[40]);
        tmp2 = dequant(ip[24], qp[24]);
        tmp3 = dequant(ip[8], qp[8]);
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
        wp[0] = sat16(descale(tmp10 + tmp3, n));
        wp[56] = sat16(descale(tmp10 - tmp3, n));
        wp[8] = sat16(descale(tmp11 + tmp2, n));
        wp[48] = sat16(descale(tmp11 - tmp2, n));
        wp[16] = sat16(descale(tmp12 + tmp1, n));
        wp[40] = sat16(descale(tmp12 - tmp1, n));
        wp[24] = sat16(descale(tmp13 + tmp0, n));
        wp[32] = sat16(descale(tmp13 - tmp0, n));
    }
    for (int r = 0; r < 8; r++) {                 // pass 2: rows
        const int* wp = ws + 8 * r;
        u8* op = out + size_t(r) * stride;
        if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] &&
            !wp[7]) {
            u8 dc = sample(descale(wp[0], PASS1_BITS + 3));
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
        op[0] = sample(descale(tmp10 + tmp3, n));
        op[7] = sample(descale(tmp10 - tmp3, n));
        op[1] = sample(descale(tmp11 + tmp2, n));
        op[6] = sample(descale(tmp11 - tmp2, n));
        op[2] = sample(descale(tmp12 + tmp1, n));
        op[5] = sample(descale(tmp12 - tmp1, n));
        op[3] = sample(descale(tmp13 + tmp0, n));
        op[4] = sample(descale(tmp13 - tmp0, n));
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

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1 and later): the
// blocks of component `c` through the IDCT, each AC 1..9 coefficient that
// is still zero and not known exact estimated from the DC values of the
// 5x5 blocks around it (and, before any AC data came, the DC itself).
// `cur` and `prev` are the coef_bits latches (zigzag 0..9) for the iMCU
// rows up to and after the last one the final scan reached.
void idct_smooth(const Decoder& d, Component& c, const int* cur,
                 const int* prev, u8* plane, int stride) {
    const int v = c.v, T = d.mcuy, last_col = c.wib - 1;
    const uint16_t* q = c.quant;
    const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16],
                  Q11 = q[9], Q02 = q[2], Q03 = q[3], Q12 = q[10],
                  Q21 = q[17], Q30 = q[24];
    auto predict = [](int64_t num, int64_t qk, int al) {
        int pred;
        if (num >= 0) {
            pred = int(((qk << 7) + num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        } else {
            pred = int(((qk << 7) - num) / (qk << 8));
            if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            pred = -pred;
        }
        return int16_t(pred);
    };
    int16_t ws[64];
    for (int r = 0; r < T; r++) {
        int block_rows = r < T - 1 ? v : (c.hib % v ? c.hib % v : v);
        const int* bits = r > d.last_good_row ? prev : cur;
        bool change_dc = true;
        for (int k = 1; k <= 9; k++)
            if (bits[k] != -1) change_dc = false;
        const int image_block_rows = block_rows * T;
        for (int br = 0; br < block_rows; br++) {
            const int row = r * v + br, ibr = r * block_rows + br;
            const int16_t* b0 = c.block(0, row);
            const int16_t* bm1 = ibr > 0 ? c.block(0, row - 1) : b0;
            const int16_t* bm2 = ibr > 1 ? c.block(0, row - 2) : bm1;
            const int16_t* bp1 = ibr < image_block_rows - 1 ? c.block(0, row + 1) : b0;
            const int16_t* bp2 = ibr < image_block_rows - 2 ? c.block(0, row + 2) : bp1;
            int DC01, DC02, DC03, DC04, DC05, DC06, DC07, DC08, DC09, DC10,
                DC11, DC12, DC13, DC14, DC15, DC16, DC17, DC18, DC19, DC20,
                DC21, DC22, DC23, DC24, DC25;
            DC01 = DC02 = DC03 = DC04 = DC05 = bm2[0];
            DC06 = DC07 = DC08 = DC09 = DC10 = bm1[0];
            DC11 = DC12 = DC13 = DC14 = DC15 = b0[0];
            DC16 = DC17 = DC18 = DC19 = DC20 = bp1[0];
            DC21 = DC22 = DC23 = DC24 = DC25 = bp2[0];
            for (int bn = 0; bn <= last_col; bn++) {
                const size_t o = size_t(bn) * 64;
                std::memcpy(ws, b0 + o, sizeof(ws));
                if (bn == 0 && bn < last_col) {
                    DC04 = bm2[o + 64]; DC09 = bm1[o + 64]; DC14 = b0[o + 64];
                    DC19 = bp1[o + 64]; DC24 = bp2[o + 64];
                }
                if (bn + 1 < last_col) {
                    DC05 = bm2[o + 128]; DC10 = bm1[o + 128]; DC15 = b0[o + 128];
                    DC20 = bp1[o + 128]; DC25 = bp2[o + 128];
                }
                int al;
                int64_t num;
                if ((al = bits[1]) != 0 && ws[1] == 0) {          // AC01
                    num = Q00 * (change_dc ?
                        (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                         13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                         38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                         13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
                        (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
                    ws[1] = predict(num, Q01, al);
                }
                if ((al = bits[2]) != 0 && ws[8] == 0) {          // AC10
                    num = Q00 * (change_dc ?
                        (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                         13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                         13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                         3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                        (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
                    ws[8] = predict(num, Q10, al);
                }
                if ((al = bits[3]) != 0 && ws[16] == 0) {         // AC20
                    num = Q00 * (change_dc ?
                        (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                         14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                         2 * DC19 + DC23) :
                        (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
                    ws[16] = predict(num, Q20, al);
                }
                if ((al = bits[4]) != 0 && ws[9] == 0) {          // AC11
                    num = Q00 * (change_dc ?
                        (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                         9 * DC19 + DC21 - DC25) :
                        (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                         DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
                    ws[9] = predict(num, Q11, al);
                }
                if ((al = bits[5]) != 0 && ws[2] == 0) {          // AC02
                    num = Q00 * (change_dc ?
                        (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                         14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                         2 * DC19) :
                        (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
                    ws[2] = predict(num, Q02, al);
                }
                if (change_dc) {
                    if ((al = bits[6]) != 0 && ws[3] == 0) {      // AC03
                        num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 -
                                     DC19);
                        ws[3] = predict(num, Q03, al);
                    }
                    if ((al = bits[7]) != 0 && ws[10] == 0) {     // AC12
                        num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 -
                                     DC19);
                        ws[10] = predict(num, Q12, al);
                    }
                    if ((al = bits[8]) != 0 && ws[17] == 0) {     // AC21
                        num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 -
                                     DC19);
                        ws[17] = predict(num, Q21, al);
                    }
                    if ((al = bits[9]) != 0 && ws[24] == 0) {     // AC30
                        num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 -
                                     DC19);
                        ws[24] = predict(num, Q30, al);
                    }
                    num = Q00 *
                          (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                           6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                           8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                           8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                           6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 -
                           6 * DC24 - 2 * DC25);
                    ws[0] = predict(num, Q00, 0);
                }
                idct_islow(ws, c.quant, plane + size_t(row) * 8 * stride + bn * 8,
                           stride);
                DC01 = DC02; DC02 = DC03; DC03 = DC04; DC04 = DC05;
                DC06 = DC07; DC07 = DC08; DC08 = DC09; DC09 = DC10;
                DC11 = DC12; DC12 = DC13; DC13 = DC14; DC14 = DC15;
                DC16 = DC17; DC17 = DC18; DC18 = DC19; DC19 = DC20;
                DC21 = DC22; DC22 = DC23; DC23 = DC24; DC24 = DC25;
            }
        }
    }
}

// OpenCV's icvCvt_CMYK2BGR_8u_C4C3R: each of C, M, Y scaled by K
inline u8 cmyk_channel(int c, int k) { return u8(k - ((255 - c) * k >> 8)); }

// The decoded scans of `d` (read_all) -> (height, width, 3) RGB in the
// stored orientation, as cv2 asks libjpeg for it: RGB for 1 or 3
// components, CMYK (YCCK converted) for 4, then OpenCV's CMYK -> BGR.
// transform: jpeg_decode's.
void decode(Decoder& d, u8* rgb, int transform) {
    int W = d.width, H = d.height, nc = int(d.comps.size());
    const bool smooth = d.smoothing_ok();
    std::vector<std::vector<u8>> full(nc);
    for (int ci = 0; ci < nc; ci++) {
        Component& c = d.comps[ci];
        if (d.lossless) {
            if (c.samples.empty()) c.samples.assign(size_t(W) * H, 0);
            full[ci] = c.samples;
            continue;
        }
        if (c.coef.empty()) c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
        int stride = c.bw * 8;
        std::vector<u8> plane(size_t(stride) * c.bh * 8);
        if (smooth) {
            int cur[10], prev[10];
            for (int k = 0; k < 10; k++) {
                cur[k] = c.coef_bits[k];
                prev[k] = d.scans > 1 ? c.prev_bits[k] : -1;
            }
            idct_smooth(d, c, cur, prev, plane.data(), stride);
        } else {
            for (int by = 0; by < c.hib; by++)
                for (int bx = 0; bx < c.wib; bx++)
                    idct_islow(c.block(bx, by), c.quant,
                               plane.data() + size_t(by) * 8 * stride + bx * 8,
                               stride);
        }
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
    const u8 *p0 = full[0].data(), *p1 = full[1].data(), *p2 = full[2].data();
    if (nc == 4) {
        // jdapimin.c: Adobe transform 2 (or another nonzero one) is YCCK
        bool ycck = transform >= 0 ? transform == 1
                                   : d.saw_adobe && d.adobe_transform != 0;
        if (ycck && d.lossless)
            fail("lossless YCCK JPEG does not decode to CMYK (nor by cv2: "
                 "libjpeg-turbo refuses the conversion)");
        const u8* p3 = full[3].data();
        for (size_t i = 0; i < n; i++) {
            int c = p0[i], m = p1[i], y = p2[i], k = p3[i];
            if (ycck) {                 // jdcolor.c ycck_cmyk_convert
                int yy = c, cb = m, cr = y;
                c = clamp255(255 - (yy + kYcc.cr_r[cr]));
                m = clamp255(255 - (yy + int((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16)));
                y = clamp255(255 - (yy + kYcc.cb_b[cb]));
            }
            rgb[3 * i] = cmyk_channel(c, k);
            rgb[3 * i + 1] = cmyk_channel(m, k);
            rgb[3 * i + 2] = cmyk_channel(y, k);
        }
        return;
    }
    // jdapimin.c default_decompress_parms
    bool ycc;
    if (transform >= 0) ycc = transform == 1;
    else if (d.saw_jfif) ycc = true;
    else if (d.saw_adobe) ycc = d.adobe_transform != 0;
    else ycc = !(d.comps[0].id == 82 && d.comps[1].id == 71 &&
                 d.comps[2].id == 66);
    if (ycc && d.lossless)
        fail("lossless YCbCr JPEG does not decode to RGB (nor by cv2: "
             "libjpeg-turbo refuses the conversion)");
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
// transform: -1 the color space the markers give (jdapimin.c), 0 none
// (the components as they are), 1 YCbCr (or YCCK) -- what libtiff sets
// for a JPEG-compressed TIFF.  Returns 0; 1 when the data ended early and
// the image decoded all the same (libjpeg's warnings, the message in err);
// or -1 with a message.
int jpeg_decode(const uint8_t* buf, long long len, int transform,
                uint8_t* rgb, long long cap, char* err, int errlen) {
    try {
        Decoder d(buf, size_t(len));
        d.read_all();
        if (cap < (long long)d.width * d.height * 3) fail("output too small");
        decode(d, rgb, transform);
        if (d.premature || d.hit_end) {
            set_error(err, errlen,
                      d.hit_end ? "Corrupt JPEG data: premature end of data "
                                  "segment (the rest of the scan is left "
                                  "empty)"
                                : "Premature end of JPEG file");
            return 1;
        }
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
