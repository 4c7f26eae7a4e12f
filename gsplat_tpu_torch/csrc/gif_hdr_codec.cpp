// GIF and Radiance HDR codecs (ctypes ABI) for utils/image_io.py, which
// parses both containers itself.  GIF: the LZW decoding of one frame's
// sub-blocks as cv2 5.0.0's GifDecoder::lzwDecode does it (its table, its
// code-width changes, a full table without a clear, and its rule for data
// that ends early or runs past the frame), and the frame cv2.imwrite(x.gif)
// writes by default: Floyd-Steinberg error diffusion onto the fixed 3-3-2
// palette, then LZW in 255-byte sub-blocks.  Radiance HDR: the scanlines of
// rgbe.c's RGBE_ReadPixels_RLE (new-style run-length or flat) and
// RGBE_WriteBytes_RLE.  Built at first use with the system C++ compiler
// (ops/cuda_build.load_host_library).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using u8 = uint8_t;
using ll = long long;

// status codes shared with image_io.py
constexpr int kOk = 1, kFalse = 0, kEof = -1, kTooLong = -2, kBadCodeSize = -3;

constexpr int kMaxTable = 4096;          // 12-bit codes

// One LZW table entry: its string is the string of `parent` (or the
// literal `parent` itself when len == 2 and parent < the clear code)
// followed by `suffix`.
struct Entry {
    int parent;
    int len;
    u8 suffix;
    u8 first;
};

// GIF palette levels: R and G take 8 levels a 36 apart, B 4 a 85 apart.
inline int nearest_level(float p, float step, int top) {
    // the nearest of 0, step, ..., top * step; a tie goes up
    int best = 0;
    float dist = p < 0.f ? -p : p;
    for (int k = 1; k <= top; k++) {
        float d = p - step * float(k);
        if (d < 0.f) d = -d;
        if (d <= dist) {
            dist = d;
            best = k;
        }
    }
    return best;
}

struct BitWriter {
    std::vector<u8>& out;
    uint32_t acc = 0;
    int nacc = 0;
    explicit BitWriter(std::vector<u8>& o) : out(o) {}
    void put(int code, int width) {
        acc |= uint32_t(code) << nacc;
        nacc += width;
        while (nacc >= 8) {
            out.push_back(u8(acc & 0xFF));
            acc >>= 8;
            nacc -= 8;
        }
    }
    void flush() {
        if (nacc > 0) out.push_back(u8(acc & 0xFF));
        acc = 0;
        nacc = 0;
    }
};

}  // namespace

extern "C" {

// One GIF frame's image data from data[pos] (its LZW minimum code size,
// then the sub-blocks), decoded into out (w * h palette indexes) as cv2
// 5.0.0 decodes it.  Returns 1 where cv2 succeeds; 0 where its decoder
// returns false (a code past the table, too few indexes, data after a
// full frame); -1 where it reads past the end of the file; -2 where a
// string runs past the frame; -3 for a minimum code size outside 2-11.
int gif_lzw_decode(const uint8_t* data, long long n, long long pos, int w,
                   int h, uint8_t* out) {
    const ll npix = ll(w) * ll(h);
    auto get = [&](int& v) -> bool {
        if (pos >= n) return false;
        v = data[pos++];
        return true;
    };
    int mcs;
    if (!get(mcs)) return kEof;
    if (mcs < 2 || mcs > 11) return kBadCodeSize;
    const int clear = 1 << mcs, exit_code = clear + 1;
    std::vector<Entry> table(kMaxTable + 1);
    ll idx = 0;
    int block;
    if (!get(block)) return kEof;
    if (block == 0) return idx == npix ? kOk : kFalse;
    int size = mcs + 1, top = exit_code;     // top: the pending entry
    uint32_t src = 0;
    int left = 0;
    // the states of cv2's loop: read a byte, decode a code, or (short of
    // bits) go on to the next block where this one is used up
    enum { READ, DECODE, NEED_MORE } state = READ;
    while (true) {
        if (state == READ) {
            int b;
            if (!get(b)) return kEof;
            src |= uint32_t(b) << left;
            left += 8;
            block--;
            if (left >= size) {
                state = DECODE;
            } else if (block != 0) {
                state = READ;
            } else {
                if (!get(block)) return kEof;
                if (block == 0) break;
                state = READ;
            }
            continue;
        }
        if (state == NEED_MORE) {
            if (block == 0) {
                if (!get(block)) return kEof;
                if (block == 0) break;
            }
            state = size <= left ? DECODE : READ;
            continue;
        }
        // DECODE
        const int code = int(src & ((1u << size) - 1));
        const int pow = 1 << size;
        src >>= size;
        left -= size;
        if (code == clear || code == exit_code) {
            std::fill(table.begin(), table.end(), Entry{0, 0, 0, 0});
            top = exit_code;
            size = mcs + 1;
            // after the end code cv2 looks at the block before the bits
            state = code == clear && size <= left ? DECODE : NEED_MORE;
            continue;
        }
        if (idx >= npix) {     // a code after the frame is full
            if (block != 0) return kFalse;
            int b;
            if (!get(b)) return kEof;
            return b == 0 ? kOk : kFalse;
        }
        if (code < clear) {
            if (top < kMaxTable) {
                table[top].suffix = u8(code);
                top++;
                table[top] = Entry{code, 2, 0, u8(code)};
            }
            out[idx++] = u8(code);
        } else {
            if (top < kMaxTable) {
                if (code > top) return kFalse;
                table[top].suffix = table[code].first;
                top++;
                table[top] = Entry{code, table[code].len + 1, 0,
                                   table[code].first};
            }
            const int len = table[code].len;
            if (idx + len > npix) return kTooLong;
            // the string of `code`, written back to front
            int c = code;
            for (ll p = idx + len - 1; p > idx; p--) {
                out[p] = table[c].suffix;
                c = table[c].parent;
            }
            out[idx] = u8(c);
            idx += len;
        }
        if (pow == top && size <= 11) size++;
        state = size <= left ? DECODE : NEED_MORE;
    }
    return idx == npix ? kOk : kFalse;
}

// The palette indexes cv2.imwrite(name.gif, bgr) writes by default for an
// (h, w, 3) RGB image: Floyd-Steinberg error diffusion, left to right on
// every row, each channel onto its levels (R, G: 0, 36, ..., 252; B: 0,
// 85, 170, 255; a tie to the upper level), index R << 5 | G << 2 | B.  The
// arithmetic is cv2's, in float: the shares of the errors add up in a
// buffer of their own, and a pixel's value is its byte plus that sum.
void gif_dither_332(const uint8_t* rgb, int w, int h, uint8_t* idx) {
    std::vector<float> cur(size_t(w) * 3, 0.f), nxt(size_t(w) * 3, 0.f);
    for (int y = 0; y < h; y++) {
        std::fill(nxt.begin(), nxt.end(), 0.f);
        const uint8_t* row = rgb + size_t(y) * w * 3;
        for (int x = 0; x < w; x++) {
            int k[3];
            for (int c = 0; c < 3; c++) {
                const float step = c == 2 ? 85.f : 36.f;
                const int top = c == 2 ? 3 : 7;
                const float p = float(row[x * 3 + c]) + cur[size_t(x) * 3 + c];
                k[c] = nearest_level(p, step, top);
                const float e = p - step * float(k[c]);
                if (x + 1 < w) cur[size_t(x + 1) * 3 + c] += e * 7.f / 16.f;
                if (y + 1 < h) {
                    if (x > 0) nxt[size_t(x - 1) * 3 + c] += e * 3.f / 16.f;
                    nxt[size_t(x) * 3 + c] += e * 5.f / 16.f;
                    if (x + 1 < w) nxt[size_t(x + 1) * 3 + c] += e / 16.f;
                }
            }
            idx[size_t(y) * w + x] = u8((k[0] << 5) | (k[1] << 2) | k[2]);
        }
        std::swap(cur, nxt);
    }
}

// LZW-encodes n palette indexes (minimum code size 8, a clear code first
// and whenever the table fills, codes packed LSB first) into 255-byte
// sub-blocks and their zero terminator, as cv2's GIF encoder writes them.
// Returns the bytes written, or -(bytes needed) - 2 when cap is too small.
long long gif_lzw_encode(const uint8_t* idx, long long n, uint8_t* dst,
                         long long cap) {
    constexpr int mcs = 8, clear = 1 << mcs, exit_code = clear + 1;
    std::vector<u8> codes;
    codes.reserve(size_t(n) + 64);
    BitWriter bw(codes);
    // child[code * 256 + k]: the code of string(code) + k, or 0
    std::vector<uint16_t> child(size_t(kMaxTable) * 256, 0);
    int size = mcs + 1, next = exit_code + 1;
    bw.put(clear, size);
    if (n > 0) {
        int prefix = idx[0];
        for (ll i = 1; i < n; i++) {
            const int k = idx[i];
            const uint16_t c = child[size_t(prefix) * 256 + k];
            if (c) {
                prefix = c;
                continue;
            }
            bw.put(prefix, size);
            child[size_t(prefix) * 256 + k] = uint16_t(next);
            if (next == (1 << size)) size++;
            next++;
            if (next == kMaxTable) {
                bw.put(clear, 12);
                std::fill(child.begin(), child.end(), 0);
                size = mcs + 1;
                next = exit_code + 1;
            }
            prefix = k;
        }
        bw.put(prefix, size);
    }
    bw.put(exit_code, size);
    bw.flush();
    const ll body = ll(codes.size());
    const ll total = body + (body + 254) / 255 + 1;
    if (total > cap) return -total - 2;
    ll o = 0;
    for (ll i = 0; i < body; i += 255) {
        const ll len = body - i < 255 ? body - i : 255;
        dst[o++] = u8(len);
        std::memcpy(dst + o, codes.data() + i, size_t(len));
        o += len;
    }
    dst[o++] = 0;
    return o;
}

// Radiance HDR pixels from data[pos], as rgbe.c's RGBE_ReadPixels_RLE reads
// them: flat 4-byte pixels where the width is under 8 or over 32767 or a
// scanline does not start 2 2 (then the rest of the file is flat), else
// new-style run-length scanlines, each channel apart.  rgbe gets (h, w, 4)
// bytes (R, G, B, E).  Returns 0, or -1 where the data ends early, -2 for
// a scanline of another width, -3 for a bad run.
int hdr_read_pixels(const uint8_t* data, long long n, long long pos, int w,
                    int h, uint8_t* rgbe) {
    const ll npix = ll(w) * ll(h);
    auto flat = [&](ll from, ll count) -> int {
        if (count <= 0) return 0;
        if (n - pos < count * 4) return -1;
        std::memcpy(rgbe + from * 4, data + pos, size_t(count * 4));
        pos += count * 4;
        return 0;
    };
    if (w < 8 || w > 0x7fff) return flat(0, npix);
    std::vector<u8> line(static_cast<size_t>(w) * 4);
    for (int y = 0; y < h; y++) {
        if (n - pos < 4) return -1;
        const u8* p = data + pos;
        pos += 4;
        if (p[0] != 2 || p[1] != 2 || (p[2] & 0x80)) {
            std::memcpy(rgbe + ll(y) * w * 4, p, 4);
            return flat(ll(y) * w + 1, ll(w) * (h - y) - 1);
        }
        if (((int(p[2]) << 8) | p[3]) != w) return -2;
        for (int c = 0; c < 4; c++) {
            u8* ptr = line.data() + size_t(c) * w;
            u8* const end = ptr + w;
            while (ptr < end) {
                if (n - pos < 2) return -1;
                const int b0 = data[pos], b1 = data[pos + 1];
                pos += 2;
                if (b0 > 128) {
                    const int count = b0 - 128;
                    if (count > end - ptr) return -3;
                    std::memset(ptr, b1, size_t(count));
                    ptr += count;
                } else {
                    const int count = b0;
                    if (count == 0 || count > end - ptr) return -3;
                    *ptr++ = u8(b1);
                    if (count - 1 > 0) {
                        if (n - pos < count - 1) return -1;
                        std::memcpy(ptr, data + pos, size_t(count - 1));
                        pos += count - 1;
                        ptr += count - 1;
                    }
                }
            }
        }
        u8* row = rgbe + ll(y) * w * 4;
        for (int x = 0; x < w; x++)
            for (int c = 0; c < 4; c++)
                row[x * 4 + c] = line[size_t(c) * w + x];
    }
    return 0;
}

// (h, w, 4) RGBE bytes → the scanlines rgbe.c's RGBE_WritePixels_RLE
// writes: flat where the width is under 8 or over 32767, else each
// scanline's 2 2 w>>8 w&255 and its four channels through
// RGBE_WriteBytes_RLE (runs of 4 or more, short runs before them, literal
// stretches of up to 128).  Returns the bytes written, or -(bytes needed)
// - 2 when cap is too small.
long long hdr_write_pixels(const uint8_t* rgbe, int w, int h, uint8_t* dst,
                           long long cap) {
    std::vector<u8> out;
    const ll npix = ll(w) * ll(h);
    if (w < 8 || w > 0x7fff) {
        out.assign(rgbe, rgbe + npix * 4);
    } else {
        out.reserve(size_t(npix) * 4 + size_t(h) * 4 + 16);
        std::vector<u8> line(static_cast<size_t>(w));
        for (int y = 0; y < h; y++) {
            out.push_back(2);
            out.push_back(2);
            out.push_back(u8(w >> 8));
            out.push_back(u8(w & 0xFF));
            for (int c = 0; c < 4; c++) {
                for (int x = 0; x < w; x++)
                    line[x] = rgbe[(ll(y) * w + x) * 4 + c];
                const u8* d = line.data();
                const int numbytes = w;
                constexpr int kMinRun = 4;
                int cur = 0;
                while (cur < numbytes) {
                    int beg_run = cur, run_count = 0, old_run_count = 0;
                    while (run_count < kMinRun && beg_run < numbytes) {
                        beg_run += run_count;
                        old_run_count = run_count;
                        run_count = 1;
                        while (beg_run + run_count < numbytes &&
                               run_count < 127 &&
                               d[beg_run] == d[beg_run + run_count])
                            run_count++;
                    }
                    if (old_run_count > 1 && old_run_count == beg_run - cur) {
                        out.push_back(u8(128 + old_run_count));
                        out.push_back(d[cur]);
                        cur = beg_run;
                    }
                    while (cur < beg_run) {
                        int nonrun = beg_run - cur;
                        if (nonrun > 128) nonrun = 128;
                        out.push_back(u8(nonrun));
                        out.insert(out.end(), d + cur, d + cur + nonrun);
                        cur += nonrun;
                    }
                    if (run_count >= kMinRun) {
                        out.push_back(u8(128 + run_count));
                        out.push_back(d[beg_run]);
                        cur += run_count;
                    }
                }
            }
        }
    }
    const ll total = ll(out.size());
    if (total > cap) return -total - 2;
    std::memcpy(dst, out.data(), size_t(total));
    return total;
}

}  // extern "C"
