// TIFF strip and tile codecs (ctypes ABI) for utils/image_io.py, which
// parses the file's directory itself: LZW (TIFF 6.0 section 13, as
// libtiff's tif_lzw.c decodes and encodes it; also the old-style,
// LSB-first codes of LZWDecodeCompat) and PackBits (tif_packbits.c)
// decoding, and the LZW encoding of what cv2.imwrite(name.tif, img) writes
// by default, byte for byte.  Deflate strips are inflated by Python's zlib
// and need nothing here.  Built at first use with the system C++ compiler
// (ops/cuda_build.load_host_library).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using u8 = uint8_t;

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kCodeMax = (1 << kBitsMax) - 1;   // tif_lzw.c CODE_MAX

}  // namespace

extern "C" {

// One LZW strip (MSB-first codes, the early width change) into dst (cap
// bytes).  Returns the bytes written: decoding stops at EOI, at the end of
// the data, or when dst is full; -1 for a corrupt code.  libtiff takes a
// file whose first strip's first byte is 0 and whose second has bit 0 set
// for old-style codes (LZWPreDecode): the caller then decodes every strip
// with tiff_lzw_decode_compat.
long long tiff_lzw_decode(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
    static thread_local int prefix[4096];
    static thread_local u8 suffix[4096], first[4096];
    static thread_local int length[4096];
    for (int i = 0; i < 256; i++) {
        prefix[i] = -1;
        suffix[i] = first[i] = u8(i);
        length[i] = 1;
    }
    long long pos = 0, out = 0;
    uint32_t acc = 0;
    int nacc = 0, nbits = kBitsMin, free_ent = kFirst, old = -1;
    auto next = [&]() -> int {
        while (nacc < nbits) {
            if (pos >= n) return -2;                 // out of data
            acc = (acc << 8) | src[pos++];
            nacc += 8;
        }
        nacc -= nbits;
        return int((acc >> nacc) & ((1u << nbits) - 1));
    };
    auto emit = [&](int code) {
        int len = length[code];
        if (out + len > cap) len = int(cap - out);   // keep what fits
        // the string of `code`, written back to front
        int c = code;
        for (int skip = length[code] - len; skip > 0; skip--) c = prefix[c];
        for (int i = len - 1; i >= 0; i--) {
            dst[out + i] = suffix[c];
            c = prefix[c];
        }
        out += len;
    };
    while (out < cap) {
        int code = next();
        if (code == -2 || code == kEoi) break;
        if (code == kClear) {
            free_ent = kFirst;
            nbits = kBitsMin;
            code = next();
            if (code == -2 || code == kEoi) break;
            if (code >= 256) return -1;
            emit(code);
            old = code;
            continue;
        }
        if (old < 0) {                               // no leading CLEAR
            if (code >= 256) return -1;
            emit(code);
            old = code;
            continue;
        }
        if (code > free_ent || free_ent >= 4096) return -1;
        int added = free_ent;
        prefix[added] = old;
        length[added] = length[old] + 1;
        first[added] = first[old];
        suffix[added] = code < free_ent ? first[code] : first[old];
        emit(code);
        free_ent++;
        if (free_ent > (1 << nbits) - 2 && nbits < kBitsMax) nbits++;
        old = code;
    }
    return out;
}

// One strip of old-style LZW codes, as libtiff's LZWDecodeCompat reads
// them: LSB first, and the code width grows one code later than in the
// new style, once the next free entry passes 2^nbits - 1.  Returns the
// bytes written (EOI, the end of the data or a full dst stop it), or -1
// for a corrupt strip: a code before the first CLEAR, a code past the
// free entry, a code after CLEAR that is not a byte.
long long tiff_lzw_decode_compat(const uint8_t* src, long long n,
                                 uint8_t* dst, long long cap) {
    static thread_local int prefix[4096 + 1024];
    static thread_local u8 suffix[4096 + 1024], first[4096 + 1024];
    static thread_local int length[4096 + 1024];
    constexpr int kSize = 4096 + 1024;              // tif_lzw.c CSIZE
    for (int i = 0; i < 256; i++) {
        prefix[i] = -1;
        suffix[i] = first[i] = u8(i);
        length[i] = 1;
    }
    for (int i = 256; i < kSize; i++) length[i] = 0;
    long long pos = 0, out = 0;
    uint64_t acc = 0;
    int nacc = 0, nbits = kBitsMin, free_ent = kFirst, old = -1;
    int maxcode = (1 << kBitsMin) - 1;
    auto next = [&]() -> int {
        if ((n - pos) * 8 + nacc < nbits) return -2;   // out of data
        while (nacc < nbits) {
            acc |= uint64_t(src[pos++]) << nacc;
            nacc += 8;
        }
        int code = int(acc & ((1u << nbits) - 1));
        acc >>= nbits;
        nacc -= nbits;
        return code;
    };
    auto emit = [&](int code) {
        int len = length[code];
        if (out + len > cap) len = int(cap - out);
        int c = code;
        for (int skip = length[code] - len; skip > 0; skip--) c = prefix[c];
        for (int i = len - 1; i >= 0; i--) {
            dst[out + i] = suffix[c];
            c = prefix[c];
        }
        out += len;
    };
    while (out < cap) {
        int code = next();
        if (code == -2 || code == kEoi) break;
        if (code == kClear) {
            do {
                free_ent = kFirst;
                for (int i = kFirst; i < kSize; i++) length[i] = 0;
                nbits = kBitsMin;
                maxcode = (1 << kBitsMin) - 1;
                code = next();
            } while (code == kClear);
            if (code == -2 || code == kEoi) break;
            if (code > kClear) return -1;
            emit(code);
            old = code;
            continue;
        }
        // no CLEAR yet, or the table full: a corrupt table
        if (old < 0 || free_ent >= kSize) return -1;
        // the new entry: the previous string and the first byte of this
        // one (of the previous one where the code is the entry itself)
        prefix[free_ent] = old;
        length[free_ent] = length[old] + 1;
        first[free_ent] = first[old];
        suffix[free_ent] = code < free_ent ? first[code] : first[old];
        if (++free_ent > maxcode) {
            if (++nbits > kBitsMax) nbits = kBitsMax;
            maxcode = (1 << nbits) - 1;
        }
        old = code;
        if (code >= 256 && length[code] == 0) return -1;
        emit(code);
    }
    return out;
}

// One PackBits strip into dst (cap bytes); returns the bytes written.
long long tiff_packbits_decode(const uint8_t* src, long long n, uint8_t* dst,
                               long long cap) {
    long long pos = 0, out = 0;
    while (pos < n && out < cap) {
        int c = int8_t(src[pos++]);
        if (c >= 0) {                                // c + 1 literal bytes
            long long k = c + 1;
            if (k > n - pos) k = n - pos;
            if (k > cap - out) k = cap - out;
            std::memcpy(dst + out, src + pos, size_t(k));
            pos += c + 1;
            out += k;
        } else if (c != -128) {                      // 1 - c copies
            if (pos >= n) break;
            long long k = 1 - c;
            if (k > cap - out) k = cap - out;
            std::memset(dst + out, src[pos++], size_t(k));
            out += k;
        }
    }
    return out;
}

// One strip's bytes (the horizontal predictor already applied) as
// libtiff's LZWEncode / LZWPostEncode writes them: a CLEAR first, a
// CLEAR when the table is full or when the compression ratio, checked
// every 10000 input bytes, stops rising, and EOI last.  Returns the bytes
// written to dst (cap bytes; 2 + n * 3 / 2 always suffice), or -1.
long long tiff_lzw_encode(const uint8_t* src, long long n, uint8_t* dst,
                          long long cap) {
    constexpr long kCheckGap = 10000;
    std::vector<int16_t> child(size_t(4096) * 256, -1);
    std::vector<int> used;
    used.reserve(4096);
    long long op = 0;
    uint64_t nextdata = 0;
    long nextbits = 0;
    int nbits = kBitsMin, maxcode = (1 << kBitsMin) - 1, free_ent = kFirst;
    long incount = 0, outcount = 0, checkpoint = kCheckGap, ratio = 0;
    bool overflow = false;
    auto put = [&](int code) {                       // PutNextCode
        nextdata = (nextdata << nbits) | uint64_t(code);
        nextbits += nbits;
        while (nextbits >= 8) {
            if (op < cap) dst[op] = u8(nextdata >> (nextbits - 8));
            else overflow = true;
            op++;
            nextbits -= 8;
        }
        outcount += nbits;
    };
    auto reset = [&]() {                             // cl_hash and state
        for (int i : used) child[size_t(i)] = -1;
        used.clear();
        ratio = 0;
        incount = 0;
        outcount = 0;
        free_ent = kFirst;
        put(kClear);
        nbits = kBitsMin;
        maxcode = (1 << kBitsMin) - 1;
    };
    if (n > 0) {
        put(kClear);
        int ent = src[0];
        incount = 1;
        for (long long i = 1; i < n; i++) {
            int c = src[i];
            incount++;
            size_t key = size_t(ent) * 256 + size_t(c);
            if (child[key] >= 0) {
                ent = child[key];
                continue;
            }
            put(ent);
            ent = c;
            child[key] = int16_t(free_ent++);
            used.push_back(int(key));
            if (free_ent == kCodeMax - 1) {
                reset();
            } else if (free_ent > maxcode) {
                nbits++;
                maxcode = (1 << nbits) - 1;
            } else if (incount >= checkpoint) {
                checkpoint = incount + kCheckGap;
                long rat = incount > 0x007fffff
                               ? ((outcount >> 8) == 0 ? 0x7fffffff
                                                       : incount / (outcount >> 8))
                               : (incount << 8) / outcount;
                if (rat <= ratio) reset();
                else ratio = rat;
            }
        }
        put(ent);                                    // LZWPostEncode
        free_ent++;
        if (free_ent == kCodeMax - 1) {
            put(kClear);
            nbits = kBitsMin;
        } else if (free_ent > maxcode) {
            nbits++;
        }
    }
    put(kEoi);
    if (nextbits > 0) {
        if (op < cap) dst[op] = u8((nextdata << (8 - nextbits)) & 0xFF);
        else overflow = true;
        op++;
    }
    return overflow ? -1 : op;
}

}  // extern "C"
