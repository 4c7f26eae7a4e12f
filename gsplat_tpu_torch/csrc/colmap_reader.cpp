// Native COLMAP points3D.bin parser (ctypes ABI).
//
// The reference parses COLMAP binaries in Python with one fid.read per
// scalar (reference utils.py:73-294); multi-million-point scenes take
// seconds.  This parser walks the whole buffer once.  Built at first use
// with the system C++ compiler (ops/cuda_build.load_host_library) and
// loaded by utils/colmap.py through ctypes.
//
// Format (colmap src/base/reconstruction.cc WritePoints3DBinary):
//   uint64 n_points
//   per point: uint64 id, 3x double xyz, 3x uint8 rgb, double error,
//              uint64 track_len, track_len x (int32 image_id, int32 idx)

#include <cstdint>
#include <cstring>

namespace {

inline bool read_u64(const char*& p, const char* end, uint64_t& v) {
    if (p + 8 > end) return false;
    std::memcpy(&v, p, 8);
    p += 8;
    return true;
}

}  // namespace

extern "C" {

// Returns the number of points, or -1 on malformed input.
long long count_points3d(const char* buf, long long len) {
    const char* p = buf;
    const char* end = buf + len;
    uint64_t n;
    if (!read_u64(p, end, n)) return -1;
    // validate by walking the records
    for (uint64_t i = 0; i < n; ++i) {
        if (end - p < 8 + 24 + 3 + 8) return -1;
        p += 8 + 24 + 3 + 8;  // id + xyz + rgb + error
        uint64_t track;
        if (!read_u64(p, end, track)) return -1;
        // guard against pointer overflow past `end` on corrupt track lengths
        if (track > static_cast<uint64_t>(end - p) / 8) return -1;
        p += 8 * track;
    }
    return static_cast<long long>(n);
}

// Fills caller-allocated arrays: pos (n,3) f32, rgb (n,3) u8,
// err (n,) f64, ids (n,) i64.  Returns 0 on success.
int parse_points3d(const char* buf, long long len, float* pos, uint8_t* rgb,
                   double* err, long long* ids) {
    const char* p = buf;
    const char* end = buf + len;
    uint64_t n;
    if (!read_u64(p, end, n)) return 1;
    for (uint64_t i = 0; i < n; ++i) {
        if (p + 8 + 24 + 3 + 8 + 8 > end) return 1;
        uint64_t id;
        std::memcpy(&id, p, 8);
        p += 8;
        double xyz[3];
        std::memcpy(xyz, p, 24);
        p += 24;
        pos[i * 3 + 0] = static_cast<float>(xyz[0]);
        pos[i * 3 + 1] = static_cast<float>(xyz[1]);
        pos[i * 3 + 2] = static_cast<float>(xyz[2]);
        rgb[i * 3 + 0] = static_cast<uint8_t>(p[0]);
        rgb[i * 3 + 1] = static_cast<uint8_t>(p[1]);
        rgb[i * 3 + 2] = static_cast<uint8_t>(p[2]);
        p += 3;
        std::memcpy(&err[i], p, 8);
        p += 8;
        ids[i] = static_cast<long long>(id);
        uint64_t track;
        std::memcpy(&track, p, 8);
        p += 8;
        if (track > static_cast<uint64_t>(end - p) / 8) return 1;
        p += 8 * track;
    }
    return 0;
}

}  // extern "C"
