// WebP codec (ctypes ABI) for utils/image_io.py, which parses the RIFF
// container itself: the VP8L lossless bitstream (RFC 9649 section 3), the
// VP8 key frame (RFC 6386) and the ALPH chunk, each decoded as libwebp's
// default decoding path decodes it (the one cv2.imread takes): prefix codes,
// color cache, meta prefix codes, LZ77 and the four transforms; the boolean
// decoder, segments, token partitions, intra prediction, the inverse DCT and
// WHT, the simple and normal loop filters, then fancy upsampling of chroma
// and the YUV -> RGB conversion in libwebp's 14-bit fixed point.  Errors
// stop where libwebp's would (a stream that reads past its end, an
// incomplete prefix code, a backward reference out of the image, a bad ALPH
// header).  webp_encode_vp8l writes a small lossless encoder's bitstream:
// subtract-green, a predictor a 32x32 tile, prefix codes from histograms and
// LZ77 against the pixel to the left and the one above.
// Built at first use with the system C++ compiler
// (ops/cuda_build.load_host_library); the tables come from the block that
// tests/torch_make_webp_tables.py generates.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <vector>

namespace {

using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using u64 = uint64_t;

// BEGIN GENERATED TABLES
// tests/torch_make_webp_tables.py: the system libwebp.a's decoder tables,
// checked against the RFCs' first and last rows.  Do not edit.
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
    69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143,
    145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173, 177,
    181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239,
    245, 249, 254, 259, 264, 269, 274, 279, 284,
};
const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
            {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
            {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}
        },
        {
            {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
            {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
            {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}
        },
        {
            {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
            {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
            {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}
        },
        {
            {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
            {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
            {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}
        },
        {
            {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
            {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
            {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}
        },
        {
            {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
            {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
            {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}
        },
        {
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}
        }
    },
    {
        {
            {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
            {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
            {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}
        },
        {
            {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
            {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
            {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}
        },
        {
            {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
            {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
            {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}
        },
        {
            {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
            {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
            {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}
        },
        {
            {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
            {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
            {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}
        },
        {
            {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
            {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
            {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}
        },
        {
            {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
            {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
            {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}
        },
        {
            {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
            {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}
        }
    },
    {
        {
            {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
            {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
            {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}
        },
        {
            {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
            {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
            {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}
        },
        {
            {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
            {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
            {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}
        },
        {
            {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
            {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
            {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}
        },
        {
            {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
            {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
            {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
            {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        },
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}
        }
    },
    {
        {
            {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
            {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
            {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}
        },
        {
            {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
            {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
            {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}
        },
        {
            {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
            {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
            {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}
        },
        {
            {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
            {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
            {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}
        },
        {
            {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
            {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
            {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}
        },
        {
            {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
            {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
            {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}
        },
        {
            {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
            {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
            {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}
        },
        {
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}
        }
    }
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
            {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    },
    {
        {
            {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
            {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    },
    {
        {
            {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
            {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    },
    {
        {
            {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}
        }
    }
};
const uint8_t kBModesProba[10][10][9] = {
    {
        {231, 120, 48, 89, 115, 113, 120, 152, 112},
        {152, 179, 64, 126, 170, 118, 46, 70, 95},
        {175, 69, 143, 80, 85, 82, 72, 155, 103},
        {56, 58, 10, 171, 218, 189, 17, 13, 152},
        {114, 26, 17, 163, 44, 195, 21, 10, 173},
        {121, 24, 80, 195, 26, 62, 44, 64, 85},
        {144, 71, 10, 38, 171, 213, 144, 34, 26},
        {170, 46, 55, 19, 136, 160, 33, 206, 71},
        {63, 20, 8, 114, 114, 208, 12, 9, 226},
        {81, 40, 11, 96, 182, 84, 29, 16, 36}
    },
    {
        {134, 183, 89, 137, 98, 101, 106, 165, 148},
        {72, 187, 100, 130, 157, 111, 32, 75, 80},
        {66, 102, 167, 99, 74, 62, 40, 234, 128},
        {41, 53, 9, 178, 241, 141, 26, 8, 107},
        {74, 43, 26, 146, 73, 166, 49, 23, 157},
        {65, 38, 105, 160, 51, 52, 31, 115, 128},
        {104, 79, 12, 27, 217, 255, 87, 17, 7},
        {87, 68, 71, 44, 114, 51, 15, 186, 23},
        {47, 41, 14, 110, 182, 183, 21, 17, 194},
        {66, 45, 25, 102, 197, 189, 23, 18, 22}
    },
    {
        {88, 88, 147, 150, 42, 46, 45, 196, 205},
        {43, 97, 183, 117, 85, 38, 35, 179, 61},
        {39, 53, 200, 87, 26, 21, 43, 232, 171},
        {56, 34, 51, 104, 114, 102, 29, 93, 77},
        {39, 28, 85, 171, 58, 165, 90, 98, 64},
        {34, 22, 116, 206, 23, 34, 43, 166, 73},
        {107, 54, 32, 26, 51, 1, 81, 43, 31},
        {68, 25, 106, 22, 64, 171, 36, 225, 114},
        {34, 19, 21, 102, 132, 188, 16, 76, 124},
        {62, 18, 78, 95, 85, 57, 50, 48, 51}
    },
    {
        {193, 101, 35, 159, 215, 111, 89, 46, 111},
        {60, 148, 31, 172, 219, 228, 21, 18, 111},
        {112, 113, 77, 85, 179, 255, 38, 120, 114},
        {40, 42, 1, 196, 245, 209, 10, 25, 109},
        {88, 43, 29, 140, 166, 213, 37, 43, 154},
        {61, 63, 30, 155, 67, 45, 68, 1, 209},
        {100, 80, 8, 43, 154, 1, 51, 26, 71},
        {142, 78, 78, 16, 255, 128, 34, 197, 171},
        {41, 40, 5, 102, 211, 183, 4, 1, 221},
        {51, 50, 17, 168, 209, 192, 23, 25, 82}
    },
    {
        {138, 31, 36, 171, 27, 166, 38, 44, 229},
        {67, 87, 58, 169, 82, 115, 26, 59, 179},
        {63, 59, 90, 180, 59, 166, 93, 73, 154},
        {40, 40, 21, 116, 143, 209, 34, 39, 175},
        {47, 15, 16, 183, 34, 223, 49, 45, 183},
        {46, 17, 33, 183, 6, 98, 15, 32, 183},
        {57, 46, 22, 24, 128, 1, 54, 17, 37},
        {65, 32, 73, 115, 28, 128, 23, 128, 205},
        {40, 3, 9, 115, 51, 192, 18, 6, 223},
        {87, 37, 9, 115, 59, 77, 64, 21, 47}
    },
    {
        {104, 55, 44, 218, 9, 54, 53, 130, 226},
        {64, 90, 70, 205, 40, 41, 23, 26, 57},
        {54, 57, 112, 184, 5, 41, 38, 166, 213},
        {30, 34, 26, 133, 152, 116, 10, 32, 134},
        {39, 19, 53, 221, 26, 114, 32, 73, 255},
        {31, 9, 65, 234, 2, 15, 1, 118, 73},
        {75, 32, 12, 51, 192, 255, 160, 43, 51},
        {88, 31, 35, 67, 102, 85, 55, 186, 85},
        {56, 21, 23, 111, 59, 205, 45, 37, 192},
        {55, 38, 70, 124, 73, 102, 1, 34, 98}
    },
    {
        {125, 98, 42, 88, 104, 85, 117, 175, 82},
        {95, 84, 53, 89, 128, 100, 113, 101, 45},
        {75, 79, 123, 47, 51, 128, 81, 171, 1},
        {57, 17, 5, 71, 102, 57, 53, 41, 49},
        {38, 33, 13, 121, 57, 73, 26, 1, 85},
        {41, 10, 67, 138, 77, 110, 90, 47, 114},
        {115, 21, 2, 10, 102, 255, 166, 23, 6},
        {101, 29, 16, 10, 85, 128, 101, 196, 26},
        {57, 18, 10, 102, 102, 213, 34, 20, 43},
        {117, 20, 15, 36, 163, 128, 68, 1, 26}
    },
    {
        {102, 61, 71, 37, 34, 53, 31, 243, 192},
        {69, 60, 71, 38, 73, 119, 28, 222, 37},
        {68, 45, 128, 34, 1, 47, 11, 245, 171},
        {62, 17, 19, 70, 146, 85, 55, 62, 70},
        {37, 43, 37, 154, 100, 163, 85, 160, 1},
        {63, 9, 92, 136, 28, 64, 32, 201, 85},
        {75, 15, 9, 9, 64, 255, 184, 119, 16},
        {86, 6, 28, 5, 64, 255, 25, 248, 1},
        {56, 8, 17, 132, 137, 255, 55, 116, 128},
        {58, 15, 20, 82, 135, 57, 26, 121, 40}
    },
    {
        {164, 50, 31, 137, 154, 133, 25, 35, 218},
        {51, 103, 44, 131, 131, 123, 31, 6, 158},
        {86, 40, 64, 135, 148, 224, 45, 183, 128},
        {22, 26, 17, 131, 240, 154, 14, 1, 209},
        {45, 16, 21, 91, 64, 222, 7, 1, 197},
        {56, 21, 39, 155, 60, 138, 23, 102, 213},
        {83, 12, 13, 54, 192, 255, 68, 47, 28},
        {85, 26, 85, 85, 128, 128, 32, 146, 171},
        {18, 11, 7, 63, 144, 171, 4, 4, 246},
        {35, 27, 10, 146, 174, 171, 12, 26, 128}
    },
    {
        {190, 80, 35, 99, 180, 80, 126, 54, 45},
        {85, 126, 47, 87, 176, 51, 41, 20, 32},
        {101, 75, 128, 139, 118, 146, 116, 128, 85},
        {56, 41, 15, 176, 236, 85, 37, 9, 62},
        {71, 30, 17, 119, 118, 255, 17, 18, 138},
        {101, 38, 60, 138, 55, 70, 43, 26, 142},
        {146, 36, 19, 30, 171, 255, 97, 27, 20},
        {138, 45, 61, 62, 219, 1, 81, 188, 64},
        {32, 41, 20, 117, 151, 142, 20, 21, 163},
        {112, 19, 12, 61, 195, 128, 48, 4, 24}
    }
};
const int8_t kYModesIntra4[18] = {
    0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9,
};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kZigzag[16] = {
    0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15,
};
const uint8_t kCat3[4] = {173, 148, 140, 0};
const uint8_t kCat4[5] = {176, 155, 140, 135, 0};
const uint8_t kCat5[6] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[12] = {
    254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0,
};
const uint8_t kCodeLengthCodeOrder[19] = {
    17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54,
    58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52,
    60, 3, 87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2,
    103, 105, 18, 30, 102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120,
    1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78, 118, 122, 33, 47, 117, 123,
    49, 63, 99, 109, 82, 94, 0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115,
    125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};
// END GENERATED TABLES

struct Fail {
    const char* msg;
};

[[noreturn]] void fail(const char* msg) { throw Fail{msg}; }

inline int floor_log2(u32 v) { return 31 ^ __builtin_clz(v); }

// ================================================================== VP8L

// LSB-first bit reader; reads past the end give zeros.  libwebp's reader
// holds a 64-bit window, so a stream of fewer than 8 bytes may be read up
// to 64 bits before it counts as overrun (VP8LIsEndOfStream).
class LBits {
  public:
    LBits(const u8* buf, size_t len)
        : buf_(buf), len_(len), limit_(8 * u64(std::max<size_t>(len, 8))) {}
    u64 window() const {
        size_t i = size_t(pos_ >> 3);
        u64 v = 0;
        if (i + 8 <= len_) {
            std::memcpy(&v, buf_ + i, 8);
        } else {
            for (size_t k = 0; k < 8 && i + k < len_; k++)
                v |= u64(buf_[i + k]) << (8 * k);
        }
        return v >> (pos_ & 7);
    }
    u32 read(int n) {
        u32 v = n ? u32(window() & ((u64(1) << n) - 1)) : 0;
        pos_ += u64(n);
        return v;
    }
    void skip(int n) { pos_ += u64(n); }
    bool eos() const { return pos_ > limit_; }

  private:
    const u8* buf_;
    size_t len_;
    u64 limit_;
    u64 pos_ = 0;
};

constexpr int kRootBits = 8;
constexpr int kMaxLength = 15;

// One canonical prefix code (VP8LBuildHuffmanTable's rules: at least one
// symbol; one symbol reads no bits; more must form a complete code).
struct PrefixCode {
    int single = -1;
    std::vector<u16> root;          // (symbol << 4) | length; 0: longer code
    int count[kMaxLength + 1] = {0};
    std::vector<u16> sorted;

    bool build(const int* lengths, int n) {
        int nonzero = 0, last = 0;
        std::fill(count, count + kMaxLength + 1, 0);
        for (int s = 0; s < n; s++) {
            if (lengths[s] > kMaxLength) return false;
            count[lengths[s]]++;
            if (lengths[s]) {
                nonzero++;
                last = s;
            }
        }
        if (nonzero == 0) return false;
        if (nonzero == 1) {
            single = last;
            return true;
        }
        int left = 1;
        for (int len = 1; len <= kMaxLength; len++) {
            left = 2 * left - count[len];
            if (left < 0) return false;
        }
        if (left != 0) return false;
        single = -1;
        int offset[kMaxLength + 2] = {0};
        for (int len = 1; len <= kMaxLength; len++)
            offset[len + 1] = offset[len] + count[len];
        sorted.assign(size_t(nonzero), 0);
        int next[kMaxLength + 1] = {0};
        for (int len = 1; len <= kMaxLength; len++) next[len] = offset[len];
        for (int s = 0; s < n; s++)
            if (lengths[s]) sorted[size_t(next[lengths[s]]++)] = u16(s);
        root.assign(size_t(1) << kRootBits, 0);
        int code = 0, k = 0;
        for (int len = 1; len <= kMaxLength; len++) {
            for (int i = 0; i < count[len]; i++, k++, code++) {
                if (len > kRootBits) continue;
                int rev = 0;
                for (int b = 0; b < len; b++)
                    rev |= ((code >> b) & 1) << (len - 1 - b);
                for (int idx = rev; idx < (1 << kRootBits); idx += 1 << len)
                    root[size_t(idx)] = u16((sorted[size_t(k)] << 4) | len);
            }
            code <<= 1;
        }
        return true;
    }

    int read(LBits& br) const {
        if (single >= 0) return single;
        u32 bits = u32(br.window());
        u16 e = root[bits & ((1u << kRootBits) - 1)];
        if (e) {
            br.skip(e & 15);
            return e >> 4;
        }
        int code = 0, first = 0, index = 0;
        for (int len = 1; len <= kMaxLength; len++) {
            code |= int((bits >> (len - 1)) & 1);
            if (code - count[len] < first) {
                br.skip(len);
                return sorted[size_t(index + code - first)];
            }
            index += count[len];
            first += count[len];
            first <<= 1;
            code <<= 1;
        }
        fail("corrupt VP8L prefix code");
    }
};

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kAlphabet[5] = {kNumLiteral + kNumLength, 256, 256, 256,
                              kNumDistance};

struct Group {
    PrefixCode code[5];   // green (+ lengths + cache), red, blue, alpha, dist
};

inline int subsample(int size, int bits) {
    return (size + (1 << bits) - 1) >> bits;
}

struct Transform {
    int type, bits, xsize;
    std::vector<u32> data;
};

enum { kPredictor = 0, kCrossColor = 1, kSubtractGreen = 2,
       kColorIndexing = 3 };

class VP8LDecoder {
  public:
    VP8LDecoder(const u8* data, size_t n) : br_(data, n) {}

    // The main image of a VP8L chunk (its 5-byte header first), as ARGB.
    std::vector<u32> decode_image(int* width, int* height) {
        if (br_.read(8) != 0x2f) fail("not a VP8L bitstream");
        *width = int(br_.read(14)) + 1;
        *height = int(br_.read(14)) + 1;
        br_.read(1);
        if (br_.read(3) != 0) fail("unknown VP8L version");
        return decode_level0(*width, *height, false);
    }

    // An ALPH chunk's lossless stream (no header): the alpha plane.
    void decode_alpha(int width, int height, u8* alpha) {
        std::vector<u32> argb = decode_level0(width, height, true);
        for (size_t i = 0; i < argb.size(); i++) alpha[i] = u8(argb[i] >> 8);
    }

  private:
    LBits br_;
    std::vector<Transform> transforms_;
    unsigned seen_ = 0;

    std::vector<u32> decode_level0(int width, int height, bool alpha) {
        int xsize = width;
        while (br_.read(1)) read_transform(&xsize, height);
        int cache_bits = read_cache_bits();
        std::vector<Group> groups;
        std::vector<u32> meta;
        int meta_bits = 0;
        read_codes(xsize, height, cache_bits, true, &groups, &meta,
                   &meta_bits);
        // libwebp decodes an alpha plane that has only a color-indexing
        // transform, no cache and single-symbol red, blue and alpha codes
        // with DecodeAlphaData, which forgives a final symbol read past the
        // end of the data
        bool alpha8b = alpha && transforms_.size() == 1 &&
                       transforms_[0].type == kColorIndexing &&
                       cache_bits == 0;
        for (const Group& g : groups)
            alpha8b = alpha8b && g.code[1].single >= 0 &&
                      g.code[2].single >= 0 && g.code[3].single >= 0;
        std::vector<u32> px(size_t(xsize) * size_t(height));
        decode_pixels(px.data(), xsize, height, groups, meta, meta_bits,
                      cache_bits, alpha8b);
        for (size_t t = transforms_.size(); t-- > 0;)
            px = inverse(transforms_[t], px, height);
        return px;
    }

    int read_cache_bits() {
        if (!br_.read(1)) return 0;
        int bits = int(br_.read(4));
        if (bits < 1 || bits > 11) fail("bad VP8L color cache size");
        return bits;
    }

    // A sub-image (transform data, the meta prefix image): no transforms,
    // no meta codes.
    std::vector<u32> decode_sub_image(int xsize, int ysize) {
        int cache_bits = read_cache_bits();
        std::vector<Group> groups;
        std::vector<u32> meta;
        int meta_bits = 0;
        read_codes(xsize, ysize, cache_bits, false, &groups, &meta,
                   &meta_bits);
        std::vector<u32> px(size_t(xsize) * size_t(ysize));
        decode_pixels(px.data(), xsize, ysize, groups, meta, meta_bits,
                      cache_bits, false);
        if (br_.eos()) fail("VP8L data ends early");
        return px;
    }

    void read_transform(int* xsize, int ysize) {
        int type = int(br_.read(2));
        if (seen_ & (1u << type)) fail("VP8L transform used twice");
        seen_ |= 1u << type;
        Transform t{type, 0, *xsize, {}};
        if (type == kPredictor || type == kCrossColor) {
            t.bits = int(br_.read(3)) + 2;
            t.data = decode_sub_image(subsample(t.xsize, t.bits),
                                      subsample(ysize, t.bits));
        } else if (type == kColorIndexing) {
            int num_colors = int(br_.read(8)) + 1;
            t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1
                     : num_colors > 2 ? 2 : 3;
            *xsize = subsample(t.xsize, t.bits);
            std::vector<u32> pal = decode_sub_image(num_colors, 1);
            // ExpandColorMap: delta-coded entries, zeros past the palette
            std::vector<u32> map(size_t(1) << (8 >> t.bits), 0);
            map[0] = pal[0];
            const u8* d = reinterpret_cast<const u8*>(pal.data());
            u8* m = reinterpret_cast<u8*>(map.data());
            for (int i = 4; i < 4 * num_colors; i++) m[i] = u8(d[i] + m[i - 4]);
            t.data = std::move(map);
        }
        transforms_.push_back(std::move(t));
    }

    void read_codes(int xsize, int ysize, int cache_bits, bool allow_meta,
                    std::vector<Group>* groups, std::vector<u32>* meta,
                    int* meta_bits) {
        int num_groups = 1;
        if (allow_meta && br_.read(1)) {
            *meta_bits = int(br_.read(3)) + 2;
            int mx = subsample(xsize, *meta_bits);
            int my = subsample(ysize, *meta_bits);
            *meta = decode_sub_image(mx, my);
            for (u32& v : *meta) {
                v = (v >> 8) & 0xffff;
                num_groups = std::max(num_groups, int(v) + 1);
            }
        }
        if (br_.eos()) fail("VP8L data ends early");
        // every group is read; only the ones the meta image names are kept
        std::vector<char> used(size_t(num_groups), meta->empty() ? 1 : 0);
        for (u32 v : *meta) used[v] = 1;
        groups->resize(size_t(num_groups));
        int cache_size = cache_bits ? 1 << cache_bits : 0;
        std::vector<int> lengths(kNumLiteral + kNumLength + 2048);
        for (int g = 0; g < num_groups; g++) {
            for (int j = 0; j < 5; j++) {
                int size = kAlphabet[j] + (j == 0 ? cache_size : 0);
                PrefixCode scratch;
                PrefixCode& code = used[size_t(g)] ? (*groups)[size_t(g)].code[j]
                                                   : scratch;
                read_code(size, lengths.data(), &code);
            }
        }
    }

    void read_code(int size, int* lengths, PrefixCode* code) {
        std::fill(lengths, lengths + size, 0);
        if (br_.read(1)) {                                  // simple code
            int num = int(br_.read(1)) + 1;
            int first8 = int(br_.read(1));
            int s = int(br_.read(first8 ? 8 : 1));
            if (s < size) lengths[s] = 1;
            if (num == 2) {
                s = int(br_.read(8));
                if (s < size) lengths[s] = 1;
            }
        } else {
            int cl_lengths[19] = {0};
            int num = int(br_.read(4)) + 4;
            for (int i = 0; i < num; i++)
                cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
            read_code_lengths(cl_lengths, size, lengths);
        }
        if (br_.eos() || !code->build(lengths, size))
            fail("corrupt VP8L prefix code");
    }

    void read_code_lengths(const int* cl_lengths, int size, int* lengths) {
        PrefixCode cl;
        if (!cl.build(cl_lengths, 19)) fail("corrupt VP8L code length code");
        int max_symbol = size;
        if (br_.read(1)) {
            int nbits = 2 + 2 * int(br_.read(3));
            max_symbol = 2 + int(br_.read(nbits));
            if (max_symbol > size) fail("corrupt VP8L code lengths");
        }
        int prev = 8;
        for (int s = 0; s < size;) {
            if (max_symbol-- == 0) break;
            int c = cl.read(br_);
            if (c < 16) {
                lengths[s++] = c;
                if (c) prev = c;
            } else {
                static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
                int repeat = int(br_.read(extra[c - 16])) + offset[c - 16];
                if (s + repeat > size) fail("corrupt VP8L code lengths");
                int len = c == 16 ? prev : 0;
                while (repeat-- > 0) lengths[s++] = len;
            }
        }
    }

    int prefix_value(int sym) {
        if (sym < 4) return sym + 1;
        int extra = (sym - 2) >> 1;
        int offset = (2 + (sym & 1)) << extra;
        return offset + int(br_.read(extra)) + 1;
    }

    static int plane_distance(int xsize, int code) {
        if (code > 120) return code - 120;
        int v = kCodeToPlane[code - 1];
        int dist = (v >> 4) * xsize + (8 - (v & 0xf));
        return dist >= 1 ? dist : 1;
    }

    void decode_pixels(u32* out, int width, int height,
                       const std::vector<Group>& groups,
                       const std::vector<u32>& meta, int meta_bits,
                       int cache_bits, bool forgive_final_overrun) {
        const size_t total = size_t(width) * size_t(height);
        const int meta_x = meta.empty() ? 0 : subsample(width, meta_bits);
        std::vector<u32> cache(cache_bits ? size_t(1) << cache_bits : 0);
        const int shift = 32 - cache_bits;
        size_t pos = 0, cached = 0;
        int x = 0, y = 0;
        while (pos < total) {
            const Group& g = meta.empty() ? groups[0]
                : groups[meta[size_t((y >> meta_bits) * meta_x
                                     + (x >> meta_bits))]];
            int code = g.code[0].read(br_);
            size_t n = 1;
            if (code < kNumLiteral) {
                u32 r = u32(g.code[1].read(br_));
                u32 b = u32(g.code[2].read(br_));
                u32 a = u32(g.code[3].read(br_));
                out[pos] = (a << 24) | (r << 16) | (u32(code) << 8) | b;
            } else if (code < kNumLiteral + kNumLength) {
                n = size_t(prefix_value(code - kNumLiteral));
                int dsym = g.code[4].read(br_);
                size_t dist = size_t(plane_distance(width, prefix_value(dsym)));
                if (br_.eos()) break;
                if (pos < dist || total - pos < n)
                    fail("VP8L backward reference out of the image");
                for (size_t k = 0; k < n; k++) out[pos + k] = out[pos + k - dist];
            } else {
                for (; cached < pos; cached++)
                    cache[(out[cached] * 0x1e35a7bdu) >> shift] = out[cached];
                out[pos] = cache[size_t(code - kNumLiteral - kNumLength)];
            }
            pos += n;
            x += int(n);
            while (x >= width) {
                x -= width;
                y++;
            }
            if (br_.eos() && !(forgive_final_overrun && pos == total)) break;
        }
        if (br_.eos() && !(forgive_final_overrun && pos == total))
            fail("VP8L data ends early");
    }

    static u32 add(u32 a, u32 b) {
        return (((a & 0xff00ff00u) + (b & 0xff00ff00u)) & 0xff00ff00u) |
               (((a & 0x00ff00ffu) + (b & 0x00ff00ffu)) & 0x00ff00ffu);
    }
    static u32 avg2(u32 a, u32 b) {
        return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
    }
    static int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
    static u32 select(u32 t, u32 l, u32 tl) {
        int d = 0;
        for (int s = 0; s < 32; s += 8) {
            int a = int((t >> s) & 0xff), b = int((l >> s) & 0xff),
                c = int((tl >> s) & 0xff);
            d += std::abs(b - c) - std::abs(a - c);
        }
        return d <= 0 ? t : l;
    }
    static u32 add_sub_full(u32 a, u32 b, u32 c) {
        u32 out = 0;
        for (int s = 0; s < 32; s += 8)
            out |= u32(clip255(int((a >> s) & 0xff) + int((b >> s) & 0xff)
                               - int((c >> s) & 0xff))) << s;
        return out;
    }
    static u32 add_sub_half(u32 a, u32 b) {
        u32 out = 0;
        for (int s = 0; s < 32; s += 8) {
            int x = int((a >> s) & 0xff), y = int((b >> s) & 0xff);
            out |= u32(clip255(x + (x - y) / 2)) << s;
        }
        return out;
    }

  public:
    static u32 predict(int mode, u32 L, u32 T, u32 TL, u32 TR) {
        switch (mode) {
            case 1: return L;
            case 2: return T;
            case 3: return TR;
            case 4: return TL;
            case 5: return avg2(avg2(L, TR), T);
            case 6: return avg2(L, TL);
            case 7: return avg2(L, T);
            case 8: return avg2(TL, T);
            case 9: return avg2(T, TR);
            case 10: return avg2(avg2(L, TL), avg2(T, TR));
            case 11: return select(T, L, TL);
            case 12: return add_sub_full(L, T, TL);
            case 13: return add_sub_half(avg2(L, T), TL);
            default: return 0xff000000u;
        }
    }

  private:
    static std::vector<u32> inverse(const Transform& t, std::vector<u32>& in,
                                    int height) {
        const int w = t.xsize;
        if (t.type == kSubtractGreen) {
            for (u32& p : in) {
                u32 g = (p >> 8) & 0xff;
                p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) |
                    ((p + g) & 0xff);
            }
            return std::move(in);
        }
        if (t.type == kCrossColor) {
            const int tiles = subsample(w, t.bits);
            for (int y = 0; y < height; y++) {
                for (int x = 0; x < w; x++) {
                    u32 m = t.data[size_t((y >> t.bits) * tiles + (x >> t.bits))];
                    int g2r = int(int8_t(m)), g2b = int(int8_t(m >> 8)),
                        r2b = int(int8_t(m >> 16));
                    u32& p = in[size_t(y) * size_t(w) + size_t(x)];
                    int g = int(int8_t(p >> 8));
                    int r = int((p >> 16) & 0xff) + ((g2r * g) >> 5);
                    r &= 0xff;
                    int b = int(p & 0xff) + ((g2b * g) >> 5) +
                            ((r2b * int(int8_t(r))) >> 5);
                    b &= 0xff;
                    p = (p & 0xff00ff00u) | (u32(r) << 16) | u32(b);
                }
            }
            return std::move(in);
        }
        if (t.type == kPredictor) {
            u32* p = in.data();
            const int tiles = subsample(w, t.bits);
            p[0] = add(p[0], 0xff000000u);
            for (int x = 1; x < w; x++) p[x] = add(p[x], p[x - 1]);
            for (int y = 1; y < height; y++) {
                u32* row = p + size_t(y) * size_t(w);
                const u32* up = row - w;
                const u32* modes = t.data.data() + size_t((y >> t.bits) * tiles);
                row[0] = add(row[0], up[0]);
                for (int x = 1; x < w; x++) {
                    int mode = int((modes[x >> t.bits] >> 8) & 0xf);
                    // up[w] is row[0]: the rightmost pixel's top-right is
                    // the first pixel of its own row
                    row[x] = add(row[x], predict(mode, row[x - 1], up[x],
                                                 up[x - 1], up[x + 1]));
                }
            }
            return std::move(in);
        }
        // color indexing, with pixel bundling below 17 colours
        const int packed_w = subsample(w, t.bits);
        std::vector<u32> out(size_t(w) * size_t(height));
        const int bpp = 8 >> t.bits, per = 1 << t.bits;
        const u32 mask = (1u << bpp) - 1;
        for (int y = 0; y < height; y++) {
            const u32* src = in.data() + size_t(y) * size_t(packed_w);
            u32* dst = out.data() + size_t(y) * size_t(w);
            u32 packed = 0;
            for (int x = 0; x < w; x++) {
                if ((x & (per - 1)) == 0) packed = (src[x >> t.bits] >> 8) & 0xff;
                dst[x] = t.data[packed & mask];
                packed >>= bpp;
            }
        }
        return out;
    }
};

// ================================================================ VP8

// libwebp's boolean decoder (bit_reader_utils), one byte a load: range_ is
// the range less one; past the end, one zero byte is shifted in and eof
// set.
class BoolDecoder {
  public:
    void init(const u8* p, size_t n) {
        buf_ = p;
        end_ = p + n;
        range_ = 254;
        value_ = 0;
        bits_ = -8;
        eof_ = false;
        load();
    }
    int bit(int prob) {
        u32 range = range_;
        if (bits_ < 0) load();
        const int pos = bits_;
        const u32 split = (range * u32(prob)) >> 8;
        const u32 value = u32(value_ >> pos);
        int b = value > split;
        if (b) {
            range -= split;
            value_ -= u64(split + 1) << pos;
        } else {
            range = split + 1;
        }
        const int shift = 7 ^ floor_log2(range);
        range <<= shift;
        bits_ -= shift;
        range_ = range - 1;
        return b;
    }
    int value(int n) {
        int v = 0;
        while (n-- > 0) v |= bit(0x80) << n;
        return v;
    }
    int signed_value(int n) {
        int v = value(n);
        return value(1) ? -v : v;
    }
    bool eof() const { return eof_; }

  private:
    void load() {
        if (buf_ < end_) {
            bits_ += 8;
            value_ = (value_ << 8) | *buf_++;
        } else if (!eof_) {
            value_ <<= 8;
            bits_ += 8;
            eof_ = true;
        } else {
            bits_ = 0;
        }
    }
    const u8* buf_ = nullptr;
    const u8* end_ = nullptr;
    u64 value_ = 0;
    int bits_ = 0;
    u32 range_ = 0;
    bool eof_ = false;
};

constexpr int BPS = 32;                  // the work buffer's stride
constexpr int kYOff = BPS * 1 + 8;
constexpr int kUOff = kYOff + BPS * 16 + BPS;
constexpr int kVOff = kUOff + 16;
constexpr int kWorkSize = BPS * 17 + BPS * 9;

enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED,
       B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
       B_DC_NOTOP = 4, B_DC_NOLEFT = 5, B_DC_NOTOPLEFT = 6 };
enum { DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED };

inline u8 clip8(int v) { return u8(v < 0 ? 0 : v > 255 ? 255 : v); }

// ---- intra predictors (dsp/dec.c)
#define DST(x, y) dst[(x) + (y) * BPS]
#define AVG3(a, b, c) (u8(((a) + 2 * (b) + (c) + 2) >> 2))
#define AVG2(a, b) (((a) + (b) + 1) >> 1)

void true_motion(u8* dst, int size) {
    const u8* top = dst - BPS;
    for (int y = 0; y < size; y++) {
        for (int x = 0; x < size; x++)
            dst[x] = clip8(top[x] + dst[-1] - top[-1]);
        dst += BPS;
    }
}

void fill(u8* dst, int v, int size) {
    for (int j = 0; j < size; j++) std::memset(dst + j * BPS, v, size_t(size));
}

void pred_dc(u8* dst, int size, int mode) {
    const int log = size == 16 ? 4 : 3;
    int dc = 0;
    if (mode == B_DC_PRED) {
        for (int j = 0; j < size; j++) dc += dst[-1 + j * BPS] + dst[j - BPS];
        fill(dst, (dc + size) >> (log + 1), size);
    } else if (mode == B_DC_NOTOP) {
        for (int j = 0; j < size; j++) dc += dst[-1 + j * BPS];
        fill(dst, (dc + size / 2) >> log, size);
    } else if (mode == B_DC_NOLEFT) {
        for (int j = 0; j < size; j++) dc += dst[j - BPS];
        fill(dst, (dc + size / 2) >> log, size);
    } else {
        fill(dst, 0x80, size);
    }
}

// 16x16 luma or 8x8 chroma, modes as CheckMode gives them
void pred_block(u8* dst, int size, int mode) {
    if (mode == TM_PRED) {
        true_motion(dst, size);
    } else if (mode == V_PRED) {
        for (int j = 0; j < size; j++)
            std::memcpy(dst + j * BPS, dst - BPS, size_t(size));
    } else if (mode == H_PRED) {
        for (int j = 0; j < size; j++)
            std::memset(dst + j * BPS, dst[j * BPS - 1], size_t(size));
    } else {
        pred_dc(dst, size, mode);
    }
}

void pred4(u8* dst, int mode) {
    const u8* top = dst - BPS;
    switch (mode) {
        case B_DC_PRED: {
            u32 dc = 4;
            for (int i = 0; i < 4; i++) dc += dst[i - BPS] + dst[-1 + i * BPS];
            fill(dst, int(dc >> 3), 4);
            break;
        }
        case B_TM_PRED:
            true_motion(dst, 4);
            break;
        case B_VE_PRED: {
            const u8 vals[4] = {AVG3(top[-1], top[0], top[1]),
                                AVG3(top[0], top[1], top[2]),
                                AVG3(top[1], top[2], top[3]),
                                AVG3(top[2], top[3], top[4])};
            for (int i = 0; i < 4; i++) std::memcpy(dst + i * BPS, vals, 4);
            break;
        }
        case B_HE_PRED: {
            const int A = dst[-1 - BPS], B = dst[-1], C = dst[-1 + BPS],
                      D = dst[-1 + 2 * BPS], E = dst[-1 + 3 * BPS];
            std::memset(dst + 0 * BPS, AVG3(A, B, C), 4);
            std::memset(dst + 1 * BPS, AVG3(B, C, D), 4);
            std::memset(dst + 2 * BPS, AVG3(C, D, E), 4);
            std::memset(dst + 3 * BPS, AVG3(D, E, E), 4);
            break;
        }
        case B_RD_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                      B = top[1], C = top[2], D = top[3];
            DST(0, 3) = AVG3(J, K, L);
            DST(1, 3) = DST(0, 2) = AVG3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = AVG3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = AVG3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = AVG3(B, A, X);
            DST(3, 1) = DST(2, 0) = AVG3(C, B, A);
            DST(3, 0) = AVG3(D, C, B);
            break;
        }
        case B_LD_PRED: {
            const int A = top[0], B = top[1], C = top[2], D = top[3],
                      E = top[4], F = top[5], G = top[6], H = top[7];
            DST(0, 0) = AVG3(A, B, C);
            DST(1, 0) = DST(0, 1) = AVG3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = AVG3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = AVG3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = AVG3(E, F, G);
            DST(3, 2) = DST(2, 3) = AVG3(F, G, H);
            DST(3, 3) = AVG3(G, H, H);
            break;
        }
        case B_VR_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      X = dst[-1 - BPS], A = top[0], B = top[1], C = top[2],
                      D = top[3];
            DST(0, 0) = DST(1, 2) = u8(AVG2(X, A));
            DST(1, 0) = DST(2, 2) = u8(AVG2(A, B));
            DST(2, 0) = DST(3, 2) = u8(AVG2(B, C));
            DST(3, 0) = u8(AVG2(C, D));
            DST(0, 3) = AVG3(K, J, I);
            DST(0, 2) = AVG3(J, I, X);
            DST(0, 1) = DST(1, 3) = AVG3(I, X, A);
            DST(1, 1) = DST(2, 3) = AVG3(X, A, B);
            DST(2, 1) = DST(3, 3) = AVG3(A, B, C);
            DST(3, 1) = AVG3(B, C, D);
            break;
        }
        case B_VL_PRED: {
            const int A = top[0], B = top[1], C = top[2], D = top[3],
                      E = top[4], F = top[5], G = top[6], H = top[7];
            DST(0, 0) = u8(AVG2(A, B));
            DST(1, 0) = DST(0, 2) = u8(AVG2(B, C));
            DST(2, 0) = DST(1, 2) = u8(AVG2(C, D));
            DST(3, 0) = DST(2, 2) = u8(AVG2(D, E));
            DST(0, 1) = AVG3(A, B, C);
            DST(1, 1) = DST(0, 3) = AVG3(B, C, D);
            DST(2, 1) = DST(1, 3) = AVG3(C, D, E);
            DST(3, 1) = DST(2, 3) = AVG3(D, E, F);
            DST(3, 2) = AVG3(E, F, G);
            DST(3, 3) = AVG3(F, G, H);
            break;
        }
        case B_HD_PRED: {
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      L = dst[-1 + 3 * BPS], X = dst[-1 - BPS], A = top[0],
                      B = top[1], C = top[2];
            DST(0, 0) = DST(2, 1) = u8(AVG2(I, X));
            DST(0, 1) = DST(2, 2) = u8(AVG2(J, I));
            DST(0, 2) = DST(2, 3) = u8(AVG2(K, J));
            DST(0, 3) = u8(AVG2(L, K));
            DST(3, 0) = AVG3(A, B, C);
            DST(2, 0) = AVG3(X, A, B);
            DST(1, 0) = DST(3, 1) = AVG3(I, X, A);
            DST(1, 1) = DST(3, 2) = AVG3(J, I, X);
            DST(1, 2) = DST(3, 3) = AVG3(K, J, I);
            DST(1, 3) = AVG3(L, K, J);
            break;
        }
        default: {                                       // B_HU_PRED
            const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS],
                      L = dst[-1 + 3 * BPS];
            DST(0, 0) = u8(AVG2(I, J));
            DST(2, 0) = DST(0, 1) = u8(AVG2(J, K));
            DST(2, 1) = DST(0, 2) = u8(AVG2(K, L));
            DST(1, 0) = AVG3(I, J, K);
            DST(3, 0) = DST(1, 1) = AVG3(J, K, L);
            DST(3, 1) = DST(1, 2) = AVG3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) =
                DST(3, 3) = u8(L);
            break;
        }
    }
}
#undef DST
#undef AVG3
#undef AVG2

// ---- inverse transforms (dsp/dec.c)
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }
inline void store(u8* dst, int x, int y, int v) {
    dst[x + y * BPS] = clip8(dst[x + y * BPS] + (v >> 3));
}


// Transform_SSE2, the one libwebp's decoder runs on x86: 16-bit lanes
// whose sums wrap, the multiplications by sqrt(2)cos(pi/8) and
// sqrt(2)sin(pi/8) as x + mulhi(x, 20091) and x + mulhi(x, -30068); equal
// to TransformOne_C wherever nothing wraps (every valid stream)
inline int16_t w16(int v) { return int16_t(u16(v)); }
inline int16_t mulhi(int16_t x, int k) { return int16_t((int(x) * k) >> 16); }
// c = MUL2(x) - MUL1(y) and d = MUL1(x) + MUL2(y), as Transform_SSE2 forms
// them
inline int16_t sse2_c(int16_t x, int16_t y) {
    return w16(w16(x - y) + w16(mulhi(x, -30068) - mulhi(y, 20091)));
}
inline int16_t sse2_d(int16_t x, int16_t y) {
    return w16(w16(x + y) + w16(mulhi(x, 20091) + mulhi(y, -30068)));
}

void transform_one(const int16_t* in, u8* dst) {
    int16_t C[16];
    for (int i = 0; i < 4; i++) {                          // columns
        const int16_t a = w16(in[i] + in[8 + i]), b = w16(in[i] - in[8 + i]);
        const int16_t c = sse2_c(in[4 + i], in[12 + i]);
        const int16_t d = sse2_d(in[4 + i], in[12 + i]);
        C[4 * i + 0] = w16(a + d);
        C[4 * i + 1] = w16(b + c);
        C[4 * i + 2] = w16(b - c);
        C[4 * i + 3] = w16(a - d);
    }
    for (int r = 0; r < 4; r++) {                          // rows
        const int16_t dc = w16(C[r] + 4);
        const int16_t a = w16(dc + C[8 + r]), b = w16(dc - C[8 + r]);
        const int16_t c = sse2_c(C[4 + r], C[12 + r]);
        const int16_t d = sse2_d(C[4 + r], C[12 + r]);
        const int16_t out[4] = {w16(a + d), w16(b + c), w16(b - c), w16(a - d)};
        for (int x = 0; x < 4; x++)
            dst[x + r * BPS] = clip8(dst[x + r * BPS] + (out[x] >> 3));
    }
}

void transform_ac3(const int16_t* in, u8* dst) {
    const int a = in[0] + 4;
    const int c4 = mul2(in[4]), d4 = mul1(in[4]);
    const int c1 = mul2(in[1]), d1 = mul1(in[1]);
    const int rows[4] = {a + d4, a + c4, a - c4, a - d4};
    for (int y = 0; y < 4; y++) {
        store(dst, 0, y, rows[y] + d1);
        store(dst, 1, y, rows[y] + c1);
        store(dst, 2, y, rows[y] - c1);
        store(dst, 3, y, rows[y] - d1);
    }
}

void transform_dc(const int16_t* in, u8* dst) {
    const int dc = in[0] + 4;
    for (int j = 0; j < 4; j++)
        for (int i = 0; i < 4; i++) store(dst, i, j, dc);
}

// DoTransform: the top two bits of `bits` say which coefficients are set
void do_transform(u32 bits, const int16_t* src, u8* dst) {
    switch (bits >> 30) {
        case 3: transform_one(src, dst); break;
        case 2: transform_ac3(src, dst); break;
        case 1: transform_dc(src, dst); break;
        default: break;
    }
}

void do_uv_transform(u32 bits, const int16_t* src, u8* dst) {
    if (!(bits & 0xff)) return;
    u8* blocks[4] = {dst, dst + 4, dst + 4 * BPS, dst + 4 * BPS + 4};
    for (int k = 0; k < 4; k++) {
        if (bits & 0xaa) transform_one(src + 16 * k, blocks[k]);
        else transform_dc(src + 16 * k, blocks[k]);
    }
}

void transform_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; i++) {
        const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
        tmp[0 + i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; i++) {
        const int dc = tmp[0 + i * 4] + 3;
        const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
        const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
        out[0] = int16_t((a0 + a1) >> 3);
        out[16] = int16_t((a3 + a2) >> 3);
        out[32] = int16_t((a0 - a1) >> 3);
        out[48] = int16_t((a3 - a2) >> 3);
        out += 64;
    }
}

// ---- loop filters (dsp/dec.c)
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(u8* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void do_filter4(u8* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void do_filter6(u8* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7,
              a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const u8* p, int step, int thresh) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const u8* p, int step, int t) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const u8* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
    const int p0 = p[-step], q0 = p[0];
    const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
           std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
           std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// step: across the edge; stride: along it
void simple_filter(u8* p, int step, int stride, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < 16; i++)
        if (needs_filter(p + i * stride, step, t2))
            do_filter2(p + i * stride, step);
}

void filter_loop(u8* p, int step, int stride, int size, int thresh,
                 int ithresh, int hev_t, bool edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; i++, p += stride) {
        if (!needs_filter2(p, step, t2, ithresh)) continue;
        if (hev(p, step, hev_t)) do_filter2(p, step);
        else if (edge) do_filter6(p, step);
        else do_filter4(p, step);
    }
}

struct FInfo {
    int limit, ilevel, inner, hev;
};

struct MBData {
    int16_t coeffs[384];
    u8 imodes[16];
    int is_i4x4, uvmode, segment, skip;
    u32 nz_y, nz_uv;
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];
};

class VP8Decoder {
  public:
    // data: the VP8 payload to the end of the buffer libwebp is given;
    // chunk: the payload's declared size
    void decode(const u8* data, size_t n, size_t chunk) {
        if (n < 10) fail("VP8 frame header cut short");
        const u32 bits = data[0] | (data[1] << 8) | (data[2] << 16);
        const int key_frame = !(bits & 1);
        const u32 part_len = bits >> 5;
        if (!key_frame) fail("VP8 frame is not a key frame");
        if (((bits >> 1) & 7) > 3) fail("bad VP8 profile");
        if (!((bits >> 4) & 1)) fail("VP8 frame is not shown");
        if (part_len >= chunk) fail("bad VP8 partition length");
        if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
            fail("bad VP8 start code");
        width_ = ((data[7] << 8) | data[6]) & 0x3fff;
        height_ = ((data[9] << 8) | data[8]) & 0x3fff;
        if (width_ == 0 || height_ == 0) fail("VP8 frame of zero size");
        mb_w_ = (width_ + 15) >> 4;
        mb_h_ = (height_ + 15) >> 4;
        const u8* buf = data + 10;
        size_t size = n - 10;
        if (part_len > size) fail("bad VP8 partition length");
        br_.init(buf, part_len);
        buf += part_len;
        size -= part_len;
        br_.value(1);                                      // color space
        br_.value(1);                                      // clamping type
        parse_segment_header();
        parse_filter_header();
        parse_partitions(buf, size);
        parse_quant();
        br_.value(1);                                      // refresh probas
        parse_proba();
        decode_frame();
    }

    int width_ = 0, height_ = 0;
    int mb_w_ = 0, mb_h_ = 0;
    std::vector<u8> Y, U, V;              // unfiltered, then filtered planes
    int ys_ = 0, uvs_ = 0;

  private:
    BoolDecoder br_;
    BoolDecoder parts_[8];
    int num_parts_ = 1;
    int use_segment_ = 0, update_map_ = 0, absolute_delta_ = 1;
    int quantizer_[4] = {0}, filter_strength_[4] = {0};
    int segment_probs_[3] = {255, 255, 255};
    int simple_ = 0, level_ = 0, sharpness_ = 0, use_lf_delta_ = 0;
    int ref_lf_delta_[4] = {0}, mode_lf_delta_[4] = {0};
    int filter_type_ = 0;
    QuantMatrix dqm_[4];
    u8 proba_[4][8][3][11];
    int use_skip_proba_ = 0, skip_p_ = 0;
    FInfo fstrengths_[4][2];
    std::vector<FInfo> finfo_;

    void parse_segment_header() {
        use_segment_ = br_.value(1);
        if (use_segment_) {
            update_map_ = br_.value(1);
            if (br_.value(1)) {
                absolute_delta_ = br_.value(1);
                for (int s = 0; s < 4; s++)
                    quantizer_[s] = br_.value(1) ? br_.signed_value(7) : 0;
                for (int s = 0; s < 4; s++)
                    filter_strength_[s] = br_.value(1) ? br_.signed_value(6) : 0;
            }
            if (update_map_)
                for (int s = 0; s < 3; s++)
                    segment_probs_[s] = br_.value(1) ? br_.value(8) : 255;
        } else {
            update_map_ = 0;
        }
        if (br_.eof()) fail("cannot parse VP8 segment header");
    }

    void parse_filter_header() {
        simple_ = br_.value(1);
        level_ = br_.value(6);
        sharpness_ = br_.value(3);
        use_lf_delta_ = br_.value(1);
        if (use_lf_delta_ && br_.value(1)) {
            for (int i = 0; i < 4; i++)
                if (br_.value(1)) ref_lf_delta_[i] = br_.signed_value(6);
            for (int i = 0; i < 4; i++)
                if (br_.value(1)) mode_lf_delta_[i] = br_.signed_value(6);
        }
        filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
        if (br_.eof()) fail("cannot parse VP8 filter header");
    }

    void parse_partitions(const u8* buf, size_t size) {
        num_parts_ = 1 << br_.value(2);
        const size_t last = size_t(num_parts_ - 1);
        if (size < 3 * last) fail("VP8 partitions cut short");
        const u8* sz = buf;
        const u8* start = buf + last * 3;
        size_t left = size - last * 3;
        for (size_t p = 0; p < last; p++, sz += 3) {
            size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
            if (psize > left) psize = left;
            parts_[p].init(start, psize);
            start += psize;
            left -= psize;
        }
        parts_[last].init(start, left);
        if (start >= buf + size) fail("VP8 partitions cut short");
    }

    void parse_quant() {
        const int base_q0 = br_.value(7);
        int dq[5];
        for (int& d : dq) d = br_.value(1) ? br_.signed_value(4) : 0;
        const int dqy1_dc = dq[0], dqy2_dc = dq[1], dqy2_ac = dq[2],
                  dquv_dc = dq[3], dquv_ac = dq[4];
        auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
        for (int i = 0; i < 4; i++) {
            int q;
            if (use_segment_) {
                q = quantizer_[i];
                if (!absolute_delta_) q += base_q0;
            } else if (i > 0) {
                dqm_[i] = dqm_[0];
                continue;
            } else {
                q = base_q0;
            }
            QuantMatrix& m = dqm_[i];
            m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
            m.y1[1] = kAcTable[clip(q, 127)];
            m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
            m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
            if (m.y2[1] < 8) m.y2[1] = 8;
            m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
            m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
        }
    }

    void parse_proba() {
        for (int t = 0; t < 4; t++)
            for (int b = 0; b < 8; b++)
                for (int c = 0; c < 3; c++)
                    for (int p = 0; p < 11; p++)
                        proba_[t][b][c][p] = u8(
                            br_.bit(kCoeffsUpdateProba[t][b][c][p])
                                ? br_.value(8) : kCoeffsProba0[t][b][c][p]);
        use_skip_proba_ = br_.value(1);
        if (use_skip_proba_) skip_p_ = br_.value(8);
    }

    void precompute_filter_strengths() {
        for (int s = 0; s < 4; s++) {
            int base = level_;
            if (use_segment_) {
                base = filter_strength_[s];
                if (!absolute_delta_) base += level_;
            }
            for (int i4x4 = 0; i4x4 <= 1; i4x4++) {
                FInfo& info = fstrengths_[s][i4x4];
                int level = base;
                if (use_lf_delta_) {
                    level += ref_lf_delta_[0];
                    if (i4x4) level += mode_lf_delta_[0];
                }
                level = level < 0 ? 0 : level > 63 ? 63 : level;
                if (level > 0) {
                    int ilevel = level;
                    if (sharpness_ > 0) {
                        ilevel >>= sharpness_ > 4 ? 2 : 1;
                        if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
                    }
                    if (ilevel < 1) ilevel = 1;
                    info.ilevel = ilevel;
                    info.limit = 2 * level + ilevel;
                    info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
                } else {
                    info.limit = 0;
                    info.ilevel = 0;
                    info.hev = 0;
                }
                info.inner = i4x4;
            }
        }
    }

    void parse_intra_mode(MBData& b, u8* top, u8* left) {
        b.segment = update_map_
            ? (!br_.bit(segment_probs_[0]) ? br_.bit(segment_probs_[1])
                                           : br_.bit(segment_probs_[2]) + 2)
            : 0;
        b.skip = use_skip_proba_ ? br_.bit(skip_p_) : 0;
        b.is_i4x4 = !br_.bit(145);
        if (!b.is_i4x4) {
            const int ymode = br_.bit(156) ? (br_.bit(128) ? TM_PRED : H_PRED)
                                           : (br_.bit(163) ? V_PRED : DC_PRED);
            b.imodes[0] = u8(ymode);
            std::memset(top, ymode, 4);
            std::memset(left, ymode, 4);
        } else {
            u8* modes = b.imodes;
            for (int y = 0; y < 4; y++) {
                int ymode = left[y];
                for (int x = 0; x < 4; x++) {
                    const u8* prob = kBModesProba[top[x]][ymode];
                    int i = kYModesIntra4[br_.bit(prob[0])];
                    while (i > 0) i = kYModesIntra4[2 * i + br_.bit(prob[i])];
                    ymode = -i;
                    top[x] = u8(ymode);
                }
                std::memcpy(modes, top, 4);
                modes += 4;
                left[y] = u8(ymode);
            }
        }
        b.uvmode = !br_.bit(142) ? DC_PRED
                 : !br_.bit(114) ? V_PRED
                 : br_.bit(183) ? TM_PRED : H_PRED;
    }

    // GetCoeffs: the coefficients of one block from position n on,
    // dequantized into out; returns the position after the last one read
    int get_coeffs(BoolDecoder& br, int type, int ctx, const int* dq, int n,
                   int16_t* out) {
        const u8* p = proba_[type][kBands[n]][ctx];
        for (; n < 16; ++n) {
            if (!br.bit(p[0])) return n;
            while (!br.bit(p[1])) {
                p = proba_[type][kBands[++n]][0];
                if (n == 16) return 16;
            }
            int v;
            const int band = kBands[n + 1];
            if (!br.bit(p[2])) {
                v = 1;
                p = proba_[type][band][1];
            } else {
                v = large_value(br, p);
                p = proba_[type][band][2];
            }
            const int sign = br.bit(0x80);
            out[kZigzag[n]] = int16_t((sign ? -v : v) * dq[n > 0]);
        }
        return 16;
    }

    static int large_value(BoolDecoder& br, const u8* p) {
        int v;
        if (!br.bit(p[3])) {
            v = !br.bit(p[4]) ? 2 : 3 + br.bit(p[5]);
        } else if (!br.bit(p[6])) {
            if (!br.bit(p[7])) {
                v = 5 + br.bit(159);
            } else {
                v = 7 + 2 * br.bit(165);
                v += br.bit(145);
            }
        } else {
            const int bit1 = br.bit(p[8]);
            const int bit0 = br.bit(p[9 + bit1]);
            const int cat = 2 * bit1 + bit0;
            static const u8* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
            v = 0;
            for (const u8* tab = kCat3456[cat]; *tab; ++tab)
                v += v + br.bit(*tab);
            v += 3 + (8 << cat);
        }
        return v;
    }

    static u32 nz_code_bits(u32 nz_coeffs, int nz, int dc_nz) {
        nz_coeffs <<= 2;
        nz_coeffs |= u32(nz > 3 ? 3 : nz > 1 ? 2 : dc_nz);
        return nz_coeffs;
    }

    // ParseResiduals; returns whether every coefficient is zero
    bool parse_residuals(BoolDecoder& br, MBData& b, u8& top_nz, u8& top_nz_dc,
                         u8& left_nz, u8& left_nz_dc) {
        const QuantMatrix& q = dqm_[b.segment];
        int16_t* dst = b.coeffs;
        std::memset(dst, 0, sizeof(b.coeffs));
        int first, type;
        if (!b.is_i4x4) {
            int16_t dc[16] = {0};
            const int ctx = top_nz_dc + left_nz_dc;
            const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
            top_nz_dc = left_nz_dc = u8(nz > 0);
            if (nz > 1) {
                transform_wht(dc, dst);
            } else {
                const int dc0 = (dc[0] + 3) >> 3;
                for (int i = 0; i < 16 * 16; i += 16) dst[i] = int16_t(dc0);
            }
            first = 1;
            type = 0;
        } else {
            first = 0;
            type = 3;
        }
        u32 tnz = top_nz & 0x0f, lnz = left_nz & 0x0f;
        u32 non_zero_y = 0, non_zero_uv = 0;
        for (int y = 0; y < 4; y++) {
            u32 l = lnz & 1, nz_coeffs = 0;
            for (int x = 0; x < 4; x++) {
                const int ctx = int(l + (tnz & 1));
                const int nz = get_coeffs(br, type, ctx, q.y1, first, dst);
                l = nz > first;
                tnz = (tnz >> 1) | (l << 7);
                nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                dst += 16;
            }
            tnz >>= 4;
            lnz = (lnz >> 1) | (l << 7);
            non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        u32 out_t_nz = tnz, out_l_nz = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
            u32 nz_coeffs = 0;
            tnz = u32(top_nz) >> (4 + ch);
            lnz = u32(left_nz) >> (4 + ch);
            for (int y = 0; y < 2; y++) {
                u32 l = lnz & 1;
                for (int x = 0; x < 2; x++) {
                    const int ctx = int(l + (tnz & 1));
                    const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
                    l = nz > 0;
                    tnz = (tnz >> 1) | (l << 3);
                    nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
                    dst += 16;
                }
                tnz >>= 2;
                lnz = (lnz >> 1) | (l << 5);
            }
            non_zero_uv |= nz_coeffs << (4 * ch);
            out_t_nz |= (tnz << 4) << ch;
            out_l_nz |= (lnz & 0xf0) << ch;
        }
        top_nz = u8(out_t_nz);
        left_nz = u8(out_l_nz);
        b.nz_y = non_zero_y;
        b.nz_uv = non_zero_uv;
        return !(non_zero_y | non_zero_uv);
    }

    static int check_mode(int mb_x, int mb_y, int mode) {
        if (mode != B_DC_PRED) return mode;
        if (mb_x == 0) return mb_y == 0 ? B_DC_NOTOPLEFT : B_DC_NOLEFT;
        return mb_y == 0 ? B_DC_NOTOP : B_DC_PRED;
    }

    void decode_frame() {
        precompute_filter_strengths();
        ys_ = mb_w_ * 16;
        uvs_ = mb_w_ * 8;
        Y.assign(size_t(ys_) * size_t(mb_h_) * 16, 0);
        U.assign(size_t(uvs_) * size_t(mb_h_) * 8, 0);
        V.assign(size_t(uvs_) * size_t(mb_h_) * 8, 0);
        finfo_.assign(size_t(mb_w_) * size_t(mb_h_), FInfo{0, 0, 0, 0});
        std::vector<u8> intra_t(size_t(4 * mb_w_), B_DC_PRED);
        std::vector<u8> top_nz(size_t(mb_w_), 0), top_nz_dc(size_t(mb_w_), 0);
        std::vector<u8> top_y(size_t(16 * mb_w_)), top_u(size_t(8 * mb_w_)),
            top_v(size_t(8 * mb_w_));
        std::vector<MBData> row(static_cast<size_t>(mb_w_));
        u8 work[kWorkSize];
        std::memset(work, 0, sizeof(work));
        for (int mb_y = 0; mb_y < mb_h_; mb_y++) {
            BoolDecoder& tokens = parts_[mb_y & (num_parts_ - 1)];
            u8 intra_l[4];
            std::memset(intra_l, B_DC_PRED, 4);
            for (int mb_x = 0; mb_x < mb_w_; mb_x++)
                parse_intra_mode(row[size_t(mb_x)], &intra_t[size_t(4 * mb_x)],
                                 intra_l);
            if (br_.eof()) fail("VP8 first partition ends early");
            u8 left_nz = 0, left_nz_dc = 0;
            for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
                MBData& b = row[size_t(mb_x)];
                int skip = use_skip_proba_ ? b.skip : 0;
                if (!skip) {
                    skip = parse_residuals(tokens, b, top_nz[size_t(mb_x)],
                                           top_nz_dc[size_t(mb_x)], left_nz,
                                           left_nz_dc);
                } else {
                    left_nz = top_nz[size_t(mb_x)] = 0;
                    if (!b.is_i4x4) left_nz_dc = top_nz_dc[size_t(mb_x)] = 0;
                    b.nz_y = b.nz_uv = 0;
                }
                if (filter_type_ > 0) {
                    FInfo f = fstrengths_[b.segment][b.is_i4x4];
                    f.inner |= !skip;
                    finfo_[size_t(mb_y * mb_w_ + mb_x)] = f;
                }
                if (tokens.eof()) fail("VP8 token partition ends early");
            }
            reconstruct_row(mb_y, row, work, top_y, top_u, top_v);
        }
        if (filter_type_ > 0)
            for (int mb_y = 0; mb_y < mb_h_; mb_y++)
                for (int mb_x = 0; mb_x < mb_w_; mb_x++) filter_mb(mb_x, mb_y);
    }

    // ReconstructRow (frame_dec.c): prediction from the unfiltered samples
    // in a work buffer of stride BPS, residuals added, the row copied out
    void reconstruct_row(int mb_y, const std::vector<MBData>& row, u8* work,
                         std::vector<u8>& top_y, std::vector<u8>& top_u,
                         std::vector<u8>& top_v) {
        u8* const y_dst = work + kYOff;
        u8* const u_dst = work + kUOff;
        u8* const v_dst = work + kVOff;
        for (int j = 0; j < 16; j++) y_dst[j * BPS - 1] = 129;
        for (int j = 0; j < 8; j++) {
            u_dst[j * BPS - 1] = 129;
            v_dst[j * BPS - 1] = 129;
        }
        if (mb_y > 0) {
            y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
        } else {
            std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
            std::memset(u_dst - BPS - 1, 127, 8 + 1);
            std::memset(v_dst - BPS - 1, 127, 8 + 1);
        }
        for (int mb_x = 0; mb_x < mb_w_; mb_x++) {
            const MBData& b = row[size_t(mb_x)];
            if (mb_x > 0) {
                for (int j = -1; j < 16; j++)
                    std::memcpy(&y_dst[j * BPS - 4], &y_dst[j * BPS + 12], 4);
                for (int j = -1; j < 8; j++) {
                    std::memcpy(&u_dst[j * BPS - 4], &u_dst[j * BPS + 4], 4);
                    std::memcpy(&v_dst[j * BPS - 4], &v_dst[j * BPS + 4], 4);
                }
            }
            u8* ty = &top_y[size_t(16 * mb_x)];
            u8* tu = &top_u[size_t(8 * mb_x)];
            u8* tv = &top_v[size_t(8 * mb_x)];
            if (mb_y > 0) {
                std::memcpy(y_dst - BPS, ty, 16);
                std::memcpy(u_dst - BPS, tu, 8);
                std::memcpy(v_dst - BPS, tv, 8);
            }
            u32 bits = b.nz_y;
            if (b.is_i4x4) {
                u8* top_right = y_dst - BPS + 16;
                if (mb_y > 0) {
                    if (mb_x >= mb_w_ - 1) std::memset(top_right, ty[15], 4);
                    else std::memcpy(top_right, ty + 16, 4);
                }
                for (int k = 1; k <= 3; k++)
                    std::memcpy(top_right + 4 * k * BPS, top_right, 4);
                for (int n = 0; n < 16; n++, bits <<= 2) {
                    u8* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                    pred4(dst, b.imodes[n]);
                    do_transform(bits, b.coeffs + n * 16, dst);
                }
            } else {
                pred_block(y_dst, 16, check_mode(mb_x, mb_y, b.imodes[0]));
                if (bits != 0)
                    for (int n = 0; n < 16; n++, bits <<= 2)
                        do_transform(bits, b.coeffs + n * 16,
                                     y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
            }
            const int uvmode = check_mode(mb_x, mb_y, b.uvmode);
            pred_block(u_dst, 8, uvmode);
            pred_block(v_dst, 8, uvmode);
            do_uv_transform(b.nz_uv >> 0, b.coeffs + 16 * 16, u_dst);
            do_uv_transform(b.nz_uv >> 8, b.coeffs + 20 * 16, v_dst);
            if (mb_y < mb_h_ - 1) {
                std::memcpy(ty, y_dst + 15 * BPS, 16);
                std::memcpy(tu, u_dst + 7 * BPS, 8);
                std::memcpy(tv, v_dst + 7 * BPS, 8);
            }
            for (int j = 0; j < 16; j++)
                std::memcpy(&Y[size_t(mb_y * 16 + j) * size_t(ys_) +
                               size_t(mb_x * 16)],
                            y_dst + j * BPS, 16);
            for (int j = 0; j < 8; j++) {
                const size_t o =
                    size_t(mb_y * 8 + j) * size_t(uvs_) + size_t(mb_x * 8);
                std::memcpy(&U[o], u_dst + j * BPS, 8);
                std::memcpy(&V[o], v_dst + j * BPS, 8);
            }
        }
    }

    // DoFilter (frame_dec.c), in macroblock raster order on the frame
    void filter_mb(int mb_x, int mb_y) {
        const FInfo& f = finfo_[size_t(mb_y * mb_w_ + mb_x)];
        const int limit = f.limit;
        if (limit == 0) return;
        u8* y = &Y[size_t(mb_y * 16) * size_t(ys_) + size_t(mb_x * 16)];
        const int ys = ys_;
        if (filter_type_ == 1) {
            if (mb_x > 0) simple_filter(y, 1, ys, limit + 4);
            if (f.inner)
                for (int k = 1; k <= 3; k++) simple_filter(y + 4 * k, 1, ys, limit);
            if (mb_y > 0) simple_filter(y, ys, 1, limit + 4);
            if (f.inner)
                for (int k = 1; k <= 3; k++)
                    simple_filter(y + 4 * k * ys, ys, 1, limit);
            return;
        }
        const size_t uo = size_t(mb_y * 8) * size_t(uvs_) + size_t(mb_x * 8);
        u8* u = &U[uo];
        u8* v = &V[uo];
        const int uvs = uvs_, il = f.ilevel, hv = f.hev;
        if (mb_x > 0) {
            filter_loop(y, 1, ys, 16, limit + 4, il, hv, true);
            filter_loop(u, 1, uvs, 8, limit + 4, il, hv, true);
            filter_loop(v, 1, uvs, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
            for (int k = 1; k <= 3; k++)
                filter_loop(y + 4 * k, 1, ys, 16, limit, il, hv, false);
            filter_loop(u + 4, 1, uvs, 8, limit, il, hv, false);
            filter_loop(v + 4, 1, uvs, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
            filter_loop(y, ys, 1, 16, limit + 4, il, hv, true);
            filter_loop(u, uvs, 1, 8, limit + 4, il, hv, true);
            filter_loop(v, uvs, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
            for (int k = 1; k <= 3; k++)
                filter_loop(y + 4 * k * ys, ys, 1, 16, limit, il, hv, false);
            filter_loop(u + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
            filter_loop(v + 4 * uvs, uvs, 1, 8, limit, il, hv, false);
        }
    }
};

// ---- YUV -> RGB (yuv.h) and fancy upsampling (upsampling.c)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline u8 yuv_clip(int v) {
    return u8((v & ~16383) == 0 ? (v >> 6) : (v < 0) ? 0 : 255);
}
inline void yuv_to_rgb(int y, int u, int v, u8* rgb) {
    rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) -
                      mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// One output row of UpsampleRgbLinePair: nu/nv the chroma row nearer to
// it, fu/fv the other one (the same row at the image's first and, for an
// even height, last row)
void upsample_row(const u8* y, const u8* nu, const u8* nv, const u8* fu,
                  const u8* fv, u8* rgb, int len) {
    auto near_far = [](int n0, int f0) { return (3 * n0 + f0 + 2) >> 2; };
    yuv_to_rgb(y[0], near_far(nu[0], fu[0]), near_far(nv[0], fv[0]), rgb);
    const int last_pair = (len - 1) >> 1;
    for (int x = 1; x <= last_pair; x++) {
        const int a[2] = {nu[x - 1], nv[x - 1]}, b[2] = {nu[x], nv[x]},
                  c[2] = {fu[x - 1], fv[x - 1]}, d[2] = {fu[x], fv[x]};
        int odd[2], even[2];
        for (int k = 0; k < 2; k++) {
            odd[k] = (((a[k] + 3 * b[k] + 3 * c[k] + d[k] + 8) >> 3) + a[k]) >> 1;
            even[k] = (((3 * a[k] + b[k] + c[k] + 3 * d[k] + 8) >> 3) + b[k]) >> 1;
        }
        yuv_to_rgb(y[2 * x - 1], odd[0], odd[1], rgb + 3 * (2 * x - 1));
        yuv_to_rgb(y[2 * x], even[0], even[1], rgb + 3 * (2 * x));
    }
    if (!(len & 1)) {
        yuv_to_rgb(y[len - 1], near_far(nu[last_pair], fu[last_pair]),
                   near_far(nv[last_pair], fv[last_pair]), rgb + 3 * (len - 1));
    }
}

void vp8_to_rgb(const VP8Decoder& d, u8* rgb) {
    const int w = d.width_, h = d.height_, ch = (h + 1) / 2;
    for (int r = 0; r < h; r++) {
        int near, far;
        if (r & 1) {
            near = (r - 1) / 2;
            far = std::min((r + 1) / 2, ch - 1);
        } else {
            near = r / 2;
            far = std::max(r / 2 - 1, 0);
        }
        const size_t no = size_t(near) * size_t(d.uvs_),
                     fo = size_t(far) * size_t(d.uvs_);
        upsample_row(&d.Y[size_t(r) * size_t(d.ys_)], &d.U[no], &d.V[no], &d.U[fo],
                     &d.V[fo], rgb + size_t(r) * size_t(w) * 3, w);
    }
}

// ---- ALPH (alpha_dec.c): header byte, raw or lossless, then unfiltering
void alph_decode(const u8* data, size_t n, int w, int h, u8* alpha) {
    if (n <= 1) fail("ALPH chunk too short");
    const int method = data[0] & 3, filter = (data[0] >> 2) & 3,
              pre = (data[0] >> 4) & 3, rsrv = data[0] >> 6;
    if (method > 1 || pre > 1 || rsrv != 0) fail("bad ALPH header");
    const size_t npx = size_t(w) * size_t(h);
    if (method == 0) {
        if (n - 1 < npx) fail("ALPH data cut short");
        std::memcpy(alpha, data + 1, npx);
    } else {
        VP8LDecoder dec(data + 1, n - 1);
        dec.decode_alpha(w, h, alpha);
    }
    if (filter == 0) return;
    u8* prev = nullptr;
    for (int y = 0; y < h; y++) {
        u8* row = alpha + size_t(y) * size_t(w);
        if (prev == nullptr || filter == 1) {
            u8 pred = prev == nullptr ? 0 : prev[0];
            for (int i = 0; i < w; i++) pred = row[i] = u8(pred + row[i]);
        } else if (filter == 2) {
            for (int i = 0; i < w; i++) row[i] = u8(prev[i] + row[i]);
        } else {
            u8 top = prev[0], top_left = top, left = top;
            for (int i = 0; i < w; i++) {
                top = prev[i];
                const int g = left + top - top_left;
                left = u8(row[i] + (((g & ~0xff) == 0) ? g : g < 0 ? 0 : 255));
                top_left = top;
                row[i] = left;
            }
        }
        prev = row;
    }
}

// ============================================================ VP8L encoder

class BitWriter {
  public:
    void put(u32 bits, int n) {
        acc_ |= u64(bits) << used_;
        used_ += n;
        while (used_ >= 8) {
            out.push_back(u8(acc_));
            acc_ >>= 8;
            used_ -= 8;
        }
    }
    void flush() {
        if (used_ > 0) out.push_back(u8(acc_));
        acc_ = 0;
        used_ = 0;
    }
    std::vector<u8> out;

  private:
    u64 acc_ = 0;
    int used_ = 0;
};

// Code lengths of at most max_len bits for a histogram (Huffman's
// construction; the smallest counts raised until the depth fits)
std::vector<int> code_lengths(const std::vector<u32>& hist, int max_len) {
    const int n = int(hist.size());
    std::vector<int> lengths(size_t(n), 0);
    int used = 0;
    for (u32 c : hist) used += c > 0;
    if (used <= 1) {
        for (int s = 0; s < n; s++)
            if (hist[size_t(s)]) lengths[size_t(s)] = 1;
        return lengths;
    }
    for (u64 floor = 1;; floor *= 2) {
        struct Node {
            u64 count;
            int left, right;
        };
        std::vector<Node> nodes;
        using Item = std::pair<u64, int>;
        std::priority_queue<Item, std::vector<Item>, std::greater<Item>> heap;
        for (int s = 0; s < n; s++) {
            if (!hist[size_t(s)]) continue;
            nodes.push_back({std::max<u64>(hist[size_t(s)], floor), -1, s});
            heap.push({nodes.back().count, int(nodes.size()) - 1});
        }
        while (heap.size() > 1) {
            Item a = heap.top();
            heap.pop();
            Item b = heap.top();
            heap.pop();
            nodes.push_back({a.first + b.first, a.second, b.second});
            heap.push({nodes.back().count, int(nodes.size()) - 1});
        }
        int depth_max = 0;
        std::vector<std::pair<int, int>> stack{{heap.top().second, 0}};
        while (!stack.empty()) {
            auto [i, depth] = stack.back();
            stack.pop_back();
            const Node& nd = nodes[size_t(i)];
            if (nd.left < 0) {
                lengths[size_t(nd.right)] = depth;
                depth_max = std::max(depth_max, depth);
            } else {
                stack.push_back({nd.left, depth + 1});
                stack.push_back({nd.right, depth + 1});
            }
        }
        if (depth_max <= max_len) return lengths;
    }
}

// Canonical codes (bit-reversed for the LSB-first writer)
std::vector<u32> canonical_codes(const std::vector<int>& lengths) {
    int count[16] = {0}, next[16] = {0};
    for (int l : lengths) count[l]++;
    count[0] = 0;
    int code = 0;
    for (int len = 1; len <= 15; len++) {
        code = (code + count[len - 1]) << 1;
        next[len] = code;
    }
    std::vector<u32> codes(lengths.size(), 0);
    for (size_t s = 0; s < lengths.size(); s++) {
        const int len = lengths[s];
        if (!len) continue;
        const int c = next[len]++;
        u32 rev = 0;
        for (int b = 0; b < len; b++) rev |= u32((c >> b) & 1) << (len - 1 - b);
        codes[s] = rev;
    }
    return codes;
}

struct EncCode {
    std::vector<int> lengths;
    std::vector<u32> codes;
    bool single = true;        // one symbol or none: no bits a symbol
    void put(BitWriter& bw, int s) const {
        if (!single) bw.put(codes[size_t(s)], lengths[size_t(s)]);
    }
};

// One prefix code: written to the stream, returned for the symbols
EncCode write_code(BitWriter& bw, const std::vector<u32>& hist) {
    EncCode c;
    std::vector<int> syms;
    for (size_t s = 0; s < hist.size(); s++)
        if (hist[s]) syms.push_back(int(s));
    if (syms.size() <= 2 && (syms.empty() || syms.back() < 256)) {
        bw.put(1, 1);                                       // simple code
        if (syms.empty()) syms.push_back(0);
        bw.put(u32(syms.size() - 1), 1);
        const int first8 = syms[0] > 1;
        bw.put(u32(first8), 1);
        bw.put(u32(syms[0]), first8 ? 8 : 1);
        if (syms.size() == 2) bw.put(u32(syms[1]), 8);
        c.lengths.assign(hist.size(), 0);
        for (int s : syms) c.lengths[size_t(s)] = 1;
        c.single = syms.size() == 1;
        c.codes = canonical_codes(c.lengths);
        return c;
    }
    c.lengths = code_lengths(hist, 15);
    c.codes = canonical_codes(c.lengths);
    c.single = syms.size() == 1;
    // the code lengths as tokens: 0-15, 17 (3-10 zeros), 18 (11-138 zeros)
    std::vector<std::pair<int, int>> tokens;                 // (token, extra)
    const int n = int(c.lengths.size());
    for (int s = 0; s < n;) {
        if (c.lengths[size_t(s)] == 0) {
            int run = 0;
            while (s + run < n && c.lengths[size_t(s + run)] == 0 && run < 138)
                run++;
            if (run >= 11) {
                tokens.push_back({18, run - 11});
            } else if (run >= 3) {
                tokens.push_back({17, run - 3});
            } else {
                for (int k = 0; k < run; k++) tokens.push_back({0, 0});
            }
            s += run;
        } else {
            tokens.push_back({c.lengths[size_t(s)], 0});
            s++;
        }
    }
    std::vector<u32> thist(19, 0);
    for (auto& t : tokens) thist[size_t(t.first)]++;
    EncCode tc;
    tc.lengths = code_lengths(thist, 7);
    tc.codes = canonical_codes(tc.lengths);
    int used = 0;
    for (u32 v : thist) used += v > 0;
    tc.single = used == 1;
    int num = 19;
    while (num > 4 && tc.lengths[kCodeLengthCodeOrder[num - 1]] == 0) num--;
    bw.put(0, 1);                                           // normal code
    bw.put(u32(num - 4), 4);
    for (int i = 0; i < num; i++)
        bw.put(u32(tc.lengths[kCodeLengthCodeOrder[i]]), 3);
    bw.put(0, 1);                                           // all symbols
    for (auto& t : tokens) {
        tc.put(bw, t.first);
        if (t.first == 17) bw.put(u32(t.second), 3);
        if (t.first == 18) bw.put(u32(t.second), 7);
    }
    return c;
}

// VP8LPrefixEncode: a length or distance value (>= 1) as (symbol, extra
// bits, their value)
void prefix_encode(int v, int* sym, int* nbits, int* bits) {
    const int d = v - 1;
    if (d < 2) {
        *sym = d;
        *nbits = 0;
        *bits = 0;
        return;
    }
    const int hb = floor_log2(u32(d));
    const int second = (d >> (hb - 1)) & 1;
    *nbits = hb - 1;
    *bits = d & ((1 << *nbits) - 1);
    *sym = 2 * hb + second;
}

struct Token {
    u32 argb;     // a literal, or 0 for a copy
    int length;   // 0 for a literal
    int dist_code;
};

// One entropy-coded image (no color cache, one group): its five codes and
// its tokens
void write_image(BitWriter& bw, const std::vector<Token>& tokens) {
    std::vector<u32> hist[5] = {std::vector<u32>(kNumLiteral + kNumLength, 0),
                                std::vector<u32>(256, 0), std::vector<u32>(256, 0),
                                std::vector<u32>(256, 0),
                                std::vector<u32>(kNumDistance, 0)};
    for (const Token& t : tokens) {
        if (t.length == 0) {
            hist[0][(t.argb >> 8) & 0xff]++;
            hist[1][(t.argb >> 16) & 0xff]++;
            hist[2][t.argb & 0xff]++;
            hist[3][t.argb >> 24]++;
        } else {
            int sym, nb, b;
            prefix_encode(t.length, &sym, &nb, &b);
            hist[0][size_t(kNumLiteral + sym)]++;
            prefix_encode(t.dist_code, &sym, &nb, &b);
            hist[4][size_t(sym)]++;
        }
    }
    EncCode codes[5];
    for (int j = 0; j < 5; j++) codes[j] = write_code(bw, hist[j]);
    for (const Token& t : tokens) {
        if (t.length == 0) {
            codes[0].put(bw, int((t.argb >> 8) & 0xff));
            codes[1].put(bw, int((t.argb >> 16) & 0xff));
            codes[2].put(bw, int(t.argb & 0xff));
            codes[3].put(bw, int(t.argb >> 24));
        } else {
            int sym, nb, b;
            prefix_encode(t.length, &sym, &nb, &b);
            codes[0].put(bw, kNumLiteral + sym);
            bw.put(u32(b), nb);
            prefix_encode(t.dist_code, &sym, &nb, &b);
            codes[4].put(bw, sym);
            bw.put(u32(b), nb);
        }
    }
}

std::vector<Token> literals(const std::vector<u32>& px) {
    std::vector<Token> t(px.size());
    for (size_t i = 0; i < px.size(); i++) t[i] = {px[i], 0, 0};
    return t;
}

inline u32 sub_pixels(u32 a, u32 b) {
    return (((a | 0x00ff00ffu) - (b & 0xff00ff00u)) & 0xff00ff00u) |
           (((a | 0xff00ff00u) - (b & 0x00ff00ffu)) & 0x00ff00ffu);
}

std::vector<u8> encode_vp8l(const u8* rgb, int w, int h) {
    const size_t npx = size_t(w) * size_t(h);
    std::vector<u32> argb(npx);
    for (size_t i = 0; i < npx; i++) {
        const u32 r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
        // subtract green
        argb[i] = 0xff000000u | (((r - g) & 0xff) << 16) | (g << 8) |
                  ((b - g) & 0xff);
    }
    // a predictor a tile: the mode of least summed |residual|
    const int bits = 5, tiles_x = subsample(w, bits), tiles_y = subsample(h, bits);
    std::vector<u32> modes(size_t(tiles_x) * size_t(tiles_y));
    auto pred_at = [&](int mode, int x, int y) -> u32 {
        const u32* p = argb.data() + size_t(y) * size_t(w);
        if (y == 0) return x == 0 ? 0xff000000u : p[x - 1];
        if (x == 0) return p[x - w];
        return VP8LDecoder::predict(mode, p[x - 1], p[x - w], p[x - w - 1],
                                    p[x - w + 1]);
    };
    for (int ty = 0; ty < tiles_y; ty++) {
        for (int tx = 0; tx < tiles_x; tx++) {
            int best = 0;
            u64 best_cost = ~u64(0);
            for (int mode = 0; mode < 14; mode++) {
                u64 cost = 0;
                const int y1 = std::min(h, (ty + 1) << bits),
                          x1 = std::min(w, (tx + 1) << bits);
                for (int y = ty << bits; y < y1; y++)
                    for (int x = tx << bits; x < x1; x++) {
                        const u32 r = sub_pixels(
                            argb[size_t(y) * size_t(w) + size_t(x)],
                            pred_at(mode, x, y));
                        for (int s = 0; s < 32; s += 8)
                            cost += u64(std::abs(int(int8_t(r >> s))));
                    }
                if (cost < best_cost) {
                    best_cost = cost;
                    best = mode;
                }
            }
            modes[size_t(ty * tiles_x + tx)] = 0xff000000u | (u32(best) << 8);
        }
    }
    std::vector<u32> res(npx);
    for (int y = 0; y < h; y++)
        for (int x = 0; x < w; x++) {
            const size_t i = size_t(y) * size_t(w) + size_t(x);
            const u32 m = modes[size_t((y >> bits) * tiles_x + (x >> bits))];
            res[i] = sub_pixels(argb[i], pred_at(int((m >> 8) & 0xf), x, y));
        }
    // LZ77 against the pixel to the left (plane code 2) and the one above
    // (plane code 1)
    std::vector<Token> tokens;
    tokens.reserve(npx);
    constexpr int kMinMatch = 3, kMaxMatch = 4096;
    for (size_t i = 0; i < npx;) {
        int best_len = 0, best_code = 0;
        const size_t dists[2] = {1, size_t(w)};
        const int dcodes[2] = {2, 1};
        for (int k = 0; k < 2; k++) {
            const size_t d = dists[k];
            if (i < d) continue;
            int len = 0;
            while (i + size_t(len) < npx && len < kMaxMatch &&
                   res[i + size_t(len)] == res[i + size_t(len) - d])
                len++;
            if (len > best_len) {
                best_len = len;
                best_code = dcodes[k];
            }
        }
        if (best_len >= kMinMatch) {
            tokens.push_back({0, best_len, best_code});
            i += size_t(best_len);
        } else {
            tokens.push_back({res[i], 0, 0});
            i++;
        }
    }
    BitWriter bw;
    bw.put(0x2f, 8);
    bw.put(u32(w - 1), 14);
    bw.put(u32(h - 1), 14);
    bw.put(0, 1);                        // alpha unused
    bw.put(0, 3);                        // version
    bw.put(1, 1);
    bw.put(kSubtractGreen, 2);
    bw.put(1, 1);
    bw.put(kPredictor, 2);
    bw.put(u32(bits - 2), 3);
    bw.put(0, 1);                        // the mode image: no color cache
    write_image(bw, literals(modes));
    bw.put(0, 1);                        // no more transforms
    bw.put(0, 1);                        // no color cache
    bw.put(0, 1);                        // no meta prefix codes
    write_image(bw, tokens);
    bw.flush();
    return std::move(bw.out);
}

void set_error(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) std::snprintf(err, size_t(errlen), "%s", msg);
}

}  // namespace

extern "C" {

// A VP8L chunk's payload (data: n bytes to the end of the buffer libwebp
// decodes), whose header must give (w, h) -> (h, w, 3) RGB and, where
// alpha is not null, the (h, w) alpha plane.  Returns 0, or -1 with the
// reason in err.
int webp_decode_vp8l(const uint8_t* data, long long n, int w, int h,
                     uint8_t* rgb, uint8_t* alpha, char* err, int errlen) {
    try {
        VP8LDecoder dec(data, size_t(n));
        int width = 0, height = 0;
        std::vector<u32> argb = dec.decode_image(&width, &height);
        if (width != w || height != h)
            fail("VP8L size differs from the container's");
        for (size_t i = 0; i < argb.size(); i++) {
            rgb[3 * i] = u8(argb[i] >> 16);
            rgb[3 * i + 1] = u8(argb[i] >> 8);
            rgb[3 * i + 2] = u8(argb[i]);
            if (alpha) alpha[i] = u8(argb[i] >> 24);
        }
        return 0;
    } catch (const Fail& f) {
        set_error(err, errlen, f.msg);
        return -1;
    } catch (const std::bad_alloc&) {
        set_error(err, errlen, "out of memory");
        return -1;
    }
}

// A VP8 key frame of size (w, h) (data: n bytes from the chunk's payload
// to the end of the buffer libwebp decodes; chunk: the payload's declared
// size) -> (h, w, 3) RGB; an ALPH chunk's payload (alph_n >= 0) is decoded
// (into alpha where it is not null) and must be valid, as it must be for
// libwebp.  Returns 0, or -1 with the reason in err.
int webp_decode_vp8(const uint8_t* data, long long n, long long chunk,
                    const uint8_t* alph, long long alph_n, int w, int h,
                    uint8_t* rgb, uint8_t* alpha, char* err, int errlen) {
    try {
        VP8Decoder dec;
        dec.decode(data, size_t(n), size_t(chunk));
        if (dec.width_ != w || dec.height_ != h)
            fail("VP8 size differs from the container's");
        if (alph_n >= 0) {
            std::vector<u8> scratch;
            u8* a = alpha;
            if (!a) {
                scratch.resize(size_t(w) * size_t(h));
                a = scratch.data();
            }
            alph_decode(alph, size_t(alph_n), w, h, a);
        }
        vp8_to_rgb(dec, rgb);
        return 0;
    } catch (const Fail& f) {
        set_error(err, errlen, f.msg);
        return -1;
    } catch (const std::bad_alloc&) {
        set_error(err, errlen, "out of memory");
        return -1;
    }
}

// (h, w, 3) RGB -> a VP8L bitstream (header included) in out (cap bytes).
// Returns its size, or -2 - size when cap is too small.
long long webp_encode_vp8l(const uint8_t* rgb, int w, int h, uint8_t* out,
                           long long cap) {
    std::vector<u8> bytes = encode_vp8l(rgb, w, h);
    const long long n = (long long)bytes.size();
    if (n > cap) return -2 - n;
    std::memcpy(out, bytes.data(), bytes.size());
    return n;
}

}  // extern "C"
