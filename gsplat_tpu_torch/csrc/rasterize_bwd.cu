// Backward tile rasterizer for Hopper (sm_90a): per-pair gradients of the
// front-to-back alpha compositing of rasterize_fwd.cu.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize.py::_bwd_kernel in its
// f32 RGB variant (entry point rasterize_bwd) and its f32 SH variant
// (rasterize_bwd_sh, color_dim 27: :594-609, :646-657), and computes what it
// computes.  For each pixel with cotangent g = (g_r, g_g, g_b, g_w) on the
// forward's out = (sum w C_r, sum w C_g, sum w C_b, sum w), walking the
// tile's pairs front to back:
//   recompute alpha, T and the colors C exactly as rasterize_fwd.cu does
//     (sequential product, expf, fminf(prob * opa, 0.9999), stop at
//     T < 1e-4 tested before the pair; SH colors from sh_color.cuh, the
//     forward's own code);
//   gc_dot  = g_r C_r + g_g C_g + g_b C_b + g_w  (sum w is a 4th color == 1)
//   carry  += w * gc_dot                     (inclusive: the JAX ccarry)
//   d_alpha = gc_dot T - (g.out - carry) / (1 - alpha + 1e-7)
//             (the suffix-color identity, rasterize.py:585-611), zero where
//             prob * opa >= 0.9999 (no gradient through the clamp)
//   d_opa   = d_alpha prob;  d(x, y, a, b, c, d) = d_alpha opa dprob/d(.)
//             (rasterize.py:616-638; b and c stay separate columns)
//   RGB: d(r, g, b) = g_(r, g, b) w
//   SH:  d coeff(ch, k) = g_ch w C_ch (1 - C_ch) basis_k
// and sums each pair's 7 + 3 (RGB) or 7 + 27 (SH) values over the tile's
// pixels.  Depth gets no gradient and column 7 of grad_geom is never
// written.
//
// Layout (gsplat_tpu_torch/ops/binning.py::pack_sorted):
//   geom       (P, 8) f32  [x, y, a, b, c, d, opa, 0], tile-then-depth order
//   color      (P, 3) f32 RGB; SH: (P, 27) f32, channel-major 3 x 9
//   tile_start (T+1)  i32  tile t owns pairs [tile_start[t], tile_start[t+1])
//   shv        (4, 3) f32 [rays_o, lefttop, dx, dy] on the device (SH only)
//   out, grad_out (T, 4, Px) f32, rows 0-2 color, row 3 sum of weights
//   grad_geom  (P, 8) f32, grad_color (P, 3 or 27) f32: zeroed by the caller
//
// Design.  One block per tile; each thread owns kP pixels of it, P = 4
// (RGB) or 2 (SH), p = thread + j * blockDim.x, so a block has
// 32 * ceil(Px / (32 P)) threads: for a 16x16 tile two warps (RGB) or four
// (SH).  Pixel slots past the tile's end start stopped, so any tile of at
// most 1024 pixels launches.  Every pixel keeps its own T, carry, stop
// flag, centre, cotangent and g.out in registers (SH: also its 9 basis
// values, which is why SH takes 2 pixels: at 4 too few warps fit an SM).
// The block stages kBatch = 64 pairs at a time in shared memory and walks
// them in rounds of kSub = 32.  For each pair a thread first adds its
// pixels' values in registers, with plain FMAs and no shuffles.  The pixel
// body has no branch (a stopped pixel computes and adds zeros, chosen by a
// select), so the compiler interleaves the P pixels' work; a warp whose
// pixels have all stopped skips the pair.  Then the warp sums the values
// with a reduce-scatter (warp_reduce_scatter): at each lane distance 16, 8,
// 4, 2, 1 a lane sends its partner the half of its values the partner
// keeps and adds the half it gets, so V values cost about V shuffles, not
// the 5 V of a butterfly per value, and the finished sums land on
// different lanes, which park them in shared memory in parallel.  RGB pads
// its 10 values to 16 (16 shuffles a warp); SH reduce-scatters 32 values
// (31) and then 2 (5), 36 a warp.  By construction, per pair and 16x16
// tile: 32 shuffles (RGB, 2 warps) and 144 (SH, 4 warps).  After each
// round the block adds the warps' partials in warp order and writes each
// pair's row: one writer per row, no atomics, so the result does not
// depend on block order and two launches agree bit for bit.  The partials
// are double-buffered, so a round costs one barrier; a batch costs two
// more (the exit test, the staging).  The block leaves when every pixel
// has stopped; the rows of the pairs it never reaches keep the caller's
// zeros, and empty tiles own no rows.  The division of d_alpha is
// __fdividef (2 ulp): it is the gradient's, not the forward's, and the
// plain version's IEEE quotient is within the tolerance.
//
// Shared memory per block: kBatch x (32 B geometry + 4 kC B color) + 2 x
// warps x kSub x (7 + kC) x 4 B; for a 16x16 tile 7,936 B (RGB) and
// 43,776 B (SH).  ptxas (CUDA 12.8, sm_90a): 92 registers (RGB) and 127
// (SH; __launch_bounds__ caps it at 128), no spills.
//
// What bounds it on an H100: at the bench view (~1M pairs, 4,346 tiles of
// 256 pixels) it reads ~44 MB of pairs (~140 MB for SH) and ~36 MB of out
// and grad_out: ~25-55 us at 3.35 TB/s, not the bound.  Instruction issue
// is: the hot path issues ~455 instructions a pair and warp (RGB, 4
// pixels) and ~680 (SH, 2 pixels) -- an expf and an IEEE division (with
// its slow-path check) a pixel, SH three sigmoids and 27 + 27 FMAs more --
// ~0.9G (RGB) and ~2.7G (SH) warp instructions at that view, issued in
// 1.20 and 3.45 ms at ~75% of 4 a cycle per SM (132 SMs at 1.98 GHz, the
// clock behind the data sheet's 67 TFLOP/s).  The shuffles are 3-5% of
// it.

#include <cuda_runtime.h>

#include "sh_color.cuh"

namespace {

constexpr float kStopThresh = 1e-4f;  // rasterize.py STOP_THRESH
constexpr float kDetEps = 1e-14f;     // rasterize.py DET_EPS
constexpr float kAlphaMax = 0.9999f;  // rasterize.py:247
constexpr float kAlphaEps = 1e-7f;    // rasterize.py:611 ALPHA_EPS
constexpr int kBatch = 64;            // pairs staged in shared memory
constexpr int kSub = 32;              // pairs per reduction round
constexpr int kGeomVals = 7;          // d(x, y, a, b, c, d, opa)
constexpr unsigned kFullMask = 0xffffffffu;

// color floats per pair: RGB 3, SH 27
template <bool kSh>
constexpr int kColorFloats = kSh ? 3 * sh::kDim : 3;
// pixels a thread: SH keeps 9 basis values a pixel in registers, and at 4
// pixels too few warps fit an SM
template <bool kSh>
constexpr int kPixels = kSh ? 2 : 4;

// Sums kN values (a power of two, at most 32) over the warp's 32 lanes and
// leaves in v[0] of lane l the sum of value l / (32 / kN).  At lane
// distance kOff a lane keeps the upper half of its values if its kOff bit
// is set, else the lower half, sends the other half to its partner and
// adds what the partner sends; once one value is left, the remaining
// distances add it butterfly-wise.  kN - 1 + 5 - log2(kN) shuffles: 16
// values 16, 32 values 31, 2 values 5.
template <int kN, int kOff = 16>
__device__ __forceinline__ void warp_reduce_scatter(float* v, int lane) {
  if constexpr (kOff > 0) {
    if constexpr (kN > 1) {
      constexpr int kHalf = kN / 2;
      const bool upper = (lane & kOff) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = upper ? v[i] : v[i + kHalf];
        const float keep = upper ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(kFullMask, send, kOff);
      }
      warp_reduce_scatter<kHalf, kOff / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFullMask, v[0], kOff);
      warp_reduce_scatter<1, kOff / 2>(v, lane);
    }
  }
}

template <bool kSh>
__global__ void __launch_bounds__(1024 / kPixels<kSh>) rasterize_bwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ color,
    const int* __restrict__ tile_start, const float* __restrict__ shv,
    const float* __restrict__ out, const float* __restrict__ grad_out,
    float* __restrict__ grad_geom, float* __restrict__ grad_color,
    int n_tile_x, int tile_h, int tile_w, int padded_w, int padded_h,
    float focal_x, float focal_y) {
  constexpr int kP = kPixels<kSh>;
  constexpr int kC = kColorFloats<kSh>;
  constexpr int kVals = kGeomVals + kC;                 // 10 or 34
  constexpr int kHead = kSh ? 32 : 16;                  // first block
  constexpr int kTail = kVals > kHead ? kVals - kHead : 0;  // SH: 2 more
  constexpr unsigned kAll = (1u << kP) - 1;
  extern __shared__ float4 smem[];
  const int nt = blockDim.x;
  const int px = tile_h * tile_w;
  float4* s_g0 = smem;                                  // x, y, a, b
  float4* s_g1 = smem + kBatch;                         // c, d, opa, 0
  float* s_col = reinterpret_cast<float*>(smem + 2 * kBatch);  // kC a pair
  float* s_part = s_col + kBatch * kC;  // 2 x [warps][kSub][kVals]
  const int part_len = (nt / 32) * kSub * kVals;

  const int t = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = t % n_tile_x;
  const int ty = t / n_tile_x;

  float pxc[kP], pyc[kP], g_c[kP][3], g_w[kP], gdotout[kP];
  float trans[kP], carry[kP];
  float basis[kSh ? kP : 1][sh::kDim];
  unsigned done = 0;  // bit j: pixel j has stopped
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    const int p = tid + j * nt;
    trans[j] = 1.0f;
    carry[j] = 0.0f;
    if (p >= px) {  // a slot past the tile's end
      done |= 1u << j;
      pxc[j] = pyc[j] = g_w[j] = gdotout[j] = 0.0f;
      g_c[j][0] = g_c[j][1] = g_c[j][2] = 0.0f;
      if constexpr (kSh) {
#pragma unroll
        for (int i = 0; i < sh::kDim; ++i) basis[j][i] = 0.0f;
      }
      continue;
    }
    const int id_x = tx * tile_w + p % tile_w;
    const int id_y = ty * tile_h + p / tile_w;
    // pixel centre on the PADDED grid (rasterize.py:174-183), as the forward
    pxc[j] = ((float)id_x + 0.5f - 0.5f * (float)padded_w) / focal_x;
    pyc[j] = ((float)id_y + 0.5f - 0.5f * (float)padded_h) / focal_y;
    if constexpr (kSh) {
      sh::pixel_basis(shv, (float)id_x, (float)id_y, basis[j]);
    }
    const size_t o = (size_t)t * 4 * px + p;
    g_c[j][0] = grad_out[o];
    g_c[j][1] = grad_out[o + px];
    g_c[j][2] = grad_out[o + 2 * px];
    g_w[j] = grad_out[o + 3 * px];
    gdotout[j] = g_c[j][0] * out[o] + g_c[j][1] * out[o + px] +
                 g_c[j][2] * out[o + 2 * px] + g_w[j] * out[o + 3 * px];
  }

  const int start = tile_start[t];
  const int end = tile_start[t + 1];
  int round = 0;

  for (int base = start; base < end; base += kBatch) {
    // Every thread reaches this barrier, its pixels stopped or not.  It
    // also keeps the previous batch's readers ahead of the writes below.
    if (__syncthreads_count(done == kAll) == nt) break;
    const int n = min(kBatch, end - base);
    for (int i = tid; i < n; i += nt) {
      const float4* g = reinterpret_cast<const float4*>(geom) +
                        2 * (size_t)(base + i);
      s_g0[i] = g[0];
      s_g1[i] = g[1];
    }
    const float* src = color + (size_t)base * kC;
    for (int i = tid; i < n * kC; i += nt) s_col[i] = src[i];
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += kSub, ++round) {
      const int kn = min(kSub, n - k0);
      float* part = s_part + (round & 1) * part_len;
      float* mine = part + warp * kSub * kVals;
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
        const float4 g0 = s_g0[k];
        const float4 g1 = s_g1[k];
        const float a = g0.z, b = g0.w, c = g1.x, d = g1.y, opa = g1.z;
        const float det = a * d - b * c;
        const float pn = 2.0f * det + kDetEps;
        // per-pair factors of the gradients (the recomputed forward keeps
        // its own operations below)
        const float inv_pn = 1.0f / pn;
        const float inv_pn2 = inv_pn * inv_pn;
        const float a2 = 2.0f * a, b2 = 2.0f * b, c2 = 2.0f * c;
        const float d2 = 2.0f * d, bc = b + c;
        float rgb[3];
        if constexpr (!kSh) {
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) rgb[ch] = s_col[3 * k + ch];
        }
        float v[kHead + kTail];
#pragma unroll
        for (int f = 0; f < kHead + kTail; ++f) v[f] = 0.0f;
        // A warp whose pixels have all stopped skips the pair.  Otherwise
        // no pixel branches, so the compiler interleaves the kP pixels' work:
        // a stopped pixel runs the arithmetic too and adds zeros.
        if (__any_sync(kFullMask, done != kAll)) {
#pragma unroll
          for (int j = 0; j < kP; ++j) {
            // the forward's stop: T tested BEFORE the pair (rasterize.py:490)
            if (trans[j] < kStopThresh) done |= 1u << j;
            const bool live = !(done & (1u << j));
            // the forward kernel's arithmetic, operation for operation
            const float dx = pxc[j] - g0.x;
            const float dy = pyc[j] - g0.y;
            const float pm =
                -(d * dx * dx - (b + c) * dx * dy + a * dy * dy);
            const float prob = expf(pm / pn);
            const float alpha = fminf(prob * opa, kAlphaMax);
            const float w = alpha * trans[j];

            float col[3];
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              if constexpr (kSh) {
                col[ch] =
                    sh::channel(s_col + kC * k + sh::kDim * ch, basis[j]);
              } else {
                col[ch] = rgb[ch];
              }
            }
            const float gc_dot = g_c[j][0] * col[0] + g_c[j][1] * col[1] +
                                 g_c[j][2] * col[2] + g_w[j];
            carry[j] += w * gc_dot;
            // the gradient's own division may round: __fdividef (2 ulp)
            float d_alpha =
                gc_dot * trans[j] - __fdividef(gdotout[j] - carry[j],
                                               (1.0f - alpha) + kAlphaEps);
            if (!(prob * opa < kAlphaMax)) d_alpha = 0.0f;
            // d_opa = d_alpha prob; d_prob prob / pn (x, y) and
            // d_prob prob / pn^2 (a, b, c, d) times their polynomials.
            // Selects, not products, zero a stopped pixel (its prob may
            // overflow).
            const float dpr = live ? d_alpha * prob : 0.0f;
            const float wl = live ? w : 0.0f;
            const float q = dpr * opa;
            const float q1 = q * inv_pn;
            const float q2 = q * inv_pn2;
            const float dxdy_pn = dx * dy * pn;
            v[0] += q1 * (d2 * dx - bc * dy);
            v[1] += q1 * (a2 * dy - bc * dx);
            v[2] += q2 * (-(dy * dy) * pn - d2 * pm);
            v[3] += q2 * (dxdy_pn + c2 * pm);
            v[4] += q2 * (dxdy_pn + b2 * pm);
            v[5] += q2 * (-(dx * dx) * pn - a2 * pm);
            v[6] += dpr;
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) {
              if constexpr (kSh) {
                // d logits = g_c w C (1 - C); d coeff = d logits * basis
                const float dlog =
                    g_c[j][ch] * wl * col[ch] * (1.0f - col[ch]);
#pragma unroll
                for (int i = 0; i < sh::kDim; ++i)
                  v[kGeomVals + sh::kDim * ch + i] += dlog * basis[j][i];
              } else {
                v[kGeomVals + ch] += g_c[j][ch] * wl;
              }
            }
            trans[j] *= (1.0f - alpha);
          }
        }
        // the warp's sums, spread over its lanes; every lane takes part
        warp_reduce_scatter<kHead>(v, lane);
        constexpr int kSpan = 32 / kHead;  // lanes holding one sum
        if (lane % kSpan == 0 && lane / kSpan < kVals)
          mine[kk * kVals + lane / kSpan] = v[0];
        if constexpr (kTail > 0) {
          warp_reduce_scatter<kTail>(v + kHead, lane);
          constexpr int kTailSpan = 32 / kTail;
          if (lane % kTailSpan == 0)
            mine[kk * kVals + kHead + lane / kTailSpan] = v[kHead];
        }
      }
      __syncthreads();
      // add the warps' partials in warp order and write each pair's row
      // (one writer each); the other buffer takes the next round
      for (int e = tid; e < kn * kVals; e += nt) {
        float s = part[e];
        for (int i = kSub * kVals; i < part_len; i += kSub * kVals)
          s += part[i + e];
        const int kk = e / kVals;
        const int f = e - kk * kVals;
        const size_t row = (size_t)(base + k0 + kk);
        if (f < kGeomVals) {
          grad_geom[row * 8 + f] = s;
        } else {
          grad_color[row * kC + (f - kGeomVals)] = s;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kP; ++j)
      if (trans[j] < kStopThresh) done |= 1u << j;
  }
}

template <bool kSh>
int launch(const float* geom, const float* color, const int* tile_start,
           const float* shv, const float* out, const float* grad_out,
           float* grad_geom, float* grad_color, int n_tiles, int n_tile_x,
           int tile_h, int tile_w, int padded_w, int padded_h, float focal_x,
           float focal_y, void* stream) {
  constexpr int kC = kColorFloats<kSh>;
  constexpr int kP = kPixels<kSh>;
  const int px = tile_h * tile_w;
  if (px < 1 || px > 1024) return (int)cudaErrorInvalidValue;
  const int n_warps = (px + 32 * kP - 1) / (32 * kP);
  const size_t smem =
      kBatch * (2 * sizeof(float4) + kC * sizeof(float)) +
      2 * (size_t)n_warps * kSub * (kGeomVals + kC) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rasterize_bwd_kernel<kSh>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  rasterize_bwd_kernel<kSh>
      <<<n_tiles, 32 * n_warps, smem, (cudaStream_t)stream>>>(
          geom, color, tile_start, shv, out, grad_out, grad_geom, grad_color,
          n_tile_x, tile_h, tile_w, padded_w, padded_h, focal_x, focal_y);
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches on `stream` and returns cudaGetLastError() (0 on success).
// Arguments: geom, color, tile_start, shv (SH only, else null), out,
// grad_out, grad_geom, grad_color, then n_tiles, n_tile_x, tile_h, tile_w,
// padded_w, padded_h, focal_x, focal_y.  Takes any tile of at most 1024
// pixels.
#define GSPLAT_BWD_ENTRY(NAME, SH)                                          \
  extern "C" int NAME(const float* geom, const float* color,                \
                      const int* tile_start, const float* shv,              \
                      const float* out, const float* grad_out,              \
                      float* grad_geom, float* grad_color, int n_tiles,     \
                      int n_tile_x, int tile_h, int tile_w, int padded_w,   \
                      int padded_h, float focal_x, float focal_y,           \
                      void* stream) {                                       \
    return launch<SH>(geom, color, tile_start, shv, out, grad_out,          \
                      grad_geom, grad_color, n_tiles, n_tile_x, tile_h,     \
                      tile_w, padded_w, padded_h, focal_x, focal_y,         \
                      stream);                                              \
  }

GSPLAT_BWD_ENTRY(rasterize_bwd, false)
GSPLAT_BWD_ENTRY(rasterize_bwd_sh, true)
