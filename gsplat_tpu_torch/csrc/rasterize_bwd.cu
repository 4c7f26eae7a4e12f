// Backward tile rasterizer for Hopper (sm_90a): per-pair gradients of the
// front-to-back alpha compositing of rasterize_fwd.cu.
//
// Replaces the TPU kernel gsplat_tpu/ops/rasterize.py::_bwd_kernel in its
// f32, RGB variant, and computes what it computes.  For each pixel with
// cotangent g = (g_r, g_g, g_b, g_w) on the forward's out = (sum w r,
// sum w g, sum w b, sum w), walking the tile's pairs front to back:
//   recompute alpha and T exactly as rasterize_fwd.cu does (sequential
//     product, expf, fminf(prob * opa, 0.9999), stop at T < 1e-4 tested
//     before the pair);
//   gc_dot  = g_r r + g_g g + g_b b + g_w    (sum w is a 4th color == 1)
//   carry  += w * gc_dot                     (inclusive: the JAX ccarry)
//   d_alpha = gc_dot T - (g.out - carry) / (1 - alpha + 1e-7)
//             (the suffix-color identity, rasterize.py:585-611), zero where
//             prob * opa >= 0.9999 (no gradient through the clamp)
//   d_opa   = d_alpha prob;  d(x, y, a, b, c, d) = d_alpha opa dprob/d(.)
//             (rasterize.py:616-638; b and c stay separate columns)
//   d(r, g, b) = g_(r, g, b) w
// and sums the 10 values of each pair over the tile's pixels.  Depth gets
// no gradient and column 7 of grad_geom is never written.
//
// Layout (gsplat_tpu_torch/ops/binning.py::pack_sorted):
//   geom       (P, 8) f32  [x, y, a, b, c, d, opa, 0], tile-then-depth order
//   color      (P, 3) f32
//   tile_start (T+1)  i32  tile t owns pairs [tile_start[t], tile_start[t+1])
//   out, grad_out (T, 4, Px) f32, rows 0-2 color, row 3 sum of weights
//   grad_geom  (P, 8) f32, grad_color (P, 3) f32: zeroed by the caller
//
// Design: the forward's shape.  One block per tile, one thread per pixel;
// the block stages blockDim.x pairs at a time in shared memory and every
// thread walks them for its pixel, keeping its own T and its carry across
// batches.  Each pair's 10 values are summed over a warp with shuffles;
// lane 0 of each warp parks its partial sums in shared memory, and after
// every round of kSub pairs the block adds the warps' partials and writes
// the pair's row.  One block owns its tile's pairs, so rows are written
// with no global atomics and the result does not depend on block order.
// A stopped thread still reaches every barrier and every shuffle and
// contributes zeros.  The block leaves when every pixel has stopped; the
// rows of the pairs it never reaches keep the caller's zeros.
//
// What bounds it on an H100: at the bench view (~1M pairs, 4,346 tiles of
// 256 pixels) it reads ~44 MB of pairs and ~36 MB of out and grad_out, and
// evaluates ~256M pair-pixels, an expf, a division and ~60 flops each, plus
// 50 warp shuffles per pair and warp for the reduction.  Bytes (~25 us at
// 3.35 TB/s) do not bound it; the per-pair shuffle reduction and latency
// (one 256-thread block per tile, a dependent chain per pair, two barriers
// per kSub pairs) do.  Making it fast (fewer reductions per pair,
// warp-per-subtile) is later work; this version is simple and right.

#include <cuda_runtime.h>

namespace {

constexpr float kStopThresh = 1e-4f;  // rasterize.py STOP_THRESH
constexpr float kDetEps = 1e-14f;     // rasterize.py DET_EPS
constexpr float kAlphaMax = 0.9999f;  // rasterize.py:247
constexpr float kAlphaEps = 1e-7f;    // rasterize.py:611 ALPHA_EPS
constexpr int kSub = 32;              // pairs per reduction round
constexpr int kVals = 10;             // d(x, y, a, b, c, d, opa), d(r, g, b)
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void rasterize_bwd_kernel(
    const float* __restrict__ geom, const float* __restrict__ color,
    const int* __restrict__ tile_start, const float* __restrict__ out,
    const float* __restrict__ grad_out, float* __restrict__ grad_geom,
    float* __restrict__ grad_color, int n_tile_x, int tile_w, int padded_w,
    int padded_h, float focal_x, float focal_y) {
  extern __shared__ float4 smem[];
  const int batch = blockDim.x;
  const int n_warps = batch / 32;
  float4* s_g0 = smem;                              // x, y, a, b
  float4* s_g1 = smem + batch;                      // c, d, opa, 0
  float* s_col = reinterpret_cast<float*>(smem + 2 * batch);  // r, g, b
  float* s_part = s_col + 3 * batch;                // [kSub][kVals][n_warps]

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tx = t % n_tile_x;
  const int ty = t / n_tile_x;
  const int id_x = tx * tile_w + p % tile_w;
  const int id_y = ty * (blockDim.x / tile_w) + p / tile_w;
  // pixel centre on the PADDED grid (rasterize.py:174-183), as the forward
  const float pxc = ((float)id_x + 0.5f - 0.5f * (float)padded_w) / focal_x;
  const float pyc = ((float)id_y + 0.5f - 0.5f * (float)padded_h) / focal_y;

  const size_t o = (size_t)t * 4 * batch + p;
  const float g_r = grad_out[o];
  const float g_g = grad_out[o + batch];
  const float g_b = grad_out[o + 2 * batch];
  const float g_w = grad_out[o + 3 * batch];
  const float gdotout = g_r * out[o] + g_g * out[o + batch] +
                        g_b * out[o + 2 * batch] + g_w * out[o + 3 * batch];

  const int start = tile_start[t];
  const int end = tile_start[t + 1];

  float trans = 1.0f;
  float carry = 0.0f;
  int done = 0;

  for (int base = start; base < end; base += batch) {
    // Every thread reaches this barrier, done or not.  It also keeps the
    // previous batch's readers ahead of the writes below.
    if (__syncthreads_count(done) == blockDim.x) break;
    const int i = base + p;
    if (i < end) {
      const float4* g = reinterpret_cast<const float4*>(geom) + 2 * i;
      s_g0[p] = g[0];
      s_g1[p] = g[1];
      s_col[3 * p + 0] = color[3 * i + 0];
      s_col[3 * p + 1] = color[3 * i + 1];
      s_col[3 * p + 2] = color[3 * i + 2];
    }
    __syncthreads();
    const int n = min(batch, end - base);
    for (int k0 = 0; k0 < n; k0 += kSub) {
      const int kn = min(kSub, n - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
        float v[kVals];
#pragma unroll
        for (int f = 0; f < kVals; ++f) v[f] = 0.0f;
        // the forward's stop: T tested BEFORE the pair (rasterize.py:490-492)
        if (!done && trans < kStopThresh) done = 1;
        if (!done) {
          // the forward kernel's arithmetic, operation for operation
          const float4 g0 = s_g0[k];
          const float4 g1 = s_g1[k];
          const float a = g0.z, b = g0.w, c = g1.x, d = g1.y, opa = g1.z;
          const float dx = pxc - g0.x;
          const float dy = pyc - g0.y;
          const float det = a * d - b * c;
          const float pn = 2.0f * det + kDetEps;
          const float pm = -(d * dx * dx - (b + c) * dx * dy + a * dy * dy);
          const float prob = expf(pm / pn);
          const float alpha = fminf(prob * opa, kAlphaMax);
          const float w = alpha * trans;

          const float gc_dot = g_r * s_col[3 * k + 0] +
                               g_g * s_col[3 * k + 1] +
                               g_b * s_col[3 * k + 2] + g_w;
          carry += w * gc_dot;
          float d_alpha = gc_dot * trans -
                          (gdotout - carry) / ((1.0f - alpha) + kAlphaEps);
          if (!(prob * opa < kAlphaMax)) d_alpha = 0.0f;
          const float d_prob = d_alpha * opa;
          const float inv_pn2 = 1.0f / (pn * pn);
          v[0] = d_prob * (prob / pn * (2.0f * d * dx - (b + c) * dy));
          v[1] = d_prob * (prob / pn * (2.0f * a * dy - (b + c) * dx));
          v[2] = d_prob * (prob * ((-dy * dy) * pn - (2.0f * d) * pm) * inv_pn2);
          v[3] = d_prob * (prob * ((dx * dy) * pn - (-2.0f * c) * pm) * inv_pn2);
          v[4] = d_prob * (prob * ((dx * dy) * pn - (-2.0f * b) * pm) * inv_pn2);
          v[5] = d_prob * (prob * ((-dx * dx) * pn - (2.0f * a) * pm) * inv_pn2);
          v[6] = d_alpha * prob;
          v[7] = g_r * w;
          v[8] = g_g * w;
          v[9] = g_b * w;
          trans *= (1.0f - alpha);
        }
        // sum over the warp's 32 pixels; every lane takes part
#pragma unroll
        for (int f = 0; f < kVals; ++f) {
          float x = v[f];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            x += __shfl_xor_sync(kFullMask, x, off);
          v[f] = x;
        }
        if (lane == 0) {
#pragma unroll
          for (int f = 0; f < kVals; ++f)
            s_part[(kk * kVals + f) * n_warps + warp] = v[f];
        }
      }
      __syncthreads();
      // add the warps' partials and write each pair's row (one writer each)
      for (int e = p; e < kn * kVals; e += blockDim.x) {
        const float* src = s_part + e * n_warps;
        float s = 0.0f;
        for (int w = 0; w < n_warps; ++w) s += src[w];
        const int kk = e / kVals;
        const int f = e - kk * kVals;
        const size_t row = (size_t)(base + k0 + kk);
        if (f < 7) {
          grad_geom[row * 8 + f] = s;
        } else {
          grad_color[row * 3 + (f - 7)] = s;
        }
      }
      __syncthreads();   // s_part is refilled by the next round
    }
    if (trans < kStopThresh) done = 1;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Needs tile_h * tile_w a multiple of 32 and at most 1024.
extern "C" int rasterize_bwd(const float* geom, const float* color,
                             const int* tile_start, const float* out,
                             const float* grad_out, float* grad_geom,
                             float* grad_color, int n_tiles, int n_tile_x,
                             int tile_h, int tile_w, int padded_w,
                             int padded_h, float focal_x, float focal_y,
                             void* stream) {
  const int px = tile_h * tile_w;
  const size_t smem = (size_t)px * (2 * sizeof(float4) + 3 * sizeof(float)) +
                      (size_t)kSub * kVals * (px / 32) * sizeof(float);
  rasterize_bwd_kernel<<<n_tiles, px, smem, (cudaStream_t)stream>>>(
      geom, color, tile_start, out, grad_out, grad_geom, grad_color, n_tile_x,
      tile_w, padded_w, padded_h, focal_x, focal_y);
  return (int)cudaGetLastError();
}
