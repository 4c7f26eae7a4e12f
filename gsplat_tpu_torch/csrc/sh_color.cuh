// Degree-2 SH color for the rasterizer kernels (rasterize_fwd.cu,
// rasterize_bwd.cu): the per-pixel basis of
// gsplat_tpu/ops/rasterize.py::_sh_pixel_basis (:196-225) and the per-pair
// color sigmoid(coeff . basis) of _chunk_colors (:317-332).
//
// The backward divides by 1 - alpha + 1e-7, so it must recompute the
// forward's colors bit for bit.  Both kernels include this one definition,
// and every operation is an explicit round-to-nearest intrinsic, so nvcc
// can neither contract nor reorder it differently in the two kernels.
// The basis repeats the f32 expressions of the plain twin
// (gsplat_tpu_torch/ops/rasterize.py::_sh_pixel_basis); the dot product is
// nine f32 FMAs in order k = 0..8 (JAX contracts it at Precision.HIGHEST,
// full f32; the plain twin sums separately rounded products in the same
// order).

#pragma once

namespace sh {

constexpr int kDim = 9;  // coefficients per channel
// gsplat_tpu/ops/sh.py:15-18, rounded to f32
constexpr float kC0 = 0.28209479177387814f;
constexpr float kC1 = 0.4886025119029199f;
constexpr float kC20 = 1.0925484305920792f;
constexpr float kC21 = -1.0925484305920792f;
constexpr float kC22 = 0.31539156525252005f;
constexpr float kC23 = -1.0925484305920792f;
constexpr float kC24 = 0.5462742152960396f;

// Basis of the pixel (fx, fy) on the padded grid from the camera's RayInfo
// vectors shv (4, 3) = [rays_o, lefttop, dx, dy], row-major.
__device__ __forceinline__ void pixel_basis(const float* __restrict__ shv,
                                            float fx, float fy,
                                            float b[kDim]) {
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    // lefttop + fx dx + fy dy - rays_o, in that order
    const float lx = __fadd_rn(shv[3 + k], __fmul_rn(fx, shv[6 + k]));
    c[k] = __fsub_rn(__fadd_rn(lx, __fmul_rn(fy, shv[9 + k])), shv[k]);
  }
  const float n = __fsqrt_rn(__fadd_rn(
      __fadd_rn(__fmul_rn(c[0], c[0]), __fmul_rn(c[1], c[1])),
      __fmul_rn(c[2], c[2])));
  const float inv = __fdiv_rn(1.0f, __fadd_rn(n, 1e-7f));  // gaussian.cu:858
  const float x = __fmul_rn(c[0], inv);
  const float y = __fmul_rn(c[1], inv);
  const float z = __fmul_rn(c[2], inv);
  const float xx = __fmul_rn(x, x), yy = __fmul_rn(y, y), zz = __fmul_rn(z, z);
  b[0] = kC0;
  b[1] = __fmul_rn(-kC1, y);
  b[2] = __fmul_rn(kC1, z);
  b[3] = __fmul_rn(-kC1, x);
  b[4] = __fmul_rn(__fmul_rn(kC20, x), y);
  b[5] = __fmul_rn(__fmul_rn(kC21, y), z);
  b[6] = __fmul_rn(kC22, __fsub_rn(__fsub_rn(__fmul_rn(2.0f, zz), xx), yy));
  b[7] = __fmul_rn(__fmul_rn(kC23, x), z);
  b[8] = __fmul_rn(kC24, __fsub_rn(xx, yy));
}

// One channel's color: sigmoid of its nine coefficients against the basis.
__device__ __forceinline__ float channel(const float* __restrict__ coef,
                                         const float b[kDim]) {
  float logit = __fmul_rn(coef[0], b[0]);
#pragma unroll
  for (int k = 1; k < kDim; ++k) logit = __fmaf_rn(coef[k], b[k], logit);
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-logit)));
}

}  // namespace sh
