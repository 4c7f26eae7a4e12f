// Self-check of fast_div.cuh on the card: fast_div::div_fast against the
// compiler's IEEE x / y on n operand pairs drawn from a counter hash of
// (seed, i).  |y| spans 2^-66..2^66 and |x / y| 2^-46..2^46, both past the
// range bounds on either side; signs and mantissas are random, and one
// operand in four takes an edge mantissa (0, 1, all ones, all ones - 1).
// counts (3 u64, zeroed by the caller): the quotients div_fast takes (both
// range checks pass), those among them that differ from x / y in any bit,
// and those left to the division.  Run by chip_smoke.py and
// tests/test_torch_cuda.py through ops/rasterize.fast_division_check.

#include <cuda_runtime.h>

#include <cstdint>

#include "fast_div.cuh"

namespace {

__device__ __forceinline__ uint32_t mix(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return (uint32_t)x;
}

// a float of unbiased exponent e from the hash h
__device__ float make_float(uint32_t h, int e) {
  const uint32_t edges[4] = {0u, 1u, 0x7fffffu, 0x7ffffeu};
  const uint32_t sel = (h >> 24) & 15u;
  const uint32_t m = sel < 4 ? edges[sel] : (h & 0x7fffffu);
  return __uint_as_float((h & 0x80000000u) | ((uint32_t)(e + 127) << 23) |
                         m);
}

__global__ void fast_div_check_kernel(unsigned long long n,
                                      unsigned long long seed,
                                      unsigned long long* counts) {
  unsigned long long taken = 0, differ = 0, left = 0;
  for (unsigned long long i =
           blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    const uint64_t key = (seed << 40) ^ (i * 4);
    const int ey = -66 + (int)(mix(key) % 133u);
    const int ex = ey - 46 + (int)(mix(key + 1) % 93u);
    const float y = make_float(mix(key + 2), ey);
    const float x = make_float(mix(key + 3), ex);
    const float q = fast_div::div_fast(x, y, fast_div::div_recip(y));
    if (fast_div::divisor_in_range(y) && fast_div::quotient_in_range(q)) {
      ++taken;
      differ += __float_as_uint(q) != __float_as_uint(x / y);
    } else {
      ++left;
    }
  }
  atomicAdd(counts, taken);
  atomicAdd(counts + 1, differ);
  atomicAdd(counts + 2, left);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int fast_div_check(unsigned long long n, unsigned long long seed,
                              unsigned long long* counts, void* stream) {
  fast_div_check_kernel<<<2048, 256, 0, (cudaStream_t)stream>>>(n, seed,
                                                                counts);
  return (int)cudaGetLastError();
}
