// Device routines shared by the package's kernels (ntt.cu, fused_ntt.cu,
// ip_kernel.cu, centered_fbc.cu, ntt_passes.cuh): 32-bit modular
// arithmetic.
//
// Residues are canonical in [0, q) with q < 2^31, so every sum and every
// Shoup remainder fits 32 bits.  Shoup multiply by a precomputed constant
// (w, ws = floor(w * 2^32 / q)) is exact for any 32-bit x, with one
// __umulhi and one conditional subtract: the same canonical result as the
// reference's 16-bit-emulated form on the TPU, with no emulation needed.
// Each conditional subtract is an unsigned min (when no subtract is due,
// the difference wraps above the value): one instruction fewer than a
// compare and a select, in kernels bound by integer issue.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace hetpu {

__device__ __forceinline__ uint32_t shoup_mul(uint32_t x, uint32_t w,
                                              uint32_t ws, uint32_t q) {
  const uint32_t qe = __umulhi(x, ws);
  const uint32_t r = x * w - qe * q;  // in [0, 2q), mod 2^32 arithmetic
  return min(r, r - q);
}

__device__ __forceinline__ uint32_t mod_add(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t s = a + b;
  return min(s, s - q);
}

__device__ __forceinline__ uint32_t mod_sub(uint32_t a, uint32_t b,
                                            uint32_t q) {
  const uint32_t d = a - b;
  return min(d, d + q);
}

// floor(c * 2^32 / q): the Shoup companion of a per-limb constant c < q,
// computed once per block.
__device__ __forceinline__ uint32_t shoup_of(uint32_t c, uint32_t q) {
  return static_cast<uint32_t>((static_cast<uint64_t>(c) << 32) / q);
}

__device__ __forceinline__ uint32_t mul_mod(uint32_t a, uint32_t b,
                                            uint32_t q) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) % q);
}

}  // namespace hetpu
