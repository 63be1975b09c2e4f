// Device routines shared by the package's kernels (ntt.cu, fused_ntt.cu,
// ip_kernel.cu, ntt_passes.cuh): 32-bit modular arithmetic, and the
// radix-2 shared-memory forward NTT of one plane that the `ntt_fwd_lifted`
// kernel runs (the `ntt` and `ntt_fwd_fbc` kernels run ntt_passes.cuh).
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

// Forward negacyclic NTT of the n = 2^logn residues in s (natural order →
// bit-reversed), Cooley-Tukey with twiddles w[m + i] / ws[m + i] — the
// flat loop of the reference's ntt.ntt_fwd.  The caller synchronises the
// block after filling s; the routine ends synchronised.
__device__ __forceinline__ void ntt_fwd_smem(uint32_t* s, int logn,
                                             const uint32_t* __restrict__ w,
                                             const uint32_t* __restrict__ ws,
                                             uint32_t q) {
  const int nb = 1 << (logn - 1);  // butterflies per stage
  int log_half = logn - 1;
  for (int m = 1; m < (1 << logn); m <<= 1, --log_half) {
    const int half_mask = (1 << log_half) - 1;
    for (int k = threadIdx.x; k < nb; k += blockDim.x) {
      const int i = k >> log_half;
      const int i0 = (i << (log_half + 1)) + (k & half_mask);
      const int i1 = i0 + (1 << log_half);
      const uint32_t u = s[i0];
      const uint32_t v = shoup_mul(s[i1], w[m + i], ws[m + i], q);
      s[i0] = mod_add(u, v, q);
      s[i1] = mod_sub(u, v, q);
    }
    __syncthreads();
  }
}

// Write the plane to global memory, times the epilogue constant
// c1[row] (* c2[row]) mod q when c1 is given.
__device__ __forceinline__ void store_plane(const uint32_t* s, uint32_t* out,
                                            int logn, const uint32_t* c1,
                                            const uint32_t* c2, int row,
                                            uint32_t q) {
  const int n = 1 << logn;
  if (c1 == nullptr) {
    for (int k = threadIdx.x; k < n; k += blockDim.x) out[k] = s[k];
    return;
  }
  uint32_t c = c1[row];
  if (c2 != nullptr) c = mul_mod(c, c2[row], q);
  const uint32_t cs = shoup_of(c, q);
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    out[k] = shoup_mul(s[k], c, cs, q);
}

// Threads per plane block: one butterfly pair per thread up to 1024.
inline int plane_threads(int logn) {
  const int nb = 1 << (logn - 1);
  return nb < 1024 ? nb : 1024;
}

inline size_t plane_smem(int logn) {
  return sizeof(uint32_t) << logn;
}

}  // namespace hetpu
