// Kernel `centered_fbc`: the centered fast base conversion of S source
// residue planes to F destination primes,
//   v_i    = y_i - q_i if y_i > q_i / 2 else y_i            (signed, |v_i| < 2^30)
//   alpha  = rint(fma chain of f32(v_i) * f32(1/q_i), i = 0..S-1)   (optional)
//   out[f] = ((sum_i v_i * C[i, f] - alpha * P_f) * extra_f) mod q_f,
// canonical in [0, q_f).  Used by the key-switch digit lift (no alpha, no
// extra), the mod-down and the fused rescale tail (alpha).
//
// Replaces the JAX package's TPU kernel hetpu/core/mxu_fbc.py
// `_build_pallas_call` (:214).  On the TPU the contraction over i was split
// into int8 digits so that it could run on the matrix unit as one s8 matmul
// [4F, 4S+1] @ [4S+1, N] plus a two-Shoup fold.  The card has an exact 32-bit
// __umulhi, so the conversion here is the plain modular sum: one Shoup
// multiply per (i, f) by C[i, f] with its host-computed companion.  Any exact
// evaluation gives the reference's bits (tests/test_mxu_fbc.py pins the
// function against bigint math); alpha must be the same fma chain as the
// reference's jitted jnp.sum.
//
// Design: one thread per (row, column n).  The thread reads its S source
// values once (coalesced along n), centres them, keeps them in registers,
// computes alpha, then loops over f and writes out[row, f, n] (coalesced).
// A signed v_i needs no reduction first: the Shoup multiply takes any 32-bit
// |v_i|, and a negative term is subtracted instead of added; alpha * P_f
// likewise.  The constants (C and its companions, P_f, extra_f, the primes,
// the reciprocals) are a few hundred bytes and are staged in shared memory,
// read as broadcasts.
//
// Bound on the card: device-memory bytes, (S + F) * 4 per column and row
// (the fused tail at bench_n14 B=8, [8,2,6,N] -> [8,2,8,N], moves 14.7 MB:
// 4.4 us at 3.35 TB/s); S * F Shoup multiplies per column are far below the
// integer rate.  Measured times are in PERF.md.
#include "ntt_common.cuh"

namespace {

constexpr int kMaxS = 16;

__global__ void centered_fbc_kernel(const uint32_t* __restrict__ y,
                                    uint32_t* __restrict__ out, int S, int F,
                                    int n, const uint32_t* __restrict__ q_src,
                                    const float* __restrict__ recip,
                                    const uint32_t* __restrict__ c,
                                    const uint32_t* __restrict__ cs,
                                    const uint32_t* __restrict__ pm,
                                    const uint32_t* __restrict__ pms,
                                    const uint32_t* __restrict__ ex,
                                    const uint32_t* __restrict__ exs,
                                    const uint32_t* __restrict__ q_dst) {
  // shared layout: c[S*F] cs[S*F] pm[F] pms[F] ex[F] exs[F] q_dst[F]
  // q_src[S] recip[S]
  extern __shared__ uint32_t sm[];
  uint32_t* s_c = sm;
  uint32_t* s_cs = s_c + S * F;
  uint32_t* s_pm = s_cs + S * F;
  uint32_t* s_pms = s_pm + F;
  uint32_t* s_ex = s_pms + F;
  uint32_t* s_exs = s_ex + F;
  uint32_t* s_qd = s_exs + F;
  uint32_t* s_qs = s_qd + F;
  float* s_rc = reinterpret_cast<float*>(s_qs + S);
  const bool has_alpha = recip != nullptr;
  const bool has_extra = ex != nullptr;
  for (int k = threadIdx.x; k < S * F; k += blockDim.x) {
    s_c[k] = c[k];
    s_cs[k] = cs[k];
  }
  for (int k = threadIdx.x; k < F; k += blockDim.x) {
    s_pm[k] = has_alpha ? pm[k] : 0u;
    s_pms[k] = has_alpha ? pms[k] : 0u;
    s_ex[k] = has_extra ? ex[k] : 0u;
    s_exs[k] = has_extra ? exs[k] : 0u;
    s_qd[k] = q_dst[k];
  }
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    s_qs[k] = q_src[k];
    s_rc[k] = has_alpha ? recip[k] : 0.0f;
  }
  __syncthreads();

  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  const size_t row = blockIdx.y;
  const uint32_t* yr = y + row * S * static_cast<size_t>(n) + col;
  int v[kMaxS];
  float al = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxS; ++i) {
    if (i < S) {
      const uint32_t yi = yr[static_cast<size_t>(i) * n];
      const uint32_t qi = s_qs[i];
      v[i] = yi > (qi >> 1) ? -static_cast<int>(qi - yi) : static_cast<int>(yi);
      if (has_alpha) al = __fmaf_rn(__int2float_rn(v[i]), s_rc[i], al);
    }
  }
  const int alpha = has_alpha ? static_cast<int>(rintf(al)) : 0;
  const uint32_t abs_alpha = static_cast<uint32_t>(alpha < 0 ? -alpha : alpha);
  uint32_t* outr = out + row * F * static_cast<size_t>(n) + col;
  for (int f = 0; f < F; ++f) {
    const uint32_t qf = s_qd[f];
    uint32_t acc = 0;
#pragma unroll
    for (int i = 0; i < kMaxS; ++i) {
      if (i < S) {
        const uint32_t a = static_cast<uint32_t>(v[i] < 0 ? -v[i] : v[i]);
        const uint32_t m =
            hetpu::shoup_mul(a, s_c[i * F + f], s_cs[i * F + f], qf);
        acc = v[i] < 0 ? hetpu::mod_sub(acc, m, qf) : hetpu::mod_add(acc, m, qf);
      }
    }
    if (has_alpha) {
      const uint32_t m = hetpu::shoup_mul(abs_alpha, s_pm[f], s_pms[f], qf);
      acc = alpha < 0 ? hetpu::mod_add(acc, m, qf) : hetpu::mod_sub(acc, m, qf);
    }
    if (has_extra) acc = hetpu::shoup_mul(acc, s_ex[f], s_exs[f], qf);
    outr[static_cast<size_t>(f) * n] = acc;
  }
}

}  // namespace

// recip == nullptr: no alpha row (pm/pms unused); ex == nullptr: no extra.
extern "C" int hetpu_centered_fbc(const uint32_t* y, uint32_t* out, int rows,
                                  int S, int F, int n, const uint32_t* q_src,
                                  const float* recip, const uint32_t* c,
                                  const uint32_t* cs, const uint32_t* pm,
                                  const uint32_t* pms, const uint32_t* ex,
                                  const uint32_t* exs, const uint32_t* q_dst,
                                  cudaStream_t stream) {
  if (S < 1 || S > kMaxS || F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const dim3 grid(static_cast<unsigned>((n + threads - 1) / threads),
                  static_cast<unsigned>(rows));
  const size_t smem = sizeof(uint32_t) * (2 * S * F + 5 * F + 2 * S);
  centered_fbc_kernel<<<grid, threads, smem, stream>>>(
      y, out, S, F, n, q_src, recip, c, cs, pm, pms, ex, exs, q_dst);
  return static_cast<int>(cudaGetLastError());
}
