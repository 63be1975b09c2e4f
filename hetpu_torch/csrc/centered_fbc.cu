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
// [4F, 4S+1] @ [4S+1, N] plus a two-Shoup fold.  The card multiplies 32-bit
// integers into 64 bits in one instruction, so the sum here is exact
// integer arithmetic: any exact evaluation gives the reference's bits
// (tests/test_mxu_fbc.py pins the function against bigint math); alpha
// must be the same fma chain as the reference's jitted jnp.sum.
//
// The sum: with the constants centered too (c' = C or C - q_f, |c'| <
// 2^30), each term v_i * c' is below 2^60 in magnitude, so a signed 64-bit
// sum holds kChunk of them; it is reduced to [0, q_f) after each kChunk
// terms and at the end: offset by a multiple of q_f near 2^63 so that it is
// unsigned, then two Shoup multiplies (the low word by 1, the high word by
// 2^32 mod q_f).  alpha * P_f joins the sum as one more term with P_f
// centered.  One IMAD.WIDE a term (mad.wide.s32: the compiler makes a
// 64 x 64-bit product of a cast), against a Shoup product and a modular
// add a term before: at the path's shapes the conversion is bound by
// its integer instructions, not by its bytes (PERF.md §6).
//
// Design: a thread owns 4 neighbouring columns of a row (16-byte loads of
// each source plane, 16-byte stores of each target), and a grid sized to
// what the card holds at once walks the (row, column quad) tiles.  A block
// starts its first tile's S loads, then stages the constants (C centered;
// per target q_f, the two Shoup pairs of the reduction, P_f centered,
// extra_f; per source q_i and 1/q_i) once in shared memory, read as
// broadcasts; within the walk the next tile's S loads are started before
// the current tile's F stores.  alpha is computed once per column for all
// F targets.
//
// Bound on the card: device-memory bytes, (S + F) * 4 per column and row
// (the fused tail at bench_n14 B=8, [8,2,6,N] -> [8,2,8,N], moves 14.7 MB:
// 4.4 us at 3.35 TB/s); the S * F multiply-adds per column take less at
// the integer rate.  Measured times are in PERF.md.
#include "ntt_common.cuh"

namespace {

constexpr int kMaxS = 16;
constexpr int kThreads = 128;
constexpr int kChunk = 7;  // 7 terms < 2^60 each, plus a reduced value

// per-target constants (core/centered_fbc.py `kernel_consts`): the words
// after the S*F centered c'
constexpr int kQ = 0, kOneS = 1, kR32 = 2, kR32S = 3, kPc = 4, kEx = 5,
              kExS = 6, kOffLo = 7, kOffHi = 8, kPerF = 9;

// c + a * b with a 32 x 32 -> 64-bit signed product: one IMAD.WIDE (the
// compiler makes a 64 x 64 product of (long long)a * b).
__device__ __forceinline__ long long mad_wide(int a, int b, long long c) {
  long long d;
  asm("mad.wide.s32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// s mod q for |s| < 7 * 2^60 + 2^35: s + off (off = q * floor(2^63 / q),
// so the sum is unsigned and below 2^64), then the low word by 1 and the
// high word by 2^32 mod q, each a Shoup product, and their modular sum.
__device__ __forceinline__ uint32_t reduce64(long long s, const uint32_t* k) {
  const uint32_t q = k[kQ];
  const unsigned long long u =
      static_cast<unsigned long long>(s) +
      (static_cast<unsigned long long>(k[kOffHi]) << 32 | k[kOffLo]);
  const uint32_t l = hetpu::shoup_mul(static_cast<uint32_t>(u), 1u, k[kOneS],
                                      q);
  const uint32_t m = hetpu::shoup_mul(static_cast<uint32_t>(u >> 32),
                                      k[kR32], k[kR32S], q);
  return hetpu::mod_add(l, m, q);
}

__device__ __forceinline__ int centered(uint32_t x, uint32_t q) {
  return x > (q >> 1) ? -static_cast<int>(q - x) : static_cast<int>(x);
}

template <int kS>
__device__ __forceinline__ void load_tile(uint4 (&raw)[kS],
                                          const uint32_t* __restrict__ y,
                                          long long g, int S, int n4) {
  const long long row = g / n4;
  const uint4* p = reinterpret_cast<const uint4*>(y) + row * S * n4 + g % n4;
#pragma unroll
  for (int i = 0; i < kS; ++i)
    if (i < S) raw[i] = p[static_cast<long long>(i) * n4];
}

// kS: S itself up to 8 (every loop over the sources unrolled exactly),
// kMaxS for 9..16.
template <int kS>
__global__ void __launch_bounds__(kThreads) centered_fbc_kernel(
    const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
    long long quads, int S_arg, int F, int n4,
    const uint32_t* __restrict__ consts, bool has_alpha, bool has_extra) {
  // shared: c'[S*F] (int), kPerF words per target, q_src[S], recip[S]
  extern __shared__ uint32_t sm[];
  const int S = kS < kMaxS ? kS : S_arg;
  const int* s_c = reinterpret_cast<const int*>(sm);
  const uint32_t* s_k = sm + S * F;
  const uint32_t* s_qs = s_k + kPerF * F;
  const float* s_rc = reinterpret_cast<const float*>(s_qs + S);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;

  uint4 raw[kS];
  if (g < quads) load_tile<kS>(raw, y, g, S, n4);
  for (int k = threadIdx.x; k < S * F + kPerF * F + 2 * S; k += kThreads)
    sm[k] = consts[k];
  __syncthreads();

  while (g < quads) {
    int v[kS][4];
    float al[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (i < S) {
        const uint32_t qi = s_qs[i];
        const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[i][j] = centered(w[j], qi);
          if (has_alpha)
            al[j] = __fmaf_rn(__int2float_rn(v[i][j]), s_rc[i], al[j]);
        }
      }
    }
    int alpha[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      alpha[j] = has_alpha ? static_cast<int>(rintf(al[j])) : 0;
    const long long row = g / n4;
    uint4* o = reinterpret_cast<uint4*>(out) + row * F * n4 + g % n4;
    g += stride;
    if (g < quads) load_tile<kS>(raw, y, g, S, n4);  // before the stores
    for (int f = 0; f < F; ++f) {
      const uint32_t* k = s_k + kPerF * f;
      long long acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (i < S) {
          const int cf = s_c[i * F + f];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = mad_wide(v[i][j], cf, acc[j]);
          if ((i + 1) % kChunk == 0 && i + 1 < S) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = reduce64(acc[j], k);
          }
        }
      }
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (has_alpha)
          acc[j] = mad_wide(-alpha[j], static_cast<int>(k[kPc]), acc[j]);
        r[j] = reduce64(acc[j], k);
        if (has_extra) r[j] = hetpu::shoup_mul(r[j], k[kEx], k[kExS], k[kQ]);
      }
      o[static_cast<long long>(f) * n4] = make_uint4(r[0], r[1], r[2], r[3]);
    }
  }
}

// The grid: as many blocks as the card holds at once (queried once per
// device and instance), fewer where the tiles run out.
template <int kS>
int launch(const uint32_t* y, uint32_t* out, long long quads, int S, int F,
           int n4, const uint32_t* consts, bool has_alpha, bool has_extra,
           cudaStream_t stream) {
  static int per_sm[64] = {};
  static int sms[64] = {};
  const size_t smem = sizeof(uint32_t) * (S * F + kPerF * F + 2 * S);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], centered_fbc_kernel<kS>, kThreads,
        sizeof(uint32_t) * (kMaxS * 32 + kPerF * 32 + 2 * kMaxS));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm[dev] < 1) per_sm[dev] = 1;
  }
  const long long most = static_cast<long long>(per_sm[dev]) * sms[dev];
  const long long want = (quads + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  centered_fbc_kernel<kS><<<blocks, kThreads, smem, stream>>>(
      y, out, quads, S, F, n4, consts, has_alpha, has_extra);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [rows, S, n], out [rows, F, n], n a multiple of 4 and both 16-byte
// aligned (the wrapper checks); consts: the S*F + 9F + 2S words of
// core/centered_fbc.py `kernel_consts`.
extern "C" int hetpu_centered_fbc(const uint32_t* y, uint32_t* out, int rows,
                                  int S, int F, int n, const uint32_t* consts,
                                  int has_alpha, int has_extra,
                                  cudaStream_t stream) {
  if (S < 1 || S > kMaxS || F < 1 || rows < 1 || n < 4 || n % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long quads = static_cast<long long>(rows) * (n / 4);
  const bool a = has_alpha != 0, e = has_extra != 0;
  const int n4 = n / 4;
  switch (S) {
    case 1: return launch<1>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 2: return launch<2>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 3: return launch<3>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 4: return launch<4>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 5: return launch<5>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 6: return launch<6>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 7: return launch<7>(y, out, quads, S, F, n4, consts, a, e, stream);
    case 8: return launch<8>(y, out, quads, S, F, n4, consts, a, e, stream);
    default:
      return launch<kMaxS>(y, out, quads, S, F, n4, consts, a, e, stream);
  }
}
