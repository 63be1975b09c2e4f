// Kernel `fbc_precise` (K9): the exact fast base conversion of BFV's HPS
// multiply, core/rns.py `fbc_apply(x, plan, precise=True)` with its
// premultiply and its alpha-correction, for S source primes p_i and F
// target primes r_f:
//   y_i    = x_i * (P/p_i)^-1 mod p_i                           (Shoup)
//   alpha  = ds_round(two-float sum of y_i / p_i, i = 0..S-1)
//   out[f] = (sum_i y_i * (P/p_i mod r_f) - alpha * (P mod r_f)) mod r_f,
// canonical in [0, r_f).  BFV runs it four times a multiply (each operand
// Q -> B, t*x's Q-residues Q -> B, the scaled y B -> Q) and once a decrypt
// (Q -> G).
//
// Replaces no TPU kernel: the JAX package runs this conversion eagerly in
// jnp (hetpu/core/rns.py `fbc_apply`, `_alpha_precise`), and the port's
// plain twin runs it as ~20 eager float32 passes and an int64 multiply, a
// `%` and an add a source prime, each over device memory.
//
// alpha must be the twin's bits: every float32 product and sum is spelled
// __fmul_rn / __fadd_rn / __fsub_rn (no contraction into a fused
// multiply-add, whatever the build flags), in `_alpha_precise`'s order:
// per source i ascending, the 16-bit high half y_i >> 16 against 2^16/p_i
// before the low half against 1/p_i, each an exact Dekker product (the
// Veltkamp split of core/twofloat.py) plus its residual term, accumulated
// by `ds_add` and rounded by `ds_round` (rintf: half to even).
//
// The sum is exact integer arithmetic, so any evaluation gives the twin's
// bits: each term y_i * c < p_i * r_f is one 32 x 32 -> 64-bit multiply-add
// (mad.wide.u32) into an unsigned 64-bit sum, which is reduced after every
// `chunk` terms (core/rns.py `fbc_chunk` picks the largest count that
// cannot overflow for the plan's primes: 4 for 31-bit primes on both
// sides, 8 where one side has 30 bits, 16 where both have) and at the end: the low word by
// 1 and the high word by 2^32 mod r_f, each a Shoup product, and their
// modular sum.  alpha joins the sum as one more term, alpha * (r_f - P mod
// r_f), which alpha <= S keeps below a term's bound.
//
// Design, as K5 `centered_fbc` (centered_fbc.cu): a thread owns 4
// neighbouring columns of one row (16-byte loads of each source plane,
// 16-byte stores of each target), and a grid sized to what the card holds
// at once walks the (row, column quad) tiles.  A block starts its first
// tile's S loads, then stages the plan's constants once in shared memory,
// read as broadcasts; within the walk the next tile's S loads are started
// before the current tile's F stores.  alpha is computed once a column for
// all F targets.
//
// Bound on the card: device-memory bytes, (S + F) * 4 a column and row
// (BFV's four conversions at bfv_batch move 11.1 MB an op: 3.3 us at 3.35
// TB/s); the float32 alpha (~48 operations a source and column) and the S
// * F multiply-adds take about as long at the instruction rate, and at 96-128
// registers a thread (4-5 blocks an SM) they do not all hide under the
// loads: the kernel runs at 2.5-3.2x its bytes bound (PERF.md section 6).
#include "ntt_common.cuh"

namespace {

constexpr int kMaxS = 16;   // core/rns.py MAX_SRC, MAX_DST
constexpr int kMaxF = 16;
constexpr int kThreads = 128;

// the words of core/rns.py `pack_consts`: phat[S * F] (P/p_i mod r_f at
// i * F + f), then kPerF words a target, kPerS a source, and the chunk
constexpr int kR = 0, kOneS = 1, kR32 = 2, kR32S = 3, kPtot = 4, kPerF = 5;
constexpr int kP = 0, kInv = 1, kInvS = 2, kR16Hi = 3, kR16Lo = 4,
              kR0Hi = 5, kR0Lo = 6, kPerS = 7;

__host__ __device__ constexpr int const_words(int S, int F) {
  return S * F + kPerF * F + kPerS * S + 1;
}

// c + a * b, a 32 x 32 -> 64-bit unsigned product
__device__ __forceinline__ unsigned long long mad_wide(uint32_t a, uint32_t b,
                                                       unsigned long long c) {
  unsigned long long d;
  asm("mad.wide.u32 %0, %1, %2, %3;" : "=l"(d) : "r"(a), "r"(b), "l"(c));
  return d;
}

// s mod r for any 64-bit s: lo(s) * 1 + hi(s) * (2^32 mod r), each a Shoup
// product, then their modular sum
__device__ __forceinline__ uint32_t reduce64(unsigned long long s,
                                            const uint32_t* k) {
  const uint32_t r = k[kR];
  const uint32_t l = hetpu::shoup_mul(static_cast<uint32_t>(s), 1u, k[kOneS],
                                      r);
  const uint32_t h = hetpu::shoup_mul(static_cast<uint32_t>(s >> 32), k[kR32],
                                      k[kR32S], r);
  return hetpu::mod_add(l, h, r);
}

// core/twofloat.py `_split` (4097 = 2^12 + 1): a = hi + lo with hi of at
// most 12 bits
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float t = __fmul_rn(a, 4097.0f);
  hi = __fsub_rn(t, __fsub_rn(t, a));
  lo = __fsub_rn(a, hi);
}

// `two_prod(a, b)` with b's split (bh, bl) given, then the residual term
// `e + a * b_lo` of `_alpha_precise`: the exact pair (p, e) of a * (b + b_lo)
__device__ __forceinline__ void product(float a, float b, float bh, float bl,
                                        float b_lo, float& p, float& e) {
  p = __fmul_rn(a, b);
  float ah, al;
  split(a, ah, al);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p),
                                    __fmul_rn(ah, bl)),
                          __fmul_rn(al, bh)),
                __fmul_rn(al, bl));
  e = __fadd_rn(e, __fmul_rn(a, b_lo));
}

// `ds_add`: the exact pair (p, e) into the double-single (hi, lo)
__device__ __forceinline__ void ds_add(float& hi, float& lo, float p,
                                       float e) {
  const float s = __fadd_rn(hi, p);
  const float v = __fsub_rn(s, hi);
  const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, v)), __fsub_rn(p, v));
  lo = __fadd_rn(lo, __fadd_rn(err, e));
  hi = s;
}

// `ds_round`: round(hi + lo), honoring lo where hi sits near a half
__device__ __forceinline__ uint32_t ds_round(float hi, float lo) {
  const float r = rintf(hi);
  const float f = __fsub_rn(hi, r);
  const float up = __fadd_rn(__fsub_rn(f, 0.5f), lo) >= 0.0f ? 1.0f : 0.0f;
  const float dn = __fadd_rn(__fadd_rn(f, 0.5f), lo) < 0.0f ? 1.0f : 0.0f;
  return static_cast<uint32_t>(__fsub_rn(__fadd_rn(r, up), dn));
}

template <int kS>
__device__ __forceinline__ void load_tile(uint4 (&raw)[kS],
                                          const uint32_t* __restrict__ x,
                                          long long g, int S, int n4) {
  const long long row = g / n4;
  const uint4* p = reinterpret_cast<const uint4*>(x) + row * S * n4 + g % n4;
#pragma unroll
  for (int i = 0; i < kS; ++i)
    if (i < S) raw[i] = p[static_cast<long long>(i) * n4];
}

// kS: S itself up to 12 (every loop over the sources unrolled exactly),
// kMaxS for 13..16.
template <int kS>
__global__ void __launch_bounds__(kThreads) fbc_precise_kernel(
    const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
    long long quads, int S, int F, int n4,
    const uint32_t* __restrict__ consts) {
  extern __shared__ uint32_t sm[];
  const uint32_t* s_phat = sm;
  const uint32_t* s_f = sm + S * F;
  const uint32_t* s_s = s_f + kPerF * F;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;

  uint4 raw[kS];
  if (g < quads) load_tile<kS>(raw, x, g, S, n4);
  for (int k = threadIdx.x; k < const_words(S, F); k += kThreads)
    sm[k] = consts[k];
  __syncthreads();
  const int chunk = static_cast<int>(s_s[kPerS * S]);

  while (g < quads) {
    uint32_t y[kS][4];
    float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    float lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      if (i < S) {
        const uint32_t* c = s_s + kPerS * i;
        const float r16 = __uint_as_float(c[kR16Hi]);
        const float r0 = __uint_as_float(c[kR0Hi]);
        float r16h, r16l, r0h, r0l;
        split(r16, r16h, r16l);
        split(r0, r0h, r0l);
        const uint32_t w[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[i][j] = hetpu::shoup_mul(w[j], c[kInv], c[kInvS], c[kP]);
          float p1, e1, p0, e0;
          product(__uint2float_rn(y[i][j] >> 16), r16, r16h, r16l,
                  __uint_as_float(c[kR16Lo]), p1, e1);
          product(__uint2float_rn(y[i][j] & 0xFFFFu), r0, r0h, r0l,
                  __uint_as_float(c[kR0Lo]), p0, e0);
          ds_add(hi[j], lo[j], p1, e1);
          ds_add(hi[j], lo[j], p0, e0);
        }
      }
    }
    uint32_t alpha[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) alpha[j] = ds_round(hi[j], lo[j]);
    const long long row = g / n4;
    uint4* o = reinterpret_cast<uint4*>(out) + row * F * n4 + g % n4;
    g += stride;
    if (g < quads) load_tile<kS>(raw, x, g, S, n4);  // before the stores
    for (int f = 0; f < F; ++f) {
      const uint32_t* k = s_f + kPerF * f;
      unsigned long long acc[4] = {0, 0, 0, 0};
      int left = chunk;
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        if (i < S) {
          const uint32_t c = s_phat[i * F + f];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[j] = mad_wide(y[i][j], c, acc[j]);
          if (--left == 0) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[j] = reduce64(acc[j], k);
            left = chunk;
          }
        }
      }
      // -alpha * (P mod r) as alpha * (r - P mod r): the last term
      const uint32_t neg = k[kR] - k[kPtot];
      uint32_t r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = reduce64(mad_wide(alpha[j], neg, acc[j]), k);
      o[static_cast<long long>(f) * n4] = make_uint4(r[0], r[1], r[2], r[3]);
    }
  }
}

// The grid: as many blocks as the card holds at once (queried once per
// device and instance, at the largest shared memory a launch may take),
// fewer where the tiles run out.
template <int kS>
int launch(const uint32_t* x, uint32_t* out, long long quads, int S, int F,
           int n4, const uint32_t* consts, cudaStream_t stream) {
  static int per_sm[64] = {};
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev], fbc_precise_kernel<kS>, kThreads,
        sizeof(uint32_t) * const_words(kMaxS, kMaxF));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                   dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm[dev] < 1) per_sm[dev] = 1;
  }
  const long long most = static_cast<long long>(per_sm[dev]) * sms[dev];
  const long long want = (quads + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(want < most ? want : most);
  fbc_precise_kernel<kS><<<blocks, kThreads,
                           sizeof(uint32_t) * const_words(S, F), stream>>>(
      x, out, quads, S, F, n4, consts);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, S, n] standard-form residues, out [rows, F, n], n a multiple of
// 4 and both 16-byte aligned (the wrapper checks); consts: the
// S*F + 5F + 7S + 1 words of core/rns.py `pack_consts`.
extern "C" int hetpu_fbc_precise(const uint32_t* x, uint32_t* out, int rows,
                                 int S, int F, int n, const uint32_t* consts,
                                 cudaStream_t stream) {
  if (S < 1 || S > kMaxS || F < 1 || F > kMaxF || rows < 1 || n < 4 ||
      n % 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long quads = static_cast<long long>(rows) * (n / 4);
  const int n4 = n / 4;
  switch (S) {
    case 1: return launch<1>(x, out, quads, S, F, n4, consts, stream);
    case 2: return launch<2>(x, out, quads, S, F, n4, consts, stream);
    case 3: return launch<3>(x, out, quads, S, F, n4, consts, stream);
    case 4: return launch<4>(x, out, quads, S, F, n4, consts, stream);
    case 5: return launch<5>(x, out, quads, S, F, n4, consts, stream);
    case 6: return launch<6>(x, out, quads, S, F, n4, consts, stream);
    case 7: return launch<7>(x, out, quads, S, F, n4, consts, stream);
    case 8: return launch<8>(x, out, quads, S, F, n4, consts, stream);
    case 9: return launch<9>(x, out, quads, S, F, n4, consts, stream);
    case 10: return launch<10>(x, out, quads, S, F, n4, consts, stream);
    case 11: return launch<11>(x, out, quads, S, F, n4, consts, stream);
    case 12: return launch<12>(x, out, quads, S, F, n4, consts, stream);
    default: return launch<kMaxS>(x, out, quads, S, F, n4, consts, stream);
  }
}
