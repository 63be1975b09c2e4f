// Kernel `ks_tail`: the elementwise tails of the key switch's mod-down and
// of the rescale, and the own-prime limbs of its digits, one template with
// five entry points.  Rows are the
// leading axes of an output [rows, Lo, N]; output row `row` is part
// row % P of batch row row / P, and each operand names where that row and
// limb l sit in its own [batch, parts, limbs, N] array (`Planes`), so the
// callers' slices (acc[..., L:, :], ct3[..., :2, :, :], data[..., :-1, :])
// are read in place with no copy.
//
//   tail_src  src[:g] = acc[L-g:L] + c01[L-g:L]*p_mod mod q;
//             src[g:] = acc[L:]                   (rows = batch x 2 parts)
//   tail_out  out = (acc + c01*p_mod - r_m)*pq_inv mod q over the first
//             L-g limbs: the op's data limbs never reach device memory
//             between the mod-down's add and its divide
//   sub_mul   out = (x - r)*w mod q, the divide of `_mod_down` and of
//             `_div_round_last`
//   lift_last out[l] = ((last + half) mod q_src mod q_l - half mod q_l)
//             mod q_l, `_div_round_last`'s one-limb middle: the rounded
//             last limb on every remaining prime, before the forward NTT
//   own_limbs out[map[l]] = d[l]*w mod q_l: the decompose's limbs on each
//             digit's own primes (w = R^-1), stored where they lie in the
//             digits [J, R] of a row, beside the lifted ones K2 stores
//
// Replaces what XLA fuses under the JAX package's `jax.jit`
// (hetpu/core/evaluator.py:48-59): the tails of `_relin_rescale_fused`
// (:410), `_mod_down` (:455) and `_div_round_last` (:482), over
// `modular.shoup_mul` (hetpu/core/modular.py:71), `mod_add`, `mod_sub` and
// `barrett_reduce_u32`.  The port's eager twins (core/ks_tail.py
// `*_plain`) make each Shoup product an int64 pass over device memory.
//
// Arithmetic: 32-bit Shoup with the precomputed companion, as hetpu's
// (q^ = umulhi(x, w'); r = x*w - q^*q mod 2^32; one conditional
// subtract) and hetpu's Barrett with mu = floor(2^32/q) (one conditional
// subtract); every result is the canonical residue, so the bits are the
// twins'.  core/ks_tail.py `shoup_u32` / `barrett_u32` spell the steps in
// int64 for the CPU tests.
//
// Bound on the card: device-memory bytes (tail_out reads 3 planes and
// writes 1; sub_mul 2 and 1; tail_src at most 2 and 1; own_limbs 1 and 1;
// lift_last reads one limb and writes Lo), with 2-3 integer multiplies a Shoup product far
// below it.  A thread owns one 16-byte quad of one limb of one row (as
// K7), its per-limb constants loaded once.
#include "ntt_common.cuh"

namespace {

constexpr int kTailThreads = 256;   // quads a block

enum Mode { kSrc = 0, kOut = 1, kSubMul = 2, kLiftLast = 3, kOwn = 4 };

// One operand: rows of `parts` parts of `limbs` limbs, from limb `off`.
struct Planes {
  const uint4* p;
  int parts;
  int limbs;
  int off;
};

struct Consts {
  const uint32_t* q;         // [Lo] the output limbs' primes
  const uint32_t* p_mod;     // [Lo] multiplier of c01 (tail_src, tail_out)
  const uint32_t* p_mod_shoup;
  const uint32_t* w;         // [Lo] the divide's multiplier (tail_out,
  const uint32_t* w_shoup;   //      sub_mul)
  const uint32_t* half;      // [1] q_src >> 1 (lift_last)
  const uint32_t* q_src;     // [1] the dropped prime (lift_last)
  const uint32_t* mu;        // [Lo] floor(2^32 / q_l) (lift_last)
  const uint32_t* half_mod;  // [Lo] half mod q_l (lift_last)
  const int* map;            // [Lo] output limb within a row (own_limbs)
  int limbs;                 // output limbs a row (own_limbs)
};

__device__ __forceinline__ uint4 load(const Planes& a, size_t row, int P,
                                      int l, int n4, int quad) {
  const size_t r = (row / P) * a.parts + row % P;
  return a.p[(r * a.limbs + a.off + l) * static_cast<size_t>(n4) + quad];
}

__device__ __forceinline__ uint32_t barrett(uint32_t x, uint32_t q,
                                            uint32_t mu) {
  const uint32_t r = x - __umulhi(x, mu) * q;   // in [0, 2q)
  return min(r, r - q);
}

// one residue of the mode's function
template <int MODE>
__device__ __forceinline__ uint32_t tail(uint32_t a, uint32_t c, uint32_t r,
                                         uint32_t q, uint32_t pm,
                                         uint32_t pms, uint32_t w,
                                         uint32_t ws) {
  using hetpu::mod_add;
  using hetpu::mod_sub;
  using hetpu::shoup_mul;
  if (MODE == kSrc) return mod_add(a, shoup_mul(c, pm, pms, q), q);
  if (MODE == kOut) {
    const uint32_t s = mod_add(a, shoup_mul(c, pm, pms, q), q);
    return shoup_mul(mod_sub(s, r, q), w, ws, q);
  }
  if (MODE == kOwn) return shoup_mul(a, w, ws, q);
  return shoup_mul(mod_sub(a, r, q), w, ws, q);   // kSubMul
}

template <int MODE>
__global__ void __launch_bounds__(kTailThreads)
    ks_tail_kernel(Planes a, Planes c, Planes r, uint4* __restrict__ out,
                   size_t quads, int P, int Lo, int g, int n4, Consts k) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTailThreads +
                   threadIdx.x;
  if (i >= quads) return;
  const size_t lon4 = static_cast<size_t>(Lo) * n4;
  const size_t row = i / lon4;
  const size_t at = i - row * lon4;
  const int l = static_cast<int>(at / n4);
  const int quad = static_cast<int>(at - static_cast<size_t>(l) * n4);
  uint4 v;
  if (MODE == kLiftLast) {
    const uint32_t qs = __ldg(k.q_src), h = __ldg(k.half);
    const uint32_t ql = __ldg(k.q + l), mu = __ldg(k.mu + l);
    const uint32_t hm = __ldg(k.half_mod + l);
    const uint4 x = load(a, row, P, 0, n4, quad);
    uint32_t e[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = hetpu::mod_sub(barrett(hetpu::mod_add(e[j], h, qs), ql, mu),
                            hm, ql);
    }
    v = make_uint4(e[0], e[1], e[2], e[3]);
  } else {
    const uint4 av = load(a, row, P, l, n4, quad);
    if (MODE == kSrc && l >= g) {
      v = av;                                  // a special limb: copied
    } else {
      const uint32_t ql = __ldg(k.q + l);
      uint32_t pm = 0, pms = 0, w = 0, ws = 0;
      uint4 cv = make_uint4(0, 0, 0, 0), rv = cv;
      if (MODE == kSrc || MODE == kOut) {
        pm = __ldg(k.p_mod + l);
        pms = __ldg(k.p_mod_shoup + l);
        cv = load(c, row, P, l, n4, quad);
      }
      if (MODE != kSrc) {
        w = __ldg(k.w + l);
        ws = __ldg(k.w_shoup + l);
      }
      if (MODE == kOut || MODE == kSubMul) rv = load(r, row, P, l, n4, quad);
      v.x = tail<MODE>(av.x, cv.x, rv.x, ql, pm, pms, w, ws);
      v.y = tail<MODE>(av.y, cv.y, rv.y, ql, pm, pms, w, ws);
      v.z = tail<MODE>(av.z, cv.z, rv.z, ql, pm, pms, w, ws);
      v.w = tail<MODE>(av.w, cv.w, rv.w, ql, pm, pms, w, ws);
    }
  }
  if (MODE == kOwn) {
    out[(row * k.limbs + __ldg(k.map + l)) * static_cast<size_t>(n4) +
        quad] = v;
  } else {
    out[i] = v;
  }
}

template <int MODE>
int launch(Planes a, Planes c, Planes r, uint32_t* out, int rows, int P,
           int Lo, int g, int n, const Consts& k, cudaStream_t stream) {
  if (n % 4 != 0 || rows < 0 || Lo <= 0 || P <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t quads = static_cast<size_t>(rows) * Lo * (n / 4);
  if (quads == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((quads + kTailThreads - 1) / kTailThreads);
  ks_tail_kernel<MODE><<<blocks, kTailThreads, 0, stream>>>(
      a, c, r, reinterpret_cast<uint4*>(out), quads, P, Lo, g, n / 4, k);
  return static_cast<int>(cudaGetLastError());
}

Planes planes(const uint32_t* p, int parts, int limbs, int off) {
  return Planes{reinterpret_cast<const uint4*>(p), parts, limbs, off};
}

}  // namespace

// In every entry: `rows` output rows of P parts each ([rows, Lo, n] out,
// contiguous), each operand as (pointer, parts, limbs[, first limb]) of its
// [batch, parts, limbs, n] array; all 16-byte aligned.

// src [rows, g + k, n] from acc (limbs L-g.., the last g + k) and c01
// (limbs L-g..L-1); q, p_mod, p_mod_shoup: [g], the dropped primes'.
extern "C" int hetpu_ks_tail_src(const uint32_t* acc, int acc_parts,
                                 int acc_limbs, const uint32_t* c,
                                 int c_parts, int c_limbs, uint32_t* out,
                                 int rows, int P, int Lo, int g, int off,
                                 int n, const uint32_t* q,
                                 const uint32_t* p_mod,
                                 const uint32_t* p_mod_shoup,
                                 cudaStream_t stream) {
  const Consts k{q, p_mod, p_mod_shoup, nullptr, nullptr, nullptr,
                 nullptr, nullptr, nullptr, nullptr, 0};
  return launch<kSrc>(planes(acc, acc_parts, acc_limbs, off),
                      planes(c, c_parts, c_limbs, off), Planes{}, out, rows,
                      P, Lo, g, n, k, stream);
}

// out [rows, Lo, n] = (acc + c01*p_mod - r)*w over limbs 0..Lo-1; r is
// [rows, Lo, n]; the constants are [Lo].
extern "C" int hetpu_ks_tail_out(const uint32_t* acc, int acc_parts,
                                 int acc_limbs, const uint32_t* c,
                                 int c_parts, int c_limbs, const uint32_t* r,
                                 uint32_t* out, int rows, int P, int Lo,
                                 int n, const uint32_t* q,
                                 const uint32_t* p_mod,
                                 const uint32_t* p_mod_shoup,
                                 const uint32_t* w, const uint32_t* w_shoup,
                                 cudaStream_t stream) {
  const Consts k{q, p_mod, p_mod_shoup, w, w_shoup, nullptr,
                 nullptr, nullptr, nullptr, nullptr, 0};
  return launch<kOut>(planes(acc, acc_parts, acc_limbs, 0),
                      planes(c, c_parts, c_limbs, 0), planes(r, P, Lo, 0),
                      out, rows, P, Lo, 0, n, k, stream);
}

// out [rows, Lo, n] = (x - r)*w over x's first Lo limbs (rows of x_limbs).
extern "C" int hetpu_ks_tail_sub_mul(const uint32_t* x, int x_limbs,
                                     const uint32_t* r, uint32_t* out,
                                     int rows, int Lo, int n,
                                     const uint32_t* q, const uint32_t* w,
                                     const uint32_t* w_shoup,
                                     cudaStream_t stream) {
  const Consts k{q, nullptr, nullptr, w, w_shoup, nullptr,
                 nullptr, nullptr, nullptr, nullptr, 0};
  return launch<kSubMul>(planes(x, 1, x_limbs, 0), Planes{},
                         planes(r, 1, Lo, 0), out, rows, 1, Lo, 0, n, k,
                         stream);
}

// out [rows, Lo, n] from last [rows, 1, n] (standard form mod q_src).
extern "C" int hetpu_ks_tail_lift_last(const uint32_t* last, uint32_t* out,
                                       int rows, int Lo, int n,
                                       const uint32_t* half,
                                       const uint32_t* q_src,
                                       const uint32_t* q, const uint32_t* mu,
                                       const uint32_t* half_mod,
                                       cudaStream_t stream) {
  const Consts k{q, nullptr, nullptr, nullptr, nullptr, half,
                 q_src, mu, half_mod, nullptr, 0};
  return launch<kLiftLast>(planes(last, 1, 1, 0), Planes{}, Planes{}, out,
                           rows, 1, Lo, 0, n, k, stream);
}

// out plane map[l] of each row of out_limbs planes = d[l]*w[l] mod q[l],
// over d's L limbs (d's rows d_stride planes apart: read in place).
extern "C" int hetpu_ks_tail_own_limbs(const uint32_t* d, int d_stride,
                                       uint32_t* out, int rows, int L, int n,
                                       const int* map, int out_limbs,
                                       const uint32_t* q, const uint32_t* w,
                                       const uint32_t* w_shoup,
                                       cudaStream_t stream) {
  if (d_stride < L || out_limbs < L)
    return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{q, nullptr, nullptr, w, w_shoup, nullptr,
                 nullptr, nullptr, nullptr, map, out_limbs};
  return launch<kOwn>(planes(d, 1, d_stride, 0), Planes{}, Planes{}, out,
                      rows, 1, L, 0, n, k, stream);
}
