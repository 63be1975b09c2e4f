// Kernels `ntt_fwd_lifted`, `ntt_fwd_fbc` and `ntt_fwd_centered`: a
// prologue that builds each output plane from several input planes, then
// the forward NTT of that plane, in the register-radix passes of the `ntt`
// kernel (ntt_passes.cuh).  The prologue is the first pass's column
// loader (LiftLoad), so the lifted / converted plane never goes to device
// memory.  For output plane (row, f) a thread computes, for the 8 columns
// v + j*N/8 it holds,
//   x = sum_{i<A} W[f,i] * v(y[s_f + i]) - alpha * P_f   (mod q_f),
// with s_f = dig[f]*A (0 without dig), each source index clamped to the
// last input plane exactly as the reference does (mxu_ntt.py:942-944; the
// padded terms of a short digit have W = 0, so no read leaves the input).
//   * default form: v(y) = y, the residue;
//   * centered form: v(y) = y - q_s if y > q_s/2 else y (q_s the source
//     plane's prime): a negative term subtracts the Shoup product of |v|,
//     as centered_fbc.cu does;
//   * with alpha: alpha = rint(fma chain of f32(v_i) * f32(1/q_i), i =
//     0..A-1 from 0), each step __fmaf_rn (one rounding) and rintf half to
//     even: the reference's jitted jnp.sum compiles to exactly this chain.
//     A multiply and an add rounded separately, or another order, would
//     flip rare near-half roundings and shift a coefficient by P.  The
//     explicit intrinsic fuses whatever --fmad says.  Centered, alpha is
//     signed and |alpha| * P_f is added or subtracted by its sign.
//
// Replaces the JAX package's TPU kernels
//   * hetpu/core/mxu_ntt.py `_pallas_call_lift` (:816), corr = false
//     (entered via `ntt_fwd_lifted`, :919): the key-switch digit lift, K2
//     `ntt_fwd_lifted`, default form, no alpha;
//   * the same, corr = true (via `ntt_fwd_fbc`, :962): the centered fast
//     base conversion of the mod-down and the fused rescale tail on
//     premultiplied sources, K3 `ntt_fwd_fbc`, default form with alpha;
//   * hetpu/core/mxu_fbc.py `_build_pallas_call` (:214) and the forward
//     NTT that follows it (hetpu/core/evaluator.py:192-227, :470-476 with
//     HETPU_MXU_FBC=1): `ntt_fwd_centered`, centered form, without alpha
//     for the digit lift (both digits in one launch) and with alpha for
//     the mod-down and the tail.  The TPU ran that contraction as an s8
//     digit matmul; the card has an exact __umulhi, so each term is one
//     Shoup multiply.  The standalone conversion is centered_fbc.cu.
//
// Bound on the card: bytes, the A source planes of a row read once (each
// re-read by the F output planes of its row, mostly from L2) and F planes
// written; the conversion needs one wide multiply a term and one reduction
// a residue, below the bytes.  The first K2 (one CTA a plane, one
// dependent source load a term, 14 radix-2 shared-memory stages) ran at
// 15x its bound.  Here each thread issues its 8 loads of a source plane
// together, and with a cluster of C CTAs a plane each CTA lifts only its
// N/C columns; the core keeps 40 registers a thread.  Measured times are
// in PERF.md.
#include "ntt_passes.cuh"

namespace {

using namespace hetpu::passes;

// Pass-0 loader: the lifted / converted residues of columns v + j*cols of
// output prime q.  w, ws point at W[f, 0]; W[f, i] is w[i * wi].
template <bool kCentered, bool kAlpha>
struct LiftLoad {
  const uint32_t* __restrict__ y;      // the row's Ly source planes
  const uint32_t* __restrict__ w;
  const uint32_t* __restrict__ ws;
  const uint32_t* __restrict__ q_src;  // prime of each source plane
  const float* __restrict__ recip;     // f32(1 / prime) of each plane
  int A, wi, src, Ly, logn;
  uint32_t pm, pms, q;                 // P_f and its Shoup companion

  __device__ __forceinline__ void operator()(uint32_t (&x)[kE], int v,
                                             int cols) const {
    float al[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      x[j] = 0;
      al[j] = 0.0f;
    }
    for (int i = 0; i < A; ++i) {
      const int s = min(src + i, Ly - 1);
      const uint32_t* ys = y + (static_cast<size_t>(s) << logn) + v;
      uint32_t r[kE];
#pragma unroll
      for (int j = 0; j < kE; ++j) r[j] = __ldg(ys + j * cols);
      const uint32_t wt = __ldg(w + i * wi);
      const uint32_t wst = __ldg(ws + i * wi);
      const float rc = kAlpha ? __ldg(recip + s) : 0.0f;
      if constexpr (kCentered) {
        const uint32_t qs = __ldg(q_src + s);
#pragma unroll
        for (int j = 0; j < kE; ++j) {
          const bool neg = r[j] > (qs >> 1);
          const uint32_t a = neg ? qs - r[j] : r[j];
          const uint32_t m = hetpu::shoup_mul(a, wt, wst, q);
          x[j] = neg ? hetpu::mod_sub(x[j], m, q) : hetpu::mod_add(x[j], m, q);
          if constexpr (kAlpha) {
            const int sv = neg ? -static_cast<int>(a) : static_cast<int>(a);
            al[j] = __fmaf_rn(__int2float_rn(sv), rc, al[j]);
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kE; ++j) {
          x[j] = hetpu::mod_add(x[j], hetpu::shoup_mul(r[j], wt, wst, q), q);
          if constexpr (kAlpha)
            al[j] = __fmaf_rn(__int2float_rn(static_cast<int>(r[j])), rc,
                              al[j]);
        }
      }
    }
    if constexpr (kAlpha) {
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int alpha = static_cast<int>(rintf(al[j]));
        if constexpr (kCentered) {
          const uint32_t m = hetpu::shoup_mul(
              static_cast<uint32_t>(alpha < 0 ? -alpha : alpha), pm, pms, q);
          x[j] = alpha < 0 ? hetpu::mod_add(x[j], m, q)
                           : hetpu::mod_sub(x[j], m, q);
        } else {
          x[j] = hetpu::mod_sub(
              x[j], hetpu::shoup_mul(static_cast<uint32_t>(alpha), pm, pms, q),
              q);
        }
      }
    }
  }
};

// Output plane blockIdx.x / C = (row, f) of a launch over rows * F planes:
// W[f, i] at w[f * wf + i * wi]; dig, q_src, recip, pm, pms may be null
// where the form does not read them; times c1[f] when c1 is given.  The
// plane is stored at plane row*F + f of `out`, or with `out_map` at plane
// row*out_limbs + out_map[f] (the key-switch digits [J, R] of a row, built
// in place).
template <int C, bool kCentered, bool kAlpha>
__device__ __forceinline__ void lift_plane(
    uint32_t* smem, const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
    int Ly, int A, int F, int logn, const uint32_t* __restrict__ w,
    const uint32_t* __restrict__ ws, int wf, int wi,
    const int* __restrict__ dig, const uint32_t* __restrict__ q_src,
    const float* __restrict__ recip, const uint32_t* __restrict__ pm,
    const uint32_t* __restrict__ pms, const uint32_t* __restrict__ tw,
    const uint32_t* __restrict__ tws, const uint32_t* __restrict__ q,
    const uint32_t* __restrict__ c1, const int* __restrict__ out_map,
    int out_limbs) {
  const size_t plane = blockIdx.x / C;
  const int f = static_cast<int>(plane % F);
  const size_t row = plane / F;
  const uint32_t qf = q[f];
  const size_t toff = static_cast<size_t>(f) * table_size(logn);
  uint32_t c = 0, cs = 0;
  if (c1 != nullptr) {
    c = c1[f];
    cs = hetpu::shoup_of(c, qf);
  }
  const LiftLoad<kCentered, kAlpha> load{
      y + ((row * Ly) << logn), w + f * wf, ws + f * wf, q_src, recip,
      A, wi, dig == nullptr ? 0 : dig[f] * A, Ly, logn,
      kAlpha ? pm[f] : 0u, kAlpha ? pms[f] : 0u, qf};
  const size_t dst = out_map == nullptr
                         ? plane
                         : row * out_limbs + static_cast<size_t>(out_map[f]);
  fwd_plane<C>(smem, logn, tw + toff, tws + toff, qf, load,
               out + (dst << logn), c1 != nullptr, c, cs);
}

// K2: the digit lift, lw / lws [F, A], source planes dig[f]*A + i
template <int C>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    lifted_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                int Ly, int A, int F, int logn,
                const uint32_t* __restrict__ lw,
                const uint32_t* __restrict__ lws,
                const int* __restrict__ dig,
                const uint32_t* __restrict__ tw,
                const uint32_t* __restrict__ tws,
                const uint32_t* __restrict__ q,
                const uint32_t* __restrict__ c1,
                const int* __restrict__ out_map, int out_limbs) {
  extern __shared__ uint32_t s[];
  lift_plane<C, false, false>(s, y, out, Ly, A, F, logn, lw, lws, A, 1, dig,
                              nullptr, nullptr, nullptr, nullptr, tw, tws, q,
                              c1, out_map, out_limbs);
}

// K3: the conversion of A premultiplied source planes, phat [A, F]
template <int C>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    fbc_kernel(const uint32_t* __restrict__ u, uint32_t* __restrict__ out,
               int A, int F, int logn, const uint32_t* __restrict__ phat,
               const uint32_t* __restrict__ phat_shoup,
               const float* __restrict__ recip,
               const uint32_t* __restrict__ ptot,
               const uint32_t* __restrict__ ptot_shoup,
               const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tws,
               const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ c1) {
  extern __shared__ uint32_t s[];
  lift_plane<C, false, true>(s, u, out, A, A, F, logn, phat, phat_shoup, 1,
                             F, nullptr, nullptr, recip, ptot, ptot_shoup,
                             tw, tws, q, c1, nullptr, F);
}

// K5's path form: the centered lift (kAlpha false) or conversion
template <int C, bool kAlpha>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    centered_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
                    int Ly, int A, int F, int logn,
                    const uint32_t* __restrict__ w,
                    const uint32_t* __restrict__ ws, int wf, int wi,
                    const int* __restrict__ dig,
                    const uint32_t* __restrict__ q_src,
                    const float* __restrict__ recip,
                    const uint32_t* __restrict__ pm,
                    const uint32_t* __restrict__ pms,
                    const uint32_t* __restrict__ tw,
                    const uint32_t* __restrict__ tws,
                    const uint32_t* __restrict__ q,
                    const uint32_t* __restrict__ c1,
                    const int* __restrict__ out_map, int out_limbs) {
  extern __shared__ uint32_t s[];
  lift_plane<C, true, kAlpha>(s, y, out, Ly, A, F, logn, w, ws, wf, wi, dig,
                              q_src, recip, pm, pms, tw, tws, q, c1, out_map,
                              out_limbs);
}

int launched(cudaError_t err) {
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool bad_map(const int* out_map, int out_limbs, int F) {
  return out_map != nullptr && out_limbs < F;
}

}  // namespace

// out_map == nullptr: output plane (row, f) at plane row*F + f of out;
// else at row*out_limbs + out_map[f] (out_map int [F], values distinct and
// below out_limbs).
extern "C" int hetpu_ntt_fwd_lifted(const uint32_t* y, uint32_t* out,
                                    int rows, int Ly, int F, int A, int logn,
                                    const uint32_t* lw, const uint32_t* lws,
                                    const int* dig, const uint32_t* w,
                                    const uint32_t* ws, const uint32_t* q,
                                    const uint32_t* c1, const int* out_map,
                                    int out_limbs, cudaStream_t stream) {
  if (bad_map(out_map, out_limbs, F))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned planes = static_cast<unsigned>(rows) * F;
  return launched(with_cluster(logn, [&](auto cluster) {
    constexpr int C = decltype(cluster)::value;
    return launch_planes<C>(lifted_kernel<C>, false, planes, logn, stream, y,
                            out, Ly, A, F, logn, lw, lws, dig, w, ws, q, c1,
                            out_map, out_limbs);
  }));
}

extern "C" int hetpu_ntt_fwd_fbc(const uint32_t* u, uint32_t* out, int rows,
                                 int A, int F, int logn, const uint32_t* phat,
                                 const uint32_t* phat_shoup,
                                 const float* recip, const uint32_t* ptot,
                                 const uint32_t* ptot_shoup,
                                 const uint32_t* w, const uint32_t* ws,
                                 const uint32_t* q, const uint32_t* c1,
                                 cudaStream_t stream) {
  const unsigned planes = static_cast<unsigned>(rows) * F;
  return launched(with_cluster(logn, [&](auto cluster) {
    constexpr int C = decltype(cluster)::value;
    return launch_planes<C>(fbc_kernel<C>, false, planes, logn, stream, u,
                            out, A, F, logn, phat, phat_shoup, recip, ptot,
                            ptot_shoup, w, ws, q, c1);
  }));
}

// recip == nullptr: no alpha (pm, pms unused); dig == nullptr: every
// output plane reads source planes 0..A-1; out_map as hetpu_ntt_fwd_lifted.
extern "C" int hetpu_ntt_fwd_centered(
    const uint32_t* y, uint32_t* out, int rows, int Ly, int F, int A,
    int logn, const uint32_t* cw, const uint32_t* cws, int wf, int wi,
    const int* dig, const uint32_t* q_src, const float* recip,
    const uint32_t* pm, const uint32_t* pms, const uint32_t* w,
    const uint32_t* ws, const uint32_t* q, const uint32_t* c1,
    const int* out_map, int out_limbs, cudaStream_t stream) {
  if (A < 1 || F < 1 || Ly < 1 || bad_map(out_map, out_limbs, F) ||
      (recip != nullptr && (pm == nullptr || pms == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned planes = static_cast<unsigned>(rows) * F;
  return launched(with_cluster(logn, [&](auto cluster) {
    constexpr int C = decltype(cluster)::value;
    if (recip != nullptr)
      return launch_planes<C>(centered_kernel<C, true>, false, planes, logn,
                              stream, y, out, Ly, A, F, logn, cw, cws, wf, wi,
                              dig, q_src, recip, pm, pms, w, ws, q, c1,
                              out_map, out_limbs);
    return launch_planes<C>(centered_kernel<C, false>, false, planes, logn,
                            stream, y, out, Ly, A, F, logn, cw, cws, wf, wi,
                            dig, q_src, recip, pm, pms, w, ws, q, c1,
                            out_map, out_limbs);
  }));
}
