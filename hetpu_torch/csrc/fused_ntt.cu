// Kernels `ntt_fwd_lifted` and `ntt_fwd_fbc`: a prologue that builds each
// output plane from several input planes, then the forward NTT of that
// plane.
//
// Replaces the JAX package's TPU kernel hetpu/core/mxu_ntt.py
// `_pallas_call_lift` (:816) in its two forms:
//   * corr = false (entered via `ntt_fwd_lifted`, :919): the key-switch
//     digit lift  acc_f = sum_{i<A} shoup(y[dig_f*A + i], lw[f,i]) mod q_f;
//   * corr = true (entered via `ntt_fwd_fbc`, :962): the centered fast base
//     conversion  acc_f = sum_i shoup(u_i, (P/p_i) mod q_f) - alpha*(P mod q_f)
//     with alpha = round_half_even(sum_i f32(u_i) * f32(1/p_i)).
// In both the lifted / converted plane never goes to device memory.
//
// `ntt_fwd_lifted` (K2): one thread block per (row, output prime f); each
// thread accumulates the lift of its coefficients into the shared plane,
// then the block runs the radix-2 shared-memory NTT of ntt_common.cuh.  The
// lift's short last digit has zero weights past the active primes; its
// source index is clamped to the last input plane exactly as the reference
// does (mxu_ntt.py:942-944), so no read leaves the input.
//
// `ntt_fwd_fbc` (K3): the register-radix passes of the `ntt` kernel
// (ntt_passes.cuh), the conversion being the first pass's column loader.
// Bound on the card: bytes, A source planes read a row (each re-read by the
// F output planes of its row, mostly from L2) and F planes written; the
// first design (one CTA a plane, 14 shared-memory stages, one dependent
// source load a term) ran at ~6% of it.  Now each thread converts the 8
// columns v + j*N/8 it holds in pass 0, its 8 loads of a source plane
// issued together; with a cluster of C CTAs a plane, each CTA converts only
// its N/C columns.  alpha is the chain of fused multiply-adds
// al = __fmaf_rn(f32(u_i), recip_i, al) for i = 0..A-1 from al = 0, rounded
// with rintf (half to even): the reference's jitted jnp.sum compiles to
// exactly this chain.  A multiply and an add rounded separately, or another
// order, would flip rare near-half roundings and shift a coefficient by P.
// The explicit intrinsic fuses whatever --fmad says.  Measured times are
// in PERF.md.
#include "ntt_passes.cuh"

namespace {

__global__ void lifted_kernel(const uint32_t* __restrict__ y,
                              uint32_t* __restrict__ out, int Ly, int F,
                              int A, int logn,
                              const uint32_t* __restrict__ lw,
                              const uint32_t* __restrict__ lws,
                              const int* __restrict__ dig,
                              const uint32_t* __restrict__ w,
                              const uint32_t* __restrict__ ws,
                              const uint32_t* __restrict__ q,
                              const uint32_t* __restrict__ c1) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int f = static_cast<int>(blockIdx.x % F);
  const size_t row = blockIdx.x / F;
  const uint32_t qf = q[f];
  const uint32_t* yr = y + ((row * Ly) << logn);
  const int base = dig[f] * A;
  const uint32_t* lwf = lw + static_cast<size_t>(f) * A;
  const uint32_t* lwsf = lws + static_cast<size_t>(f) * A;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    uint32_t acc = 0;
    for (int i = 0; i < A; ++i) {
      const int src = min(base + i, Ly - 1);
      const uint32_t v = yr[(static_cast<size_t>(src) << logn) + k];
      acc = hetpu::mod_add(acc, hetpu::shoup_mul(v, lwf[i], lwsf[i], qf), qf);
    }
    s[k] = acc;
  }
  __syncthreads();
  const size_t toff = static_cast<size_t>(f) << logn;
  hetpu::ntt_fwd_smem(s, logn, w + toff, ws + toff, qf);
  hetpu::store_plane(s, out + ((row * F + f) << logn), logn, c1, nullptr, f,
                     qf);
}

// Pass-0 loader of `ntt_fwd_fbc`: the converted residues of columns
// v + j*cols of output prime f.
struct FbcLoad {
  const uint32_t* __restrict__ u;  // the row's A source planes
  int A, F, f, logn;
  const uint32_t* __restrict__ phat;
  const uint32_t* __restrict__ phat_shoup;
  const float* __restrict__ recip;
  uint32_t pm, pms, q;

  __device__ __forceinline__ void operator()(uint32_t (&x)[hetpu::passes::kE],
                                             int v, int cols) const {
    constexpr int kE = hetpu::passes::kE;
    float al[kE];
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      x[j] = 0;
      al[j] = 0.0f;
    }
    for (int i = 0; i < A; ++i) {
      const uint32_t* ui = u + (static_cast<size_t>(i) << logn) + v;
      uint32_t y[kE];
#pragma unroll
      for (int j = 0; j < kE; ++j) y[j] = __ldg(ui + j * cols);
      const uint32_t w = __ldg(phat + i * F + f);
      const uint32_t ws = __ldg(phat_shoup + i * F + f);
      const float rc = __ldg(recip + i);
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        x[j] = hetpu::mod_add(x[j], hetpu::shoup_mul(y[j], w, ws, q), q);
        al[j] = __fmaf_rn(__int2float_rn(static_cast<int>(y[j])), rc, al[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const uint32_t alpha =
          static_cast<uint32_t>(static_cast<int>(rintf(al[j])));
      x[j] = hetpu::mod_sub(x[j], hetpu::shoup_mul(alpha, pm, pms, q), q);
    }
  }
};

template <int C>
__global__ void __launch_bounds__(hetpu::passes::kThreads,
                                  hetpu::passes::kMinCtas)
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
  const size_t plane = blockIdx.x / C;
  const int f = static_cast<int>(plane % F);
  const size_t row = plane / F;
  const uint32_t qf = q[f];
  const size_t toff = static_cast<size_t>(f) * hetpu::passes::table_size(logn);
  uint32_t c = 0, cs = 0;
  if (c1 != nullptr) {
    c = c1[f];
    cs = hetpu::shoup_of(c, qf);
  }
  const FbcLoad load{u + ((row * A) << logn), A, F, f, logn, phat,
                     phat_shoup, recip, ptot[f], ptot_shoup[f], qf};
  hetpu::passes::fwd_plane<C>(s, logn, tw + toff, tws + toff, qf, load,
                              out + (plane << logn), c1 != nullptr, c, cs);
}

}  // namespace

extern "C" int hetpu_ntt_fwd_lifted(const uint32_t* y, uint32_t* out,
                                    int rows, int Ly, int F, int A, int logn,
                                    const uint32_t* lw, const uint32_t* lws,
                                    const int* dig, const uint32_t* w,
                                    const uint32_t* ws, const uint32_t* q,
                                    const uint32_t* c1, cudaStream_t stream) {
  const size_t smem = hetpu::plane_smem(logn);
  cudaError_t err = cudaFuncSetAttribute(
      lifted_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(rows) * F;
  lifted_kernel<<<blocks, hetpu::plane_threads(logn), smem, stream>>>(
      y, out, Ly, F, A, logn, lw, lws, dig, w, ws, q, c1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetpu_ntt_fwd_fbc(const uint32_t* u, uint32_t* out, int rows,
                                 int A, int F, int logn, const uint32_t* phat,
                                 const uint32_t* phat_shoup,
                                 const float* recip, const uint32_t* ptot,
                                 const uint32_t* ptot_shoup,
                                 const uint32_t* w, const uint32_t* ws,
                                 const uint32_t* q, const uint32_t* c1,
                                 cudaStream_t stream) {
  using namespace hetpu::passes;
  const unsigned planes = static_cast<unsigned>(rows) * F;
  const cudaError_t err = with_cluster(logn, [&](auto cluster) {
    constexpr int C = decltype(cluster)::value;
    return launch_planes<C>(fbc_kernel<C>, false, planes, logn, stream, u,
                            out, A, F, logn, phat, phat_shoup, recip, ptot,
                            ptot_shoup, w, ws, q, c1);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
