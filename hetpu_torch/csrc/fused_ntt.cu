// Kernels `ntt_fwd_lifted` and `ntt_fwd_fbc`: a prologue that builds each
// output plane from several input planes, then the forward NTT of that
// plane in shared memory (the routine of the `ntt` kernel, ntt_common.cuh).
//
// Replaces the JAX package's TPU kernel hetpu/core/mxu_ntt.py
// `_pallas_call_lift` (:816) in its two forms:
//   * corr = false (entered via `ntt_fwd_lifted`, :919): the key-switch
//     digit lift  acc_f = sum_{i<A} shoup(y[dig_f*A + i], lw[f,i]) mod q_f;
//   * corr = true (entered via `ntt_fwd_fbc`, :962): the centered fast base
//     conversion  acc_f = sum_i shoup(u_i, (P/p_i) mod q_f) - alpha*(P mod q_f)
//     with alpha = round_half_even(sum_i f32(u_i) * f32(1/p_i)).
//
// Design: one thread block per (row, output prime f).  Each thread
// accumulates the prologue of its coefficients straight into the shared
// plane (the inputs are read coalesced; the lifted / converted plane never
// goes to device memory), then the block runs the forward NTT and stores
// with the optional x R epilogue.  The lift's short last digit has zero
// weights past the active primes; its source index is clamped to the last
// input plane exactly as the reference does (mxu_ntt.py:942-944), so no
// read leaves the input.  alpha is summed for i = 0..A-1 with __fmul_rn and
// __fadd_rn (no fused multiply-add) and rounded with rintf (half to even),
// the reference's f32 arithmetic step for step; a different order or an
// FMA would flip rare near-half roundings and shift a coefficient by P.
//
// Bound on the card: the NTT stages as in ntt.cu; the prologue adds A input
// planes read per output plane (the digit's planes are re-read by each of
// its F rows, mostly from L2).  Measured times are in PERF.md.
#include "ntt_common.cuh"

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

__global__ void fbc_kernel(const uint32_t* __restrict__ u,
                           uint32_t* __restrict__ out, int A, int F, int logn,
                           const uint32_t* __restrict__ phat,
                           const uint32_t* __restrict__ phat_shoup,
                           const float* __restrict__ recip,
                           const uint32_t* __restrict__ ptot,
                           const uint32_t* __restrict__ ptot_shoup,
                           const uint32_t* __restrict__ w,
                           const uint32_t* __restrict__ ws,
                           const uint32_t* __restrict__ q,
                           const uint32_t* __restrict__ c1) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const int f = static_cast<int>(blockIdx.x % F);
  const size_t row = blockIdx.x / F;
  const uint32_t qf = q[f];
  const uint32_t* ur = u + ((row * A) << logn);
  const uint32_t pm = ptot[f], pms = ptot_shoup[f];
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    uint32_t acc = 0;
    float al = 0.0f;
    for (int i = 0; i < A; ++i) {
      const uint32_t v = ur[(static_cast<size_t>(i) << logn) + k];
      acc = hetpu::mod_add(
          acc, hetpu::shoup_mul(v, phat[i * F + f], phat_shoup[i * F + f], qf),
          qf);
      al = __fadd_rn(al, __fmul_rn(__int2float_rn(static_cast<int>(v)),
                                   recip[i]));
    }
    const uint32_t alpha = static_cast<uint32_t>(static_cast<int>(rintf(al)));
    s[k] = hetpu::mod_sub(acc, hetpu::shoup_mul(alpha, pm, pms, qf), qf);
  }
  __syncthreads();
  const size_t toff = static_cast<size_t>(f) << logn;
  hetpu::ntt_fwd_smem(s, logn, w + toff, ws + toff, qf);
  hetpu::store_plane(s, out + ((row * F + f) << logn), logn, c1, nullptr, f,
                     qf);
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
  const size_t smem = hetpu::plane_smem(logn);
  cudaError_t err = cudaFuncSetAttribute(
      fbc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(rows) * F;
  fbc_kernel<<<blocks, hetpu::plane_threads(logn), smem, stream>>>(
      u, out, A, F, logn, phat, phat_shoup, recip, ptot, ptot_shoup, w, ws, q,
      c1);
  return static_cast<int>(cudaGetLastError());
}
