// Kernel `ntt`: negacyclic forward / inverse NTT of [rows, L, N] residue
// planes with one per-limb epilogue constant.
//
// Replaces the JAX package's TPU kernel hetpu/core/mxu_ntt.py
// `_pallas_call` (:710; body `_kernel_body` :644), which splits residues
// into int8 digits for the TPU's matrix unit, and computes the transform of
// hetpu/core/pallas_ntt.py `_fwd_call` (:137) and `_inv_call` (:178).
//
// Bound on the card: device memory moves 8 bytes a residue (one read, one
// write; 3.3 us for [8,9,N=2^14] at 3.35 TB/s, twiddle tables included),
// the butterflies need 3 integer multiplies each (1.7 us for the same
// shape at 64 INT32 lanes x 132 SMs x 1.98 GHz), so bytes bind.  The first
// design (one 1024-thread CTA a plane, 14 radix-2 stages each a shared-
// memory round trip and a barrier, two dependent twiddle loads per
// butterfly) ran at ~6% of that bound: latency-bound, with at most one SM
// a plane busy (16 of 132 SMs at the rescale's [8,2,1,N]).  This design is
// bound by integer issue instead: a butterfly is 3 multiplies and about 8
// adds and mins, so one instruction fewer a conditional subtract
// (ntt_common.cuh) showed in its time.
//
// Design (ntt_passes.cuh): ceil(logn / 3) register-radix passes of 8
// residues a thread, one barrier between passes; the twiddles of a pass in
// one record a thread, copied into shared memory (cp.async) while the
// first pass runs; 16-byte plane loads (inverse) and stores (forward); at
// most 40 registers a thread, so that an SM holds 1536 threads; a plane
// split over a cluster of C CTAs through distributed shared memory, so
// that a launch of few planes still fills the card (C is fixed by N:
// the smallest CTAs that keep 64 threads, cluster_ctas).  The epilogue is
// one Shoup multiply a residue by c1 (* c2) mod q: R (to Montgomery form),
// N^-1, N^-1 R^-1 (strip Montgomery form) or N^-1 R^-1 * extra.  The
// input's rows lie `in_stride` planes apart (L when it is contiguous), so
// a part of a ciphertext (ct[..., p, :, :], 3L planes a row) is read where
// it lies; the output is contiguous.  Measured times are in PERF.md.
#include "ntt_passes.cuh"

namespace {

using namespace hetpu::passes;

template <int C, bool kInverse>
__global__ void __launch_bounds__(kThreads, kMinCtas)
    ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
               int L, int logn, const uint32_t* __restrict__ tw,
               const uint32_t* __restrict__ tws,
               const uint32_t* __restrict__ q,
               const uint32_t* __restrict__ c1,
               const uint32_t* __restrict__ c2, int in_stride) {
  extern __shared__ uint32_t s[];
  const size_t plane = blockIdx.x / C;
  const int l = static_cast<int>(plane % L);
  const size_t row = plane / L;
  const uint32_t ql = q[l];
  const size_t toff = static_cast<size_t>(l) * table_size(logn);
  uint32_t c = 0, cs = 0;
  if (c1 != nullptr) {
    c = c1[l];
    if (c2 != nullptr) c = hetpu::mul_mod(c, c2[l], ql);
    cs = hetpu::shoup_of(c, ql);
  }
  const uint32_t* xp = x + ((row * in_stride + l) << logn);
  uint32_t* op = out + (plane << logn);
  if constexpr (kInverse)
    inv_plane<C>(s, logn, tw + toff, tws + toff, ql, xp, op, c1 != nullptr,
                 c, cs);
  else
    fwd_plane<C>(s, logn, tw + toff, tws + toff, ql, PlaneLoad{xp}, op,
                 c1 != nullptr, c, cs);
}

}  // namespace

extern "C" int hetpu_ntt(const uint32_t* x, uint32_t* out, int rows, int L,
                         int logn, const uint32_t* w, const uint32_t* ws,
                         const uint32_t* q, const uint32_t* c1,
                         const uint32_t* c2, int inverse, int in_stride,
                         cudaStream_t stream) {
  using namespace hetpu::passes;
  if (in_stride < L) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned planes = static_cast<unsigned>(rows) * L;
  const cudaError_t err = with_cluster(logn, [&](auto cluster) {
    constexpr int C = decltype(cluster)::value;
    return inverse ? launch_planes<C>(ntt_kernel<C, true>, true, planes, logn,
                                      stream, x, out, L, logn, w, ws, q, c1,
                                      c2, in_stride)
                   : launch_planes<C>(ntt_kernel<C, false>, false, planes,
                                      logn, stream, x, out, L, logn, w, ws, q,
                                      c1, c2, in_stride);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hetpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
