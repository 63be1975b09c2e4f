// Kernel `inner_product`: the key-switch multiply-accumulate
//   out[b, c, r, x] = sum_j shoup(ext[b, j, r, x], k[j, c, r, x],
//                                 ks[j, c, r, x]) mod q[r],   c in {0, 1}.
//
// Replaces the JAX package's TPU kernel hetpu/core/ip_kernel.py `_call`
// (:75), whose grid keeps each limb's key slab in on-chip memory across the
// batch.  On the TPU the compiler fuses the elementwise form instead; here
// nothing fuses the eager PyTorch ops, so the MAC needs this kernel.
//
// Design: one thread per key element (r, x) of the [R, N] key basis, a loop
// over the batch inside and the J digits inside that.  Each thread writes
// both outputs c = 0, 1 from one read of its extended digit, so the digit
// planes are read once; the thread's key elements are re-read per batch row
// from L1/L2 rather than device memory.  Sums are canonical residues, so
// the j order does not change the result.
//
// Bound on the card: device-memory bandwidth — per batch row 4*J*R*N bytes
// of digits in and 8*R*N bytes out, plus the 16*J*R*N bytes of keys once.
// Measured times are in PERF.md.
#include "ntt_common.cuh"

namespace {

__global__ void ip_kernel(const uint32_t* __restrict__ ext,
                          const uint32_t* __restrict__ k,
                          const uint32_t* __restrict__ ks,
                          const uint32_t* __restrict__ q,
                          uint32_t* __restrict__ out, int B, int J, int R,
                          int n) {
  const size_t rn = static_cast<size_t>(R) * n;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rn) return;
  const uint32_t qr = q[idx / n];
  for (int b = 0; b < B; ++b) {
    uint32_t acc0 = 0, acc1 = 0;
    for (int j = 0; j < J; ++j) {
      const uint32_t e = ext[(static_cast<size_t>(b) * J + j) * rn + idx];
      const size_t k0 = (static_cast<size_t>(j) * 2) * rn + idx;
      const size_t k1 = k0 + rn;
      acc0 = hetpu::mod_add(acc0, hetpu::shoup_mul(e, k[k0], ks[k0], qr), qr);
      acc1 = hetpu::mod_add(acc1, hetpu::shoup_mul(e, k[k1], ks[k1], qr), qr);
    }
    out[(static_cast<size_t>(b) * 2) * rn + idx] = acc0;
    out[(static_cast<size_t>(b) * 2 + 1) * rn + idx] = acc1;
  }
}

}  // namespace

extern "C" int hetpu_inner_product(const uint32_t* ext, const uint32_t* k,
                                   const uint32_t* ks, const uint32_t* q,
                                   uint32_t* out, int B, int J, int R, int n,
                                   cudaStream_t stream) {
  const size_t rn = static_cast<size_t>(R) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((rn + threads - 1) / threads);
  ip_kernel<<<blocks, threads, 0, stream>>>(ext, k, ks, q, out, B, J, R, n);
  return static_cast<int>(cudaGetLastError());
}
