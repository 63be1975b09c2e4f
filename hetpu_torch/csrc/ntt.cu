// Kernel `ntt`: negacyclic forward / inverse NTT of [rows, L, N] residue
// planes with one per-limb epilogue constant.
//
// Replaces the JAX package's TPU kernel hetpu/core/mxu_ntt.py
// `_pallas_call` (:710; body `_kernel_body` :644), which splits residues
// into int8 digits for the TPU's matrix unit, and computes the transform of
// hetpu/core/pallas_ntt.py `_fwd_call` (:137) and `_inv_call` (:178).
//
// Design: one thread block per (row, limb) plane.  The whole plane lives in
// dynamic shared memory (N * 4 bytes: 64 KB at N = 2^14, so the kernel
// raises its shared-memory limit above the 48 KB default), so device
// memory sees one read and one write of the plane; the log2(N) butterfly
// stages run out of shared memory with a __syncthreads between stages.
// Twiddles and their Shoup companions are read from the flat [L, N] tables
// (cached in L1/L2).  The epilogue is one Shoup multiply per element by
// c1 (* c2) mod q: R (to Montgomery form), N^-1, N^-1 R^-1 (strip
// Montgomery form) or N^-1 R^-1 * extra.
//
// Bound on the card: the 14 shared-memory stages at N = 2^14 (about 115
// thousand butterflies per plane, each a Shoup multiply and two modular
// adds) plus the block barriers between them; device-memory traffic is
// 8 bytes per element.  Measured times are in PERF.md.
#include "ntt_common.cuh"

namespace {

__global__ void ntt_kernel(const uint32_t* __restrict__ x,
                           uint32_t* __restrict__ out, int L, int logn,
                           const uint32_t* __restrict__ w,
                           const uint32_t* __restrict__ ws,
                           const uint32_t* __restrict__ q,
                           const uint32_t* __restrict__ c1,
                           const uint32_t* __restrict__ c2, int inverse) {
  extern __shared__ uint32_t s[];
  const int n = 1 << logn;
  const size_t plane = blockIdx.x;
  const int l = static_cast<int>(plane % L);
  const uint32_t ql = q[l];
  const uint32_t* xp = x + (plane << logn);
  const uint32_t* wl = w + (static_cast<size_t>(l) << logn);
  const uint32_t* wsl = ws + (static_cast<size_t>(l) << logn);
  for (int k = threadIdx.x; k < n; k += blockDim.x) s[k] = xp[k];
  __syncthreads();
  if (inverse)
    hetpu::ntt_inv_smem(s, logn, wl, wsl, ql);
  else
    hetpu::ntt_fwd_smem(s, logn, wl, wsl, ql);
  hetpu::store_plane(s, out + (plane << logn), logn, c1, c2, l, ql);
}

}  // namespace

extern "C" int hetpu_ntt(const uint32_t* x, uint32_t* out, int rows, int L,
                         int logn, const uint32_t* w, const uint32_t* ws,
                         const uint32_t* q, const uint32_t* c1,
                         const uint32_t* c2, int inverse, cudaStream_t stream) {
  const size_t smem = hetpu::plane_smem(logn);
  cudaError_t err = cudaFuncSetAttribute(
      ntt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned planes = static_cast<unsigned>(rows) * L;
  ntt_kernel<<<planes, hetpu::plane_threads(logn), smem, stream>>>(
      x, out, L, logn, w, ws, q, c1, c2, inverse);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hetpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
