// Kernel `inner_product`: the key-switch multiply-accumulate
//   out[b, c, r, x] = sum_j shoup(ext[b, j, r, x], k[j, c, r, x],
//                                 ks[j, c, r, x]) mod q[r],   c in {0, 1}.
//
// Replaces the JAX package's TPU kernel hetpu/core/ip_kernel.py `_call`
// (:75), whose grid keeps each limb's key slab in on-chip memory across the
// batch.  On the TPU the compiler fuses the elementwise form instead; here
// nothing fuses the eager PyTorch ops, so the MAC needs this kernel.
//
// Bound on the card: device-memory bytes at every path shape (per batch
// row 4*J*R*N bytes of digits in and 8*R*N out, plus 16*J*R*N bytes of keys
// once); the 3 integer multiplies a Shoup product come within 0.7x of it at
// ckks_hi x64 (J = 3, B = 64).  The design:
//
// * A thread owns 4 consecutive x of one limb r (a "quad": uint4 loads and
//   stores, 16-byte aligned, N % 4 == 0) for a tile of BT batch rows; a
//   block's 128 threads take 128 consecutive quads, so a warp reads 512
//   contiguous bytes of each plane.
// * j is the outer loop: the thread loads its key quads k, ks for c = 0, 1
//   once a j for the whole tile, issues the tile's BT digit quads together,
//   then Shoup-accumulates BT x 2 x 4 sums in registers.  Each sum runs
//   over j in ascending order from 0, as the reference's, so the bits do
//   not depend on BT.
// * BT (4, 2 or 1) and the grid are chosen by the wrapper from (B, R, N)
//   (core/ip_kernel.py `ip_tiles`): the widest tile that still gives the
//   card enough threads, so keys are read as few times as the card allows.
//   (8-row tiles ran slower at every path shape: PERF.md §6.)
//   Consecutive blocks take the tiles of one range of quads, so a key quad
//   read by one tile is in L2 for the others; digits and outputs stream
//   past it (evict-first loads and stores).
#include "ntt_common.cuh"

namespace {

constexpr int kIpThreads = 128;   // quads a block

template <int BT>
__global__ void __launch_bounds__(kIpThreads)
    ip_kernel(const uint4* __restrict__ ext, const uint4* __restrict__ k,
              const uint4* __restrict__ ks, const uint32_t* __restrict__ q,
              uint4* __restrict__ out, int B, int J, size_t rn4, int n4,
              int tiles) {
  const int tile = static_cast<int>(blockIdx.x % tiles);
  const size_t qi = static_cast<size_t>(blockIdx.x / tiles) * kIpThreads +
                    threadIdx.x;
  if (qi >= rn4) return;
  const uint32_t qr = q[qi / n4];
  const int b0 = tile * BT;
  const int rows = min(BT, B - b0);
  uint32_t acc[BT][8];
#pragma unroll
  for (int i = 0; i < BT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0;
  for (int j = 0; j < J; ++j) {
    const size_t k0 = (2 * static_cast<size_t>(j)) * rn4 + qi;
    const uint4 w0 = __ldg(k + k0), w1 = __ldg(k + k0 + rn4);
    const uint4 s0 = __ldg(ks + k0), s1 = __ldg(ks + k0 + rn4);
    uint4 d[BT];
#pragma unroll
    for (int i = 0; i < BT; ++i)
      if (i < rows)
        d[i] = __ldcs(ext + (static_cast<size_t>(b0 + i) * J + j) * rn4 + qi);
#pragma unroll
    for (int i = 0; i < BT; ++i) {
      if (i >= rows) continue;
      const uint32_t v[4] = {d[i].x, d[i].y, d[i].z, d[i].w};
      const uint32_t kw[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const uint32_t kq[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[i][e] = hetpu::mod_add(
            acc[i][e], hetpu::shoup_mul(v[e & 3], kw[e], kq[e], qr), qr);
    }
  }
#pragma unroll
  for (int i = 0; i < BT; ++i) {
    if (i >= rows) continue;
    uint4* o = out + (static_cast<size_t>(b0 + i) * 2) * rn4 + qi;
    __stcs(o, make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
    __stcs(o + rn4, make_uint4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]));
  }
}

template <int BT>
cudaError_t launch_ip(const void* ext, const void* k, const void* ks,
                      const uint32_t* q, void* out, int B, int J, int R,
                      int n, cudaStream_t stream) {
  const size_t rn4 = static_cast<size_t>(R) * n / 4;
  const int tiles = (B + BT - 1) / BT;
  const size_t blocks = (rn4 + kIpThreads - 1) / kIpThreads * tiles;
  ip_kernel<BT><<<static_cast<unsigned>(blocks), kIpThreads, 0, stream>>>(
      static_cast<const uint4*>(ext), static_cast<const uint4*>(k),
      static_cast<const uint4*>(ks), q, static_cast<uint4*>(out), B, J, rn4,
      n / 4, tiles);
  return cudaGetLastError();
}

}  // namespace

// ``bt``: batch rows a thread (4, 2 or 1), chosen by the wrapper.
extern "C" int hetpu_inner_product(const uint32_t* ext, const uint32_t* k,
                                   const uint32_t* ks, const uint32_t* q,
                                   uint32_t* out, int B, int J, int R, int n,
                                   int bt, cudaStream_t stream) {
  if (n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (bt) {
    case 4: return static_cast<int>(launch_ip<4>(ext, k, ks, q, out, B, J,
                                                 R, n, stream));
    case 2: return static_cast<int>(launch_ip<2>(ext, k, ks, q, out, B, J,
                                                 R, n, stream));
    case 1: return static_cast<int>(launch_ip<1>(ext, k, ks, q, out, B, J,
                                                 R, n, stream));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
