// Kernel `tensor_product`: the 2x2 product of Montgomery-NTT ciphertexts
//   t0 = c0*d0*R^-1,  t1 = (c0*d1 + c1*d0)*R^-1,  t2 = c1*d1*R^-1  (mod q_l)
// with R = 2^32, from x = (c0, c1) and y = (d0, d1) [rows, 2, L, N] into
// out [rows, 3, L, N]; the square form (y = x, read once) gives
// t1 = 2*c0*c1*R^-1.
//
// Replaces the JAX package's Karatsuba `Evaluator.multiply`
// (hetpu/core/evaluator.py:117) and `square` (:150) over `modular.mont_mul`
// (hetpu/core/modular.py:56), which XLA fuses into one loop under the
// evaluator's `jax.jit` (evaluator.py:48-59).  The port's eager twin
// (core/tensor_product.py `tensor_product_plain`) makes every Montgomery
// product, add and subtract its own int64 pass over device memory.
//
// Arithmetic: hetpu's 32-bit Montgomery REDC, with the 64-bit product in
// one instruction pair where the TPU emulates it in 16-bit halves:
// t = a*b; m = lo(t)*(-q^-1); u = hi(t) + hi(m*q) + (lo(t) != 0); one
// conditional subtract.  Every output is the canonical residue in [0, q),
// so Karatsuba (3 products) gives the bits of the schoolbook sum; the
// kernel keeps hetpu's Karatsuba.  core/tensor_product.py `redc_u32`
// spells the same steps in int64 for the CPU tests.
//
// Bound on the card: device-memory bytes (4 planes in, 3 out: 28 bytes an
// element, 16 for the square); 3 REDCs an element are about a tenth of
// that.  So the design is only about the bytes:
// * a thread owns 4 consecutive x of one limb of one row (a "quad": uint4
//   loads and stores, 16-byte aligned, N % 4 == 0), so a warp reads 512
//   contiguous bytes of each plane and issues its 4 (square: 2) loads
//   together;
// * q and -q^-1 are loaded once a thread from the limb's [L] constants (a
//   block's 256 quads span at most two limbs, so they hit in L1);
// * no shared memory, no tensor cores: nothing here is a matrix product.
//
// Kernel `tensor_product_acc`: the same 2x2 product added into a running
// sum, acc <- acc + x*y mod q_l in place, for the diagonal method's sum
// over rotation steps (linalg/batched.py `_matmul_diag_col`).  It replaces
// no TPU kernel: hetpu sums its products with jnp adds that XLA fuses, and
// the port ran K7 out of place, then five eager int32 passes of `mod_add`
// over the 3-part sum, after a broadcast copy of the one diagonal to every
// row.  One launch reads x [rows, 2, L, N] once, y [2, L, N] at a row
// stride of 0 (the diagonal, 2.4 MB at bench_n14, stays in L2 across the
// rows) or of a whole row, and acc [rows, 3, L, N] once, and writes acc
// once: 2 + 3 + 3 planes a row, the bytes bound of the fused step.  The
// first step (INIT) writes the product without reading acc.  It keeps
// K7's quad design and arithmetic; the sum takes one `hetpu::mod_add` a
// part, so it gives the bits of the product followed by the plain add.
#include "ntt_common.cuh"

namespace {

constexpr int kTpThreads = 256;   // quads a block

__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b,
                                             uint32_t q, uint32_t qn) {
  const uint64_t t = static_cast<uint64_t>(a) * b;
  const uint32_t lo = static_cast<uint32_t>(t);
  const uint32_t hi = static_cast<uint32_t>(t >> 32);
  const uint32_t m = lo * qn;
  const uint32_t u = hi + __umulhi(m, q) + (lo != 0u);   // < 2q
  return min(u, u - q);
}

template <bool SQUARE>
__device__ __forceinline__ void product(uint32_t c0, uint32_t c1,
                                        uint32_t d0, uint32_t d1, uint32_t q,
                                        uint32_t qn, uint32_t& t0,
                                        uint32_t& t1, uint32_t& t2) {
  using hetpu::mod_add;
  using hetpu::mod_sub;
  t0 = mont_mul(c0, d0, q, qn);
  t2 = mont_mul(c1, d1, q, qn);
  if (SQUARE) {
    const uint32_t t01 = mont_mul(c0, c1, q, qn);
    t1 = mod_add(t01, t01, q);
  } else {
    const uint32_t s = mont_mul(mod_add(c0, c1, q), mod_add(d0, d1, q), q,
                                qn);
    t1 = mod_sub(mod_sub(s, t0, q), t2, q);
  }
}

template <bool SQUARE>
__global__ void __launch_bounds__(kTpThreads)
    tensor_product_kernel(const uint4* __restrict__ x,
                          const uint4* __restrict__ y,
                          const uint32_t* __restrict__ q,
                          const uint32_t* __restrict__ qn,
                          uint4* __restrict__ out, size_t quads, int n4,
                          size_t ln4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kTpThreads +
                   threadIdx.x;
  if (i >= quads) return;
  const size_t row = i / ln4;
  const size_t at = i - row * ln4;           // l * n4 + quad
  const int l = static_cast<int>(at / n4);
  const uint32_t ql = __ldg(q + l), qnl = __ldg(qn + l);
  const uint4* xr = x + row * 2 * ln4 + at;
  const uint4 c0 = xr[0], c1 = xr[ln4];
  uint4 d0 = c0, d1 = c1;
  if (!SQUARE) {
    const uint4* yr = y + row * 2 * ln4 + at;
    d0 = yr[0];
    d1 = yr[ln4];
  }
  uint4 t0, t1, t2;
  product<SQUARE>(c0.x, c1.x, d0.x, d1.x, ql, qnl, t0.x, t1.x, t2.x);
  product<SQUARE>(c0.y, c1.y, d0.y, d1.y, ql, qnl, t0.y, t1.y, t2.y);
  product<SQUARE>(c0.z, c1.z, d0.z, d1.z, ql, qnl, t0.z, t1.z, t2.z);
  product<SQUARE>(c0.w, c1.w, d0.w, d1.w, ql, qnl, t0.w, t1.w, t2.w);
  uint4* o = out + row * 3 * ln4 + at;
  o[0] = t0;
  o[ln4] = t1;
  o[2 * ln4] = t2;
}

template <bool INIT>
__global__ void __launch_bounds__(kTpThreads)
    tensor_product_acc_kernel(const uint4* __restrict__ x,
                              const uint4* __restrict__ y, size_t y_row,
                              const uint32_t* __restrict__ q,
                              const uint32_t* __restrict__ qn,
                              uint4* __restrict__ acc, size_t quads, int n4,
                              size_t ln4) {
  using hetpu::mod_add;
  const size_t i = static_cast<size_t>(blockIdx.x) * kTpThreads +
                   threadIdx.x;
  if (i >= quads) return;
  const size_t row = i / ln4;
  const size_t at = i - row * ln4;           // l * n4 + quad
  const int l = static_cast<int>(at / n4);
  const uint32_t ql = __ldg(q + l), qnl = __ldg(qn + l);
  const uint4* xr = x + row * 2 * ln4 + at;
  const uint4* yr = y + row * y_row + at;
  uint4* o = acc + row * 3 * ln4 + at;
  // every load issued before the arithmetic: 4 (INIT) or 7 in flight
  const uint4 c0 = xr[0], c1 = xr[ln4];
  const uint4 d0 = __ldg(yr), d1 = __ldg(yr + ln4);
  uint4 a0{}, a1{}, a2{};
  if (!INIT) {
    a0 = o[0];
    a1 = o[ln4];
    a2 = o[2 * ln4];
  }
  uint4 t0, t1, t2;
  product<false>(c0.x, c1.x, d0.x, d1.x, ql, qnl, t0.x, t1.x, t2.x);
  product<false>(c0.y, c1.y, d0.y, d1.y, ql, qnl, t0.y, t1.y, t2.y);
  product<false>(c0.z, c1.z, d0.z, d1.z, ql, qnl, t0.z, t1.z, t2.z);
  product<false>(c0.w, c1.w, d0.w, d1.w, ql, qnl, t0.w, t1.w, t2.w);
  if (!INIT) {
    t0 = make_uint4(mod_add(a0.x, t0.x, ql), mod_add(a0.y, t0.y, ql),
                    mod_add(a0.z, t0.z, ql), mod_add(a0.w, t0.w, ql));
    t1 = make_uint4(mod_add(a1.x, t1.x, ql), mod_add(a1.y, t1.y, ql),
                    mod_add(a1.z, t1.z, ql), mod_add(a1.w, t1.w, ql));
    t2 = make_uint4(mod_add(a2.x, t2.x, ql), mod_add(a2.y, t2.y, ql),
                    mod_add(a2.z, t2.z, ql), mod_add(a2.w, t2.w, ql));
  }
  o[0] = t0;
  o[ln4] = t1;
  o[2 * ln4] = t2;
}

}  // namespace

// x, y: [rows, 2, L, n] (y ignored when `square`), q, qn: [L] (qn = -q^-1
// mod 2^32), out: [rows, 3, L, n]; all contiguous and 16-byte aligned.
extern "C" int hetpu_tensor_product(const uint32_t* x, const uint32_t* y,
                                    const uint32_t* q, const uint32_t* qn,
                                    uint32_t* out, int rows, int L, int n,
                                    int square, cudaStream_t stream) {
  if (n % 4 != 0 || rows < 0 || L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t ln4 = static_cast<size_t>(L) * (n / 4);
  const size_t quads = static_cast<size_t>(rows) * ln4;
  if (quads == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((quads + kTpThreads - 1) / kTpThreads);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  uint4* o4 = reinterpret_cast<uint4*>(out);
  if (square) {
    tensor_product_kernel<true><<<blocks, kTpThreads, 0, stream>>>(
        x4, x4, q, qn, o4, quads, n / 4, ln4);
  } else {
    tensor_product_kernel<false><<<blocks, kTpThreads, 0, stream>>>(
        x4, y4, q, qn, o4, quads, n / 4, ln4);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, 2, L, n]; y: 2 parts of [L, n] a row, rows `y_row` words apart
// (0: one y for every row; 2*L*n: a y a row); q, qn: [L]; acc: [rows, 3,
// L, n], read (unless `init`) and written in place; all 16-byte aligned.
extern "C" int hetpu_tensor_product_acc(const uint32_t* x, const uint32_t* y,
                                        long long y_row, const uint32_t* q,
                                        const uint32_t* qn, uint32_t* acc,
                                        int rows, int L, int n, int init,
                                        cudaStream_t stream) {
  if (n % 4 != 0 || rows < 0 || L <= 0 || y_row < 0 || y_row % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t ln4 = static_cast<size_t>(L) * (n / 4);
  const size_t quads = static_cast<size_t>(rows) * ln4;
  if (quads == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((quads + kTpThreads - 1) / kTpThreads);
  const uint4* x4 = reinterpret_cast<const uint4*>(x);
  const uint4* y4 = reinterpret_cast<const uint4*>(y);
  const size_t y_row4 = static_cast<size_t>(y_row / 4);
  uint4* a4 = reinterpret_cast<uint4*>(acc);
  if (init) {
    tensor_product_acc_kernel<true><<<blocks, kTpThreads, 0, stream>>>(
        x4, y4, y_row4, q, qn, a4, quads, n / 4, ln4);
  } else {
    tensor_product_acc_kernel<false><<<blocks, kTpThreads, 0, stream>>>(
        x4, y4, y_row4, q, qn, a4, quads, n / 4, ln4);
  }
  return static_cast<int>(cudaGetLastError());
}
