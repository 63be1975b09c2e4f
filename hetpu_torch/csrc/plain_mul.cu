// Kernel `plain_mul_sum`: the sum of up to three plaintext products,
//   out[b,p,l,:] = sum_k x_k[b,p,l,:] * w_k[l,:] mod q_l   (k < K <= 3),
// with the sources x_k [batch, parts, L, n] and each mask w_k (with its
// Shoup companion ws_k = floor(w_k * 2^32 / q_l)) one [L, n] plane set for
// every row (row stride 0) or one a batch row (row stride L*n words).
//
// Replaces hetpu's `Evaluator.multiply_plain` (hetpu/core/evaluator.py:109)
// over `modular.shoup_mul` (hetpu/core/modular.py:71), which XLA fuses
// into one 32-bit pass under the evaluator's `jax.jit`, together with the
// `mod_add` sum of the in-slot FFT's mask products (hetpu/fft/__init__.py:
// 176-178).  The port's eager twin (core/plain_mul.py
// `plain_mul_sum_plain`) makes each product an int64 pass over device
// memory (widen, multiply, remainder, narrow) and each add three int32
// passes: a `bfft` stage read its sources about six times.
//
// Arithmetic: hetpu's 32-bit Shoup product with the precomputed companion
// (q^ = umulhi(x, w'); r = x*w - q^*q mod 2^32 in [0, 2q); one conditional
// subtract), then `hetpu::mod_add` into the sum.  Every term and every
// partial sum is the canonical residue in [0, q), so the bits are the
// twin's whatever the order of the terms.
//
// Bound on the card: device-memory bytes (K source planes read and one
// written a row; the masks once); 3 integer multiplies a term are far
// below it.  So the design is about the bytes:
// * a thread owns one 16-byte quad column (limb l, x .. x+3), a block 256
//   of them; blocks are indexed by limb (blockIdx.y), so q_l sits in a
//   register, and by a chunk of batch rows (blockIdx.z);
// * the thread loads its column's mask and companion quads into registers
//   once and keeps them over its rows: a mask of one row is read at row
//   stride 0, never once a ciphertext and never through a broadcast copy;
//   a mask a batch row is loaded once for that row's parts;
// * the row loop takes two rows a step, their 2K source loads issued
//   before any arithmetic, so 2 to 6 16-byte loads are in flight a thread;
//   the sources are read once, with the streaming hint (__ldcs), which
//   leaves L2 to the masks that other chunks of the same columns re-read;
// * no shared memory, no tensor cores.
#include "ntt_common.cuh"

namespace {

constexpr int kPmThreads = 256;          // quad columns a block
constexpr int kPmMaxTerms = 3;
constexpr unsigned kPmTargetBlocks = 2048;   // ~15 waves of 132 SMs

struct Terms {
  const uint4* x[kPmMaxTerms];    // sources [batch, parts, L, n/4]
  const uint4* w[kPmMaxTerms];    // masks [L, n/4], one or one a batch row
  const uint4* ws[kPmMaxTerms];   // their Shoup companions, as the masks
};

__device__ __forceinline__ uint4 mul_quad(uint4 x, uint4 w, uint4 ws,
                                          uint32_t q) {
  using hetpu::shoup_mul;
  return make_uint4(shoup_mul(x.x, w.x, ws.x, q),
                    shoup_mul(x.y, w.y, ws.y, q),
                    shoup_mul(x.z, w.z, ws.z, q),
                    shoup_mul(x.w, w.w, ws.w, q));
}

__device__ __forceinline__ uint4 add_quad(uint4 a, uint4 b, uint32_t q) {
  using hetpu::mod_add;
  return make_uint4(mod_add(a.x, b.x, q), mod_add(a.y, b.y, q),
                    mod_add(a.z, b.z, q), mod_add(a.w, b.w, q));
}

template <int K>
__device__ __forceinline__ uint4 sum_terms(const uint4 (&x)[K],
                                           const uint4 (&w)[K],
                                           const uint4 (&ws)[K], uint32_t q) {
  uint4 s = mul_quad(x[0], w[0], ws[0], q);
#pragma unroll
  for (int k = 1; k < K; ++k) {
    s = add_quad(s, mul_quad(x[k], w[k], ws[k], q), q);
  }
  return s;
}

template <int K>
__device__ __forceinline__ void load_masks(const Terms& t, size_t at,
                                           uint4 (&w)[K], uint4 (&ws)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    w[k] = __ldg(t.w[k] + at);
    ws[k] = __ldg(t.ws[k] + at);
  }
}

template <int K>
__device__ __forceinline__ void load_sources(const Terms& t, size_t at,
                                             uint4 (&x)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) x[k] = __ldcs(t.x[k] + at);
}

// Rows [r, r1) of one quad column at `col` (its offset in a row's L*n/4
// quads), masks in registers; two rows a step.
template <int K>
__device__ __forceinline__ void rows_sum(const Terms& t, uint4* out,
                                         size_t r, size_t r1, size_t ln4,
                                         size_t col, const uint4 (&w)[K],
                                         const uint4 (&ws)[K], uint32_t q) {
  for (; r + 1 < r1; r += 2) {
    const size_t o0 = r * ln4 + col, o1 = o0 + ln4;
    uint4 x0[K], x1[K];
    load_sources<K>(t, o0, x0);
    load_sources<K>(t, o1, x1);
    out[o0] = sum_terms<K>(x0, w, ws, q);
    out[o1] = sum_terms<K>(x1, w, ws, q);
  }
  if (r < r1) {
    const size_t o = r * ln4 + col;
    uint4 x[K];
    load_sources<K>(t, o, x);
    out[o] = sum_terms<K>(x, w, ws, q);
  }
}

template <int K, bool PER_ROW>
__global__ void __launch_bounds__(kPmThreads)
    plain_mul_sum_kernel(Terms t, const uint32_t* __restrict__ q,
                         uint4* __restrict__ out, int batch, int chunk,
                         int parts, int n4, size_t ln4) {
  const int quad = blockIdx.x * kPmThreads + threadIdx.x;
  if (quad >= n4) return;
  const int l = blockIdx.y;
  const int b0 = blockIdx.z * chunk;
  const int b1 = min(batch, b0 + chunk);
  const uint32_t ql = __ldg(q + l);
  const size_t col = static_cast<size_t>(l) * n4 + quad;
  uint4 w[K], ws[K];
  if (PER_ROW) {
    for (int b = b0; b < b1; ++b) {
      load_masks<K>(t, b * ln4 + col, w, ws);
      rows_sum<K>(t, out, static_cast<size_t>(b) * parts,
                  static_cast<size_t>(b + 1) * parts, ln4, col, w, ws, ql);
    }
  } else {
    load_masks<K>(t, col, w, ws);
    rows_sum<K>(t, out, static_cast<size_t>(b0) * parts,
                static_cast<size_t>(b1) * parts, ln4, col, w, ws, ql);
  }
}

template <int K, bool PER_ROW>
void launch(const Terms& t, const uint32_t* q, uint4* out, int batch,
            int parts, int L, int n4, cudaStream_t stream) {
  const unsigned bx = (n4 + kPmThreads - 1) / kPmThreads;
  const unsigned xy = bx * static_cast<unsigned>(L);
  // batch rows a block: enough blocks to fill the card several times over
  const unsigned want = (kPmTargetBlocks + xy - 1) / xy;   // >= 1
  const unsigned z0 = want < static_cast<unsigned>(batch)
                          ? want : static_cast<unsigned>(batch);
  const int chunk = static_cast<int>((batch + z0 - 1) / z0);
  const unsigned z = static_cast<unsigned>((batch + chunk - 1) / chunk);
  plain_mul_sum_kernel<K, PER_ROW><<<dim3(bx, L, z), kPmThreads, 0, stream>>>(
      t, q, out, batch, chunk, parts, n4, static_cast<size_t>(L) * n4);
}

}  // namespace

// x_k: [batch, parts, L, n] (k < terms; the others null); w_k, ws_k: [L, n]
// masks and companions, batch rows `w_row` words apart (0: one mask for
// every row; L*n: a mask a batch row); q: [L]; out: [batch, parts, L, n].
// All contiguous and 16-byte aligned.
extern "C" int hetpu_plain_mul_sum(
    const uint32_t* x0, const uint32_t* w0, const uint32_t* ws0,
    const uint32_t* x1, const uint32_t* w1, const uint32_t* ws1,
    const uint32_t* x2, const uint32_t* w2, const uint32_t* ws2, int terms,
    long long w_row, const uint32_t* q, uint32_t* out, int batch, int parts,
    int L, int n, cudaStream_t stream) {
  const long long plane = static_cast<long long>(L) * n;
  if (n % 4 != 0 || batch < 0 || parts <= 0 || L <= 0 || L > 65535 ||
      terms < 1 || terms > kPmMaxTerms || (w_row != 0 && w_row != plane)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  const uint32_t* xs[kPmMaxTerms] = {x0, x1, x2};
  const uint32_t* wv[kPmMaxTerms] = {w0, w1, w2};
  const uint32_t* wsv[kPmMaxTerms] = {ws0, ws1, ws2};
  Terms t{};
  for (int k = 0; k < terms; ++k) {
    t.x[k] = reinterpret_cast<const uint4*>(xs[k]);
    t.w[k] = reinterpret_cast<const uint4*>(wv[k]);
    t.ws[k] = reinterpret_cast<const uint4*>(wsv[k]);
  }
  uint4* o = reinterpret_cast<uint4*>(out);
  const int n4 = n / 4;
  const bool per_row = w_row != 0;
  switch (terms * 2 + per_row) {
    case 2: launch<1, false>(t, q, o, batch, parts, L, n4, stream); break;
    case 3: launch<1, true>(t, q, o, batch, parts, L, n4, stream); break;
    case 4: launch<2, false>(t, q, o, batch, parts, L, n4, stream); break;
    case 5: launch<2, true>(t, q, o, batch, parts, L, n4, stream); break;
    case 6: launch<3, false>(t, q, o, batch, parts, L, n4, stream); break;
    default: launch<3, true>(t, q, o, batch, parts, L, n4, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}
