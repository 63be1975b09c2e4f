// Kernels of the card micro-benchmarks in hetpu_torch/probes/.  They
// replace the Pallas kernels of the JAX package's TPU probes (scripts/
// probe_*.py), which measured what one grid step, one kernel call, an s8
// matrix-unit product and each stage of the int8 NTT kernel cost on the
// TPU; here the same work measures the card.
//
// P1 `copy_planes` (probe_grid.py `make` :30 and `make_flat` :48,
// probe_overhead.py `copy_call` :21).  A u32 plane copy; each block copies
// rb rows of one limb, or rb rows of all L limbs, so the per-block cost can
// be read as the TPU's per-grid-step cost was.  Blocks run in parallel in
// no order, so the TPU probe's grid orders and dimension semantics have no
// counterpart.  Bound: device-memory bytes; 16-byte loads and stores.
//
// P2 `muladd_u32` (probe_overhead2.py `pcall` :45).  x * 2654435761 + 1
// mod 2^32, elementwise.  Bound: bytes; one 16-byte load and store a thread.
//
// P3 `dot_i8` (probe_u8_dot.py `try_pair` :20, probe_pallas_s8.py :14,
// probe_int8_mxu.py `pl_dot` :59 and `pl_dot8` :93).  out[p] = A @ B[p]
// with int32 sums, exact, for u8/s8 A and B: mma.sync m16n8k32 on the
// tensor cores.  A block keeps a 64-row slab of A in shared memory across
// its planes and stages each plane of B transposed (K contiguous for each
// column, the layout of the .col operand) with a 4x4 byte transpose.
// Bound: bytes at the probe's shapes (int32 out is 4x the int8 in);
// mma.sync without a pipeline reaches a fraction of the wgmma peak.
//
// P4 `plane_parts` (probe_kernel_parts.py `make` :57).  One block per
// [128, 128] u32 plane (row r, limb l) and one of the probe's six
// per-plane stages: copy; extract (XOR of the four balanced digits of
// _extract_digit_list); twiddle (one Shoup multiply by the limb's table);
// recomb (four Shoup multiplies of x + j by the scalars tw[l, 0, j] with
// modular adds); dot (w[l] [512, 512] s8 @ the int8 plane repeated four
// times along K, rows 0..127 kept); dot2 (that full product cast to int8,
// times w[l] again, rows 0..127 kept).  As in the probe, the dot variants
// issue the products of all 512 rows (asm volatile keeps them) though only
// 128 are stored.  w[l] (256 KB) does not fit shared memory: its fragments
// are read from L2, where all nine limbs' matrices (2.4 MB) stay.  Bound:
// bytes for copy, extract, twiddle, recomb and dot; tensor-core operations
// for dot2.  The bound counts only the products the stored rows depend on
// (a quarter of one product for dot; the first product and a quarter of
// the second for dot2), not the 512 rows issued.
#include "ntt_common.cuh"

namespace {

// ---------------------------------------------------------------- P1, P2

__global__ void copy_planes_kernel(const uint4* __restrict__ x,
                                   uint4* __restrict__ out, int L, int e4,
                                   int rb, int lb) {
  const int lblocks = L / lb;
  const int r0 = (blockIdx.x / lblocks) * rb;
  const int l0 = (blockIdx.x % lblocks) * lb;
  for (int p = 0; p < rb; ++p)
    for (int l = 0; l < lb; ++l) {
      const size_t base = (static_cast<size_t>(r0 + p) * L + l0 + l) * e4;
      for (int i = threadIdx.x; i < e4; i += blockDim.x)
        out[base + i] = x[base + i];
    }
}

constexpr uint32_t kMulConst = 2654435761u;

__global__ void muladd_kernel(const uint4* __restrict__ x,
                              uint4* __restrict__ out, size_t n4) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  uint4 v = x[i];
  v.x = v.x * kMulConst + 1u;
  v.y = v.y * kMulConst + 1u;
  v.z = v.z * kMulConst + 1u;
  v.w = v.w * kMulConst + 1u;
  out[i] = v;
}

// ---------------------------------------------------------------- mma

#define HETPU_MMA_I8(TA, TB)                                                 \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "    \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"     \
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])              \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1))

// c += A (16x32, row-major fragment a0..a3) x B (32x8, column fragment
// b0, b1); each register holds four 8-bit values, lowest byte first.
template <bool AU, bool BU>
__device__ __forceinline__ void mma_k32(int (&c)[4], uint32_t a0,
                                        uint32_t a1, uint32_t a2, uint32_t a3,
                                        uint32_t b0, uint32_t b1) {
  if constexpr (!AU && !BU) HETPU_MMA_I8("s8", "s8");
  else if constexpr (!AU && BU) HETPU_MMA_I8("s8", "u8");
  else if constexpr (AU && !BU) HETPU_MMA_I8("u8", "s8");
  else HETPU_MMA_I8("u8", "u8");
}

// Byte (k, n) of a 4x4 block given as four rows r0..r3 (byte j of ri is
// column j of row i) → four columns, byte i of column j = row i.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1,
                                             uint32_t r2, uint32_t r3,
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r0, r1, 0x5140);
  const uint32_t t1 = __byte_perm(r0, r1, 0x7362);
  const uint32_t t2 = __byte_perm(r2, r3, 0x5140);
  const uint32_t t3 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The low bytes of four u32 values (their int8 casts), first value lowest.
__device__ __forceinline__ uint32_t low_bytes(uint4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

// Thread i of a quad loop over a [4*kqs, 128] byte tile → (column quad nq,
// row quad kq): eight column quads by four row quads per warp.
__device__ __forceinline__ void quad_of(int i, int& nq, int& kq) {
  const int w = i >> 5, l = i & 31;
  nq = (w & 3) * 8 + (l & 7);
  kq = (w >> 2) * 4 + (l >> 3);
}

// ---------------------------------------------------------------- P3

constexpr int kDotRows = 64;    // rows of A per block
constexpr int kDotN = 128;      // columns of each B plane
constexpr int kThreads = 256;   // 8 warps: 4 row groups x 2 column halves

template <bool AU, bool BU>
__global__ void __launch_bounds__(kThreads)
    dot_i8_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ b,
                  int32_t* __restrict__ out, int M, int K, int batch,
                  int ppb) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int ks = K + 16;        // padded row stride: fragment reads hit
  const int ks4 = ks / 4;       // distinct banks
  uint8_t* as = smem;                    // [64][ks]   rows of A
  uint8_t* bt = smem + kDotRows * ks;    // [128][ks]  bt[n][k] = B[k][n]
  const uint32_t* as32 = reinterpret_cast<const uint32_t*>(as);
  uint32_t* bt32 = reinterpret_cast<uint32_t*>(bt);
  const int m0 = blockIdx.x * kDotRows;
  const int kv = K / 16;
  for (int i = threadIdx.x; i < kDotRows * kv; i += blockDim.x) {
    const int r = i / kv, c = i % kv;
    *reinterpret_cast<uint4*>(as + r * ks + c * 16) =
        *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + r) * K +
                                        c * 16);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int msub = warp & 3, nh = warp >> 2;
  const int arow = (msub * 16 + g) * ks4;
  const int p_end = min(batch, static_cast<int>(blockIdx.y + 1) * ppb);
  for (int p = blockIdx.y * ppb; p < p_end; ++p) {
    __syncthreads();  // A slab stored; the previous plane's bt reads done
    const uint8_t* bp = b + static_cast<size_t>(p) * K * kDotN;
    for (int i = threadIdx.x; i < K * kDotN / 16; i += blockDim.x) {
      int nq, kq;
      quad_of(i, nq, kq);
      const uint8_t* src = bp + static_cast<size_t>(4 * kq) * kDotN + 4 * nq;
      uint32_t c[4];
      transpose4x4(*reinterpret_cast<const uint32_t*>(src),
                   *reinterpret_cast<const uint32_t*>(src + kDotN),
                   *reinterpret_cast<const uint32_t*>(src + 2 * kDotN),
                   *reinterpret_cast<const uint32_t*>(src + 3 * kDotN), c);
      uint32_t* dst = bt32 + 4 * nq * ks4 + kq;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j * ks4] = c[j];
    }
    __syncthreads();
    int acc[8][4] = {};
    for (int kk = 0; kk < K / 32; ++kk) {
      const int kw = kk * 8 + t;
      const uint32_t a0 = as32[arow + kw], a1 = as32[arow + 8 * ks4 + kw];
      const uint32_t a2 = as32[arow + kw + 4];
      const uint32_t a3 = as32[arow + 8 * ks4 + kw + 4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int brow = (nh * 64 + j * 8 + g) * ks4 + kw;
        mma_k32<AU, BU>(acc[j], a0, a1, a2, a3, bt32[brow], bt32[brow + 4]);
      }
    }
    int32_t* op = out + (static_cast<size_t>(p) * M + m0 + msub * 16 + g) *
                            kDotN + nh * 64 + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<int2*>(op + j * 8) = make_int2(acc[j][0], acc[j][1]);
      *reinterpret_cast<int2*>(op + 8 * kDotN + j * 8) =
          make_int2(acc[j][2], acc[j][3]);
    }
  }
}

template <bool AU, bool BU>
int launch_dot(const void* a, const void* b, void* out, int M, int K,
               int batch, int ppb, cudaStream_t stream) {
  const int smem = (kDotRows + kDotN) * (K + 16);
  cudaError_t err = cudaFuncSetAttribute(
      dot_i8_kernel<AU, BU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(M / kDotRows, (batch + ppb - 1) / ppb);
  dot_i8_kernel<AU, BU><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b),
      static_cast<int32_t*>(out), M, K, batch, ppb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- P4

enum Part { kCopy = 0, kDot = 1, kDot2 = 2, kExtract = 3, kTwiddle = 4,
            kRecomb = 5 };

constexpr int kPn = 128;              // plane side
constexpr int kPlane = kPn * kPn;     // u32 per plane
constexpr int kWk = 4 * kPn;          // 512: w[l] is [kWk, kWk] s8
constexpr int kXs = kPn + 16;         // bytes per column of xt (k < 128)
constexpr int kGs = kWk + 16;         // bytes per column of gt (k < 512)
constexpr int kDotSmem = kPn * kXs;
constexpr int kDot2Smem = kPn * kXs + kPn * kGs;

template <int V>
__device__ __forceinline__ uint32_t elem_part(uint32_t x, uint32_t tw,
                                              uint32_t tws, uint32_t q,
                                              const uint32_t (&rc)[4],
                                              const uint32_t (&rcs)[4]) {
  if constexpr (V == kCopy) {
    return x;
  } else if constexpr (V == kExtract) {
    // _extract_digit_list(x, q, q // 2): balanced base-256 digits of the
    // centred value, XORed as sign-extended 32-bit words
    int v = static_cast<int>(x);
    if (v > static_cast<int>(q >> 1)) v -= static_cast<int>(q);
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int d = ((v + 128) & 255) - 128;
      acc ^= static_cast<uint32_t>(d);
      v = (v - d) >> 8;
    }
    return acc ^ static_cast<uint32_t>(static_cast<int>(
                     static_cast<int8_t>(static_cast<uint8_t>(v & 255))));
  } else if constexpr (V == kTwiddle) {
    return hetpu::shoup_mul(x, tw, tws, q);
  } else {  // kRecomb
    uint32_t acc = hetpu::shoup_mul(x, rc[0], rcs[0], q);
#pragma unroll
    for (int j = 1; j < 4; ++j)
      acc = hetpu::mod_add(acc, hetpu::shoup_mul(x + j, rc[j], rcs[j], q), q);
    return acc;
  }
}

// One k=32 step of rows [16*msub, 16*msub+16) of w (global, row-major
// [512][512] s8) against 16 column tiles of a transposed byte tile in
// shared memory (column stride cs4 words, word offset kw).
__device__ __forceinline__ void w_step(int (&acc)[16][4],
                                       const int8_t* __restrict__ wl,
                                       int msub, int kk, int g, int t,
                                       const uint32_t* bt32, int cs4, int kw) {
  const int8_t* wr = wl + (msub * 16 + g) * kWk + kk * 32 + t * 4;
  const uint32_t a0 = __ldg(reinterpret_cast<const unsigned*>(wr));
  const uint32_t a1 = __ldg(reinterpret_cast<const unsigned*>(wr + 8 * kWk));
  const uint32_t a2 = __ldg(reinterpret_cast<const unsigned*>(wr + 16));
  const uint32_t a3 =
      __ldg(reinterpret_cast<const unsigned*>(wr + 8 * kWk + 16));
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = (j * 8 + g) * cs4 + kw;
    mma_k32<false, false>(acc[j], a0, a1, a2, a3, bt32[col], bt32[col + 4]);
  }
}

// Rows 0..127 of a [512, 128] product, stored as u32.
__device__ __forceinline__ void store_rows(const int (&acc)[16][4],
                                           uint32_t* op, int msub, int g,
                                           int t) {
  uint32_t* o = op + (msub * 16 + g) * kPn + 2 * t;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint2*>(o + j * 8) = make_uint2(acc[j][0], acc[j][1]);
    *reinterpret_cast<uint2*>(o + 8 * kPn + j * 8) =
        make_uint2(acc[j][2], acc[j][3]);
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
    plane_parts_kernel(const uint32_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const uint32_t* __restrict__ tw,
                       const uint32_t* __restrict__ tws,
                       uint32_t* __restrict__ out, int L, uint32_t q) {
  const size_t plane = blockIdx.x;
  const int l = static_cast<int>(plane % L);
  const uint32_t* xp = x + plane * kPlane;
  uint32_t* op = out + plane * kPlane;
  if constexpr (V != kDot && V != kDot2) {
    const uint32_t* twl = tw + static_cast<size_t>(l) * kPlane;
    const uint32_t* twsl = tws + static_cast<size_t>(l) * kPlane;
    uint32_t rc[4], rcs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      rc[j] = V == kRecomb ? twl[j] : 0u;
      rcs[j] = V == kRecomb ? twsl[j] : 0u;
    }
    const uint4* x4 = reinterpret_cast<const uint4*>(xp);
    uint4* o4 = reinterpret_cast<uint4*>(op);
    for (int i = threadIdx.x; i < kPlane / 4; i += blockDim.x) {
      const uint4 v = x4[i];
      uint4 w4 = make_uint4(0, 0, 0, 0), s4 = w4;
      if constexpr (V == kTwiddle) {
        w4 = reinterpret_cast<const uint4*>(twl)[i];
        s4 = reinterpret_cast<const uint4*>(twsl)[i];
      }
      o4[i] = make_uint4(elem_part<V>(v.x, w4.x, s4.x, q, rc, rcs),
                         elem_part<V>(v.y, w4.y, s4.y, q, rc, rcs),
                         elem_part<V>(v.z, w4.z, s4.z, q, rc, rcs),
                         elem_part<V>(v.w, w4.w, s4.w, q, rc, rcs));
    }
  } else {
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* xt32 = reinterpret_cast<uint32_t*>(smem);   // [128][kXs]
    uint8_t* gt = smem + kDotSmem;                        // [128][kGs]
    const int8_t* wl = w + static_cast<size_t>(l) * kWk * kWk;
    const uint4* x4 = reinterpret_cast<const uint4*>(xp);
    // xt[n][k] = low byte of x[k][n]: the int8 cast, K-major per column
    for (int i = threadIdx.x; i < kPlane / 16; i += blockDim.x) {
      int nq, kq;
      quad_of(i, nq, kq);
      uint4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = x4[(4 * kq + j) * (kPn / 4) + nq];
      uint32_t c[4];
      transpose4x4(low_bytes(r[0]), low_bytes(r[1]), low_bytes(r[2]),
                   low_bytes(r[3]), c);
      uint32_t* dst = xt32 + 4 * nq * (kXs / 4) + kq;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[j * (kXs / 4)] = c[j];
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // first product: all 32 row tiles of w[l] @ xs, xs[k] = x8[k % 128]
    for (int s = 0; s < 4; ++s) {
      const int msub = warp + 8 * s;
      int acc[16][4] = {};
      for (int kk = 0; kk < kWk / 32; ++kk)
        w_step(acc, wl, msub, kk, g, t, xt32, kXs / 4, (kk & 3) * 8 + t);
      if constexpr (V == kDot) {
        if (msub < kPn / 16) store_rows(acc, op, msub, g, t);
      } else {
        // the int8 cast of the product, K-major per column for the second
        // product: gt[n][m] = low byte of g[m][n]
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          uint8_t* col = gt + (j * 8 + 2 * t) * kGs + msub * 16 + g;
          col[0] = static_cast<uint8_t>(acc[j][0]);
          col[kGs] = static_cast<uint8_t>(acc[j][1]);
          col[8] = static_cast<uint8_t>(acc[j][2]);
          col[kGs + 8] = static_cast<uint8_t>(acc[j][3]);
        }
      }
    }
    if constexpr (V == kDot2) {
      __syncthreads();
      const uint32_t* gt32 = reinterpret_cast<const uint32_t*>(gt);
      for (int s = 0; s < 4; ++s) {
        const int msub = warp + 8 * s;
        int acc[16][4] = {};
        for (int kk = 0; kk < kWk / 32; ++kk)
          w_step(acc, wl, msub, kk, g, t, gt32, kGs / 4, kk * 8 + t);
        if (msub < kPn / 16) store_rows(acc, op, msub, g, t);
      }
    }
  }
}

template <int V>
int launch_part(const void* x, const void* w, const void* tw, const void* tws,
                void* out, int planes, int L, uint32_t q,
                cudaStream_t stream) {
  const int smem = V == kDot ? kDotSmem : V == kDot2 ? kDot2Smem : 0;
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        plane_parts_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  plane_parts_kernel<V><<<planes, kThreads, smem, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const uint32_t*>(tw), static_cast<const uint32_t*>(tws),
      static_cast<uint32_t*>(out), L, q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hetpu_copy_planes(const void* x, void* out, int R, int L,
                                 int e4, int rb, int lb,
                                 cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(R / rb) * (L / lb);
  copy_planes_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out), L, e4, rb, lb);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetpu_muladd_u32(const void* x, void* out, long long n4,
                                cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((n4 + kThreads - 1) / kThreads);
  muladd_kernel<<<blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(out),
      static_cast<size_t>(n4));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int hetpu_dot_i8(const void* a, const void* b, void* out, int M,
                            int K, int batch, int ppb, int a_unsigned,
                            int b_unsigned, cudaStream_t stream) {
  if (a_unsigned)
    return b_unsigned ? launch_dot<true, true>(a, b, out, M, K, batch, ppb,
                                               stream)
                      : launch_dot<true, false>(a, b, out, M, K, batch, ppb,
                                                stream);
  return b_unsigned
             ? launch_dot<false, true>(a, b, out, M, K, batch, ppb, stream)
             : launch_dot<false, false>(a, b, out, M, K, batch, ppb, stream);
}

extern "C" int hetpu_plane_parts(const void* x, const void* w, const void* tw,
                                 const void* tws, void* out, int planes,
                                 int L, unsigned q, int variant,
                                 cudaStream_t stream) {
  switch (variant) {
    case kCopy:
      return launch_part<kCopy>(x, w, tw, tws, out, planes, L, q, stream);
    case kDot:
      return launch_part<kDot>(x, w, tw, tws, out, planes, L, q, stream);
    case kDot2:
      return launch_part<kDot2>(x, w, tw, tws, out, planes, L, q, stream);
    case kExtract:
      return launch_part<kExtract>(x, w, tw, tws, out, planes, L, q, stream);
    case kTwiddle:
      return launch_part<kTwiddle>(x, w, tw, tws, out, planes, L, q, stream);
    case kRecomb:
      return launch_part<kRecomb>(x, w, tw, tws, out, planes, L, q, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
