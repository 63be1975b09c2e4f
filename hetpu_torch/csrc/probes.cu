// Kernels of the card micro-benchmarks in hetpu_torch/probes/.  They
// replace the Pallas kernels of the JAX package's TPU probes (scripts/
// probe_*.py), which measured what one grid step, one kernel call, an s8
// matrix-unit product and each stage of the int8 NTT kernel cost on the
// TPU; here the same work measures the card.
//
// P1 `copy_planes` (probe_grid.py `make` :30 and `make_flat` :48,
// probe_overhead.py `copy_call` :21).  A u32 plane copy; each block copies
// rb rows of one limb, or rb rows of all L limbs, so the per-block cost can
// be read as the TPU's per-grid-step cost was.  One CTA a block; its planes
// move through a ring of 32 KB shared-memory stages by 1-D bulk copies
// (TMA): one thread loads (cp.async.bulk into a stage, completing on the
// stage's full mbarrier), another stores (cp.async.bulk out of the stage,
// one bulk group a stage) and frees the stage once its store has been read
// out, so half the ring is in flight each way.  The ring is 192 KB where a
// block has its SM alone and shrinks to share an SM (copy_stages).  A
// block's planes are one contiguous run when they are (all limbs, or one
// limb of L = 1) and rb runs otherwise; small planes fold into one stage.
// Blocks run in parallel in no order, so the TPU probe's grid orders and
// dimension semantics have no counterpart.  Bound: device-memory bytes; a
// lone block reaches ~50 GB/s each way (one SM's bulk copies).
//
// P2 `muladd_u32` (probe_overhead2.py `pcall` :45).  x * 2654435761 + 1
// mod 2^32, elementwise.  Bound: bytes; one 16-byte load and store a thread.
//
// P3 `dot_i8` lives in dot_i8.cu (wgmma, TMA).
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
#include "hopper.cuh"
#include "ntt_common.cuh"

namespace {

// ---------------------------------------------------------------- P1, P2

constexpr int kThreads = 256;
constexpr int kCopyStage = 32768;      // bytes of a ring stage
constexpr int kCopyMaxStages = 6;      // 192 KB: the ring of a lone block
constexpr int kCopyRingSm = kCopyMaxStages * kCopyStage;  // ring bytes an SM

// A block's bytes are ``runs`` runs of ``run`` contiguous bytes, run i at
// byte ``base + i * stride`` of x and of out; fill f is the block's bytes
// [f * kCopyStage, (f + 1) * kCopyStage) in run order, cut at run ends
// into bulk copies of stage s = f % stages.  Loads complete on full[s];
// stores go out in one bulk group a fill.
struct CopyRuns {
  long long base, stride, run, total;
};

__device__ __forceinline__ void copy_fill(const CopyRuns& r, long long f,
                                          uint8_t* stage, const uint8_t* x,
                                          uint8_t* out, uint64_t* bar) {
  long long c = f * kCopyStage;
  const long long end = min(c + kCopyStage, r.total);
  if (bar) hetpu::mbar_expect_tx(bar, static_cast<uint32_t>(end - c));
  for (uint8_t* s = stage; c < end;) {
    const long long i = c / r.run, off = c - i * r.run;
    const uint32_t n = static_cast<uint32_t>(min(r.run - off, end - c));
    const long long g = r.base + i * r.stride + off;
    if (bar) hetpu::bulk_load(s, x + g, n, bar);
    else hetpu::bulk_store(out + g, s, n);
    s += n;
    c += n;
  }
}

// Waits until at most n (0..6) of this thread's bulk groups still read
// shared memory.
__device__ __forceinline__ void bulk_wait_read(int n) {
  switch (n) {
    case 0: hetpu::bulk_wait_read<0>(); break;
    case 1: hetpu::bulk_wait_read<1>(); break;
    case 2: hetpu::bulk_wait_read<2>(); break;
    case 3: hetpu::bulk_wait_read<3>(); break;
    case 4: hetpu::bulk_wait_read<4>(); break;
    case 5: hetpu::bulk_wait_read<5>(); break;
    default: hetpu::bulk_wait_read<6>(); break;
  }
}

// Two elected threads a block drive a ring of ``stages`` shared-memory
// stages: lane 0 of warp 0 loads fill f into stage f % stages once the
// stage is empty, lane 0 of warp 1 stores it once it is full and marks the
// stage of fill f - d empty again (d = stages / 2) once that store has been
// read out (bulk groups waited with .read), so half the ring is in flight
// as loads and half as stores, and loads never wait behind a store.
__global__ void __launch_bounds__(64)
    copy_planes_kernel(const uint8_t* __restrict__ x,
                       uint8_t* __restrict__ out, int L, long long plane,
                       int rb, int lb, int stages) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[kCopyMaxStages], empty[kCopyMaxStages];
  const int lblocks = L / lb;
  CopyRuns r;
  r.base = ((static_cast<long long>(blockIdx.x / lblocks) * rb) * L +
            (blockIdx.x % lblocks) * lb) * plane;
  r.stride = L * plane;
  r.run = lb * plane;
  long long runs = rb;
  if (lb == L) {  // the block's planes are contiguous: one run
    r.run *= rb;
    runs = 1;
  }
  r.total = r.run * runs;
  const long long fills = (r.total + kCopyStage - 1) / kCopyStage;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hetpu::mbar_init(&full[s], 1);
      hetpu::mbar_init(&empty[s], 1);
    }
    hetpu::mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (long long f = 0; f < fills; ++f) {
      const int s = static_cast<int>(f % stages);
      hetpu::mbar_wait(&empty[s],
                       static_cast<uint32_t>(((f / stages) & 1) ^ 1));
      copy_fill(r, f, ring + s * kCopyStage, x, out, &full[s]);
    }
  } else if (threadIdx.x == 32) {
    const int d = stages > 1 ? stages / 2 : 1;  // stores left in flight
    for (long long f = 0; f < fills; ++f) {
      const int s = static_cast<int>(f % stages);
      hetpu::mbar_wait(&full[s], static_cast<uint32_t>((f / stages) & 1));
      copy_fill(r, f, ring + s * kCopyStage, x, out, nullptr);
      hetpu::bulk_commit();
      if (f >= d) {  // fill f - d's stage, once its store is read out
        bulk_wait_read(d);
        hetpu::mbar_arrive(&empty[(f - d) % stages]);
      }
    }
    hetpu::bulk_wait<0>();
  }
}

// Stages a block: the ring an SM holds (kCopyRingSm) shared by the blocks
// that land on one SM, at least 2 (one loading, one storing), at most 6,
// and no more than the block's fills.
int copy_stages(long long blocks, long long fills, int sms) {
  const long long per_sm = (blocks + sms - 1) / sms;
  long long s = kCopyRingSm / (per_sm * kCopyStage);
  s = s < 2 ? 2 : s > kCopyMaxStages ? kCopyMaxStages : s;
  return static_cast<int>(fills < s ? fills : s);
}

uint64_t copy_smem_set = 0;  // devices whose smem limit is set

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
  const long long plane = 16LL * e4;
  const long long blocks = static_cast<long long>(R / rb) * (L / lb);
  const long long bytes = static_cast<long long>(rb) * lb * plane;
  const int stages = copy_stages(blocks, (bytes + kCopyStage - 1) /
                                             kCopyStage, hetpu::sm_count());
  cudaError_t err = hetpu::set_smem_once(copy_planes_kernel, kCopyRingSm,
                                         copy_smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_planes_kernel<<<static_cast<unsigned>(blocks), 64,
                       stages * kCopyStage, stream>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), L, plane,
      rb, lb, stages);
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
