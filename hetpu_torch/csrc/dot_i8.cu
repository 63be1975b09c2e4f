// P3 `dot_i8` (probe_u8_dot.py `try_pair` :20, probe_pallas_s8.py :14,
// probe_int8_mxu.py `pl_dot` :59 and `pl_dot8` :93): out[p] = A @ B[p] with
// exact int32 sums for u8/s8 A [M, K] and B [batch, K, 128], on Hopper's
// warpgroup product (wgmma m64n128k32 .s32 with .s8/.u8 operands).
//
// Bound: bytes at the probes' shapes (the int32 output is 4x the int8
// input; 9.66 G multiply-adds at the int8_mxu shape take 9.8 µs at the
// int8 dense peak, its 94 MB 28 µs at 3.35 TB/s).  The design:
//
// * A persistent grid, one block an SM, walks contiguous ranges of tiles
//   (slab, plane group), slab-major: a slab is Mt = 128 * MW rows of A
//   (MW = 2 when K <= 512 and M >= 256, else 1), a plane group
//   ``planes_per_block`` planes of B.  Each B plane is read and transposed
//   ceil(M / Mt) times: twice at the int8_mxu shape.
// * Three warpgroups.  Warpgroups 0 and 1 consume: each holds MW m64 x n128
//   int32 accumulators (64 registers a thread each) for rows (MW * wg +
//   mi) * 64 .. of the slab.  Warpgroup 2 produces.
// * A [M, K] is K-major as it lies: one producer thread brings a slab in by
//   TMA with the 128-byte swizzle (boxes [64 rows][128 k], zero fill past M
//   and K) and it stays for all the block's tiles of that slab.
// * wgmma reads 8-bit operands from shared memory only K-major, and B[p]
//   [K, 128] is N-contiguous, so it is transposed once a block: the
//   producer warpgroup loads each 128-row chunk of a plane (uint2 loads,
//   each warp 8 rows x 32 contiguous bytes a load, issued two chunks ahead
//   in registers), writes it as Bᵀ [128 n][128 k] in the layout a TMA load
//   with the 128-byte swizzle would give (16-byte unit u of row n at
//   u ^ (n & 7); 4x4 byte transposes, 16-byte stores, 8 distinct units a
//   quarter-warp), fences the async proxy and arrives on the stage's full
//   barrier; consumers release stages on the empty barriers.  Transposing
//   in shared memory (and not B[p]ᵀ as the register operand of Bᵀ·Aᵀ) keeps
//   both operands on one path, A in its own layout and the accumulator in
//   out's orientation, so the epilogue needs no transpose.
// * Every chunk issues all four k32 steps, also past K (A is zero there),
//   so no branch surrounds a wgmma: ptxas serialises wgmma behind a
//   divergent path (C7520), which cost half the product's rate.
// * The epilogue stages each m64 x n128 int32 tile in shared memory (four
//   [64][32] boxes, 128-byte swizzle, int2 stores from the accumulator
//   fragment) and one thread writes it with four TMA stores on a 3-D map
//   of out [batch, M, 128] (rows past M are clipped).  The stores drain
//   while the next tile is computed; a consumer waits for its staging tile
//   to be read out only before it fills it again.
//
// Shared memory at K = 512: the slab of A 128 KB, two ring stages 32 KB,
// two staging tiles 64 KB.  Tensor maps come from cuTensorMapEncodeTiled
// through the runtime's entry-point query (hopper.cuh), encoded on every
// call (host µs in chip_smoke.py's host_cost line) and passed as
// __grid_constant__.
#include "hopper.cuh"

namespace {

constexpr int kN = 128;                 // columns of a B plane
constexpr int kKc = 128;                // k bytes of a chunk: a swizzle row
constexpr int kChunk = kN * kKc;        // a ring stage: Bᵀ [128 n][128 k]
constexpr int kABox = 64 * kKc;         // an A box [64 m][128 k]
constexpr int kOBox = 64 * 32 * 4;      // an output box [64 m][32 n] int32
constexpr int kStaging = 4 * kOBox;     // a consumer's m64 x n128 tile
constexpr int kMaxStages = 8;
constexpr int kDynSmem = 232448 - 1024;  // the limit less the static part
constexpr int kConsumers = 256;         // warpgroups 0 and 1
constexpr int kDotThreads = 384;        // and the producer, warpgroup 2

using hetpu::keep;
using hetpu::stage_box;
using hetpu::sw128_desc;
using hetpu::transpose4x4;
using hetpu::wgmma_commit;
using hetpu::wgmma_fence;
using hetpu::wgmma_k32;
using hetpu::wgmma_wait;

// The producer's share of a chunk, rows k0..k0+kv-1 of a plane [K][128]
// (src at row k0): thread pt takes k rows 16 * (pt % 8) .. +15 and columns
// 8 * (pt / 8) .. +7 as uint2 words (each warp 8 rows x 32 contiguous bytes
// a load); rows at and past kv (a multiple of 32) are not read.
__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ src,
                                           int kv, int pt, uint2 (&v)[16]) {
  const int kb = pt & 7, nb = pt >> 3;
  if (16 * kb >= kv) return;
  const uint8_t* s = src + 16 * kb * kN + 8 * nb;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    v[r] = __ldg(reinterpret_cast<const uint2*>(s + r * kN));
}

// ... written to the stage as Bᵀ [128 n][128 k], 16-byte unit u of row n
// at unit u ^ (n & 7): four 4x4 byte transposes a half, one 16-byte unit a
// column (8 distinct units a quarter-warp: no bank conflicts).
__device__ __forceinline__ void store_chunk(const uint2 (&v)[16], int kv,
                                            uint8_t* stage, int pt) {
  const int kb = pt & 7, nb = pt >> 3;
  if (16 * kb >= kv) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t c[4][4];  // c[q][j]: column 8 nb + 4 h + j, rows 4 q .. 4 q + 3
#pragma unroll
    for (int q = 0; q < 4; ++q)
      transpose4x4(h ? v[4 * q].y : v[4 * q].x,
                   h ? v[4 * q + 1].y : v[4 * q + 1].x,
                   h ? v[4 * q + 2].y : v[4 * q + 2].x,
                   h ? v[4 * q + 3].y : v[4 * q + 3].x, c[q]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 8 * nb + 4 * h + j;
      *reinterpret_cast<uint4*>(stage + n * kKc + ((kb ^ (n & 7)) << 4)) =
          make_uint4(c[0][j], c[1][j], c[2][j], c[3][j]);
    }
  }
}

struct Tile {
  int slab, p0, p1;
};

// Tile t of the walk: slab-major, so a block's contiguous range keeps its
// slab of A for all but at most one change.
__device__ __forceinline__ Tile tile_at(int t, int groups, int ppb,
                                        int batch) {
  Tile r;
  r.slab = t / groups;
  r.p0 = (t % groups) * ppb;
  r.p1 = min(batch, r.p0 + ppb);
  return r;
}

// The producer's place in the block's walk: tile t, plane p, chunk c.
struct Cursor {
  int t, p, c, groups, ppb, batch, nkc;
  Tile tile;
  __device__ Cursor(int t0, int groups_, int ppb_, int batch_, int nkc_)
      : t(t0), c(0), groups(groups_), ppb(ppb_), batch(batch_), nkc(nkc_) {
    tile = tile_at(t, groups, ppb, batch);
    p = tile.p0;
  }
  __device__ void next(int t1) {
    if (++c < nkc) return;
    c = 0;
    if (++p < tile.p1) return;
    if (++t < t1) tile = tile_at(t, groups, ppb, batch);
    p = tile.p0;
  }
};

__device__ __forceinline__ void load_chunk(const uint8_t* __restrict__ b,
                                           int K, const Cursor& at, int pt,
                                           uint2 (&v)[16]) {
  load_chunk(b + (static_cast<size_t>(at.p) * K + at.c * kKc) * kN,
             min(kKc, K - at.c * kKc), pt, v);
}

template <bool AU, bool BU, int MW>
__global__ void __launch_bounds__(kDotThreads, 1)
    dot_i8_kernel(const __grid_constant__ CUtensorMap amap,
                  const __grid_constant__ CUtensorMap omap,
                  const uint8_t* __restrict__ b, int M, int K, int batch,
                  int ppb, int stages) {
  constexpr int kMt = 128 * MW;  // rows of A a slab
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kMaxStages], empty[kMaxStages], a_full, a_empty;
  uint8_t* as = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int nkc = (K + kKc - 1) / kKc;
  uint8_t* ring = as + (kMt / 64) * nkc * kABox;  // [stages][128][128]
  uint8_t* staging = ring + stages * kChunk;      // [2][4][64][128]
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hetpu::mbar_init(&full[s], kDotThreads - kConsumers);
      hetpu::mbar_init(&empty[s], kConsumers);
    }
    hetpu::mbar_init(&a_full, 1);
    hetpu::mbar_init(&a_empty, kConsumers);
    hetpu::mbar_init_fence();
  }
  __syncthreads();
  const int groups = (batch + ppb - 1) / ppb;
  const long long tiles = static_cast<long long>((M + kMt - 1) / kMt) *
                          groups;
  const int t0 = static_cast<int>(tiles * blockIdx.x / gridDim.x);
  const int t1 = static_cast<int>(tiles * (blockIdx.x + 1) / gridDim.x);
  int it = 0, loads = 0, slab = -1;
  if (threadIdx.x >= kConsumers) {
    // ------------------------------------------------ producer
    // The chunks of the block's tiles in order; each chunk's loads are
    // issued two chunks ahead (three register sets), so two chunks' loads
    // fly while a stage waits to be free and a chunk is transposed.
    const int pt = threadIdx.x - kConsumers;
    Cursor cur(t0, groups, ppb, batch, nkc), ahead = cur;
    uint2 v0[16], v1[16], v2[16];
    load_chunk(b, K, ahead, pt, v0);
    ahead.next(t1);
    if (ahead.t < t1) load_chunk(b, K, ahead, pt, v1);
    ahead.next(t1);
    for (; cur.t < t1; cur.next(t1)) {
      if (ahead.t < t1) load_chunk(b, K, ahead, pt, v2);
      ahead.next(t1);
      if (cur.c == 0 && cur.p == cur.tile.p0 && cur.tile.slab != slab) {
        slab = cur.tile.slab;
        if (pt == 0) {
          if (loads > 0) hetpu::mbar_wait(&a_empty, (loads - 1) & 1);
          hetpu::mbar_expect_tx(&a_full, (kMt / 64) * nkc * kABox);
          for (int si = 0; si < kMt / 64; ++si)
            for (int c = 0; c < nkc; ++c)
              hetpu::tma_load_2d(as + (si * nkc + c) * kABox, &amap,
                                 c * kKc, slab * kMt + si * 64, &a_full);
        }
        ++loads;
      }
      const int s = it % stages;
      hetpu::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
      store_chunk(v0, min(kKc, K - cur.c * kKc), ring + s * kChunk, pt);
      hetpu::fence_proxy_async();
      hetpu::mbar_arrive(&full[s]);
      ++it;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        v0[r] = v1[r];
        v1[r] = v2[r];
      }
    }
  } else {
    // ------------------------------------------------ consumers
    const int wg = threadIdx.x >> 7, lt = threadIdx.x & 127;
    uint8_t* stg = staging + wg * kStaging;
    bool staged = false;  // a store of this warpgroup's tile is out
    int acc[MW][64];
#pragma unroll
    for (int mi = 0; mi < MW; ++mi)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[mi][i] = 0;
    for (int t = t0; t < t1; ++t) {
      const Tile tl = tile_at(t, groups, ppb, batch);
      if (tl.slab != slab) {
        if (slab >= 0) hetpu::mbar_arrive(&a_empty);
        slab = tl.slab;
        hetpu::mbar_wait(&a_full, loads & 1);
        ++loads;
      }
      for (int p = tl.p0; p < tl.p1; ++p) {
        for (int c = 0; c < nkc; ++c, ++it) {
          const int s = it % stages;
          hetpu::mbar_wait(&full[s], (it / stages) & 1);
          // All four k32 steps, also in a last chunk past K: A is zero
          // there (the TMA's fill), so those steps add exactly 0 whatever
          // the stage holds, and no branch around a wgmma serialises them.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kKc / 32; ++kk) {
            const uint64_t db = sw128_desc(ring + s * kChunk + 32 * kk);
#pragma unroll
            for (int mi = 0; mi < MW; ++mi)
              wgmma_k32<AU, BU>(
                  acc[mi],
                  sw128_desc(as + ((wg * MW + mi) * nkc + c) * kABox +
                             32 * kk),
                  db, c | kk);
          }
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) keep(acc[mi]);
          hetpu::mbar_arrive(&empty[s]);
        }
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          const int row = slab * kMt + (wg * MW + mi) * 64;
          if (row >= M) continue;  // the same for the whole warpgroup
          // the staging tile free: its last stores read out
          if (lt == 0 && staged) hetpu::bulk_wait_read<0>();
          hetpu::named_bar_sync(1 + wg, 128);
          stage_box<0>(acc[mi], stg, lt);
          stage_box<1>(acc[mi], stg + kOBox, lt);
          stage_box<2>(acc[mi], stg + 2 * kOBox, lt);
          stage_box<3>(acc[mi], stg + 3 * kOBox, lt);
          hetpu::fence_proxy_async();
          hetpu::named_bar_sync(1 + wg, 128);
          if (lt == 0) {
            for (int bx = 0; bx < 4; ++bx)
              hetpu::tma_store_3d(&omap, stg + bx * kOBox, 32 * bx, row, p);
            hetpu::bulk_commit();
          }
          staged = true;
        }
      }
    }
    if (lt == 0) hetpu::bulk_wait<0>();
  }
}

template <bool AU, bool BU, int MW>
int launch_dot(const void* a, const void* b, void* out, int M, int K,
               int batch, int ppb, cudaStream_t stream) {
  static uint64_t smem_set = 0;  // devices whose smem limit is set
  constexpr int kMt = 128 * MW;
  const int nkc = (K + kKc - 1) / kKc;
  const int fixed = 1024 + (kMt / 64) * nkc * kABox + 2 * kStaging;
  int stages = (kDynSmem - fixed) / kChunk;
  if (stages > kMaxStages) stages = kMaxStages;
  if (ppb < 1 || stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = dot_i8_kernel<AU, BU, MW>;
  cudaError_t err = hetpu::set_smem_once(kernel, kDynSmem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const hetpu::EncodeTiled encode = hetpu::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap amap, omap;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t adim[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t astride[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t abox[2] = {kKc, 64};
  const cuuint64_t odim[3] = {kN, static_cast<cuuint64_t>(M),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t ostride[2] = {4 * kN, 4ull * kN * M};
  const cuuint32_t obox[3] = {32, 64, 1};
  if (encode(&amap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(a),
             adim, astride, abox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&omap, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, out, odim, ostride,
             obox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((M + kMt - 1) / kMt) *
                          ((batch + ppb - 1) / ppb);
  const int sms = hetpu::sm_count();
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, kDotThreads, fixed + stages * kChunk, stream>>>(
      amap, omap, static_cast<const uint8_t*>(b), M, K, batch, ppb, stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool AU, bool BU>
int launch_dot_rows(const void* a, const void* b, void* out, int M, int K,
                    int batch, int ppb, cudaStream_t stream) {
  return K <= 512 && M >= 256
             ? launch_dot<AU, BU, 2>(a, b, out, M, K, batch, ppb, stream)
             : launch_dot<AU, BU, 1>(a, b, out, M, K, batch, ppb, stream);
}

}  // namespace

extern "C" int hetpu_dot_i8(const void* a, const void* b, void* out, int M,
                            int K, int batch, int ppb, int a_unsigned,
                            int b_unsigned, cudaStream_t stream) {
  if (a_unsigned)
    return b_unsigned
               ? launch_dot_rows<true, true>(a, b, out, M, K, batch, ppb,
                                             stream)
               : launch_dot_rows<true, false>(a, b, out, M, K, batch, ppb,
                                              stream);
  return b_unsigned
             ? launch_dot_rows<false, true>(a, b, out, M, K, batch, ppb,
                                            stream)
             : launch_dot_rows<false, false>(a, b, out, M, K, batch, ppb,
                                             stream);
}
