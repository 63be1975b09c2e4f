// P4 `plane_parts` (scripts/probe_kernel_parts.py `make` :57): the six
// per-plane stages of the TPU's int8-digit NTT kernel, each run alone over
// x [rows, L, 128, 128] u32, one plane (row r, limb l) at a time: copy;
// extract (XOR of the four balanced digits of _extract_digit_list); twiddle
// (one Shoup multiply by the limb's table tw/tws [L, 128, 128]); recomb
// (four Shoup multiplies of x + j by the scalars tw[l, 0, j] with modular
// adds); dot (w[l] [512, 512] s8 @ the int8 plane repeated four times along
// K, rows 0..127 kept); dot2 (that whole product cast to int8, times w[l]
// again, rows 0..127 kept).  As in the probe, dot and dot2 issue the
// products of all 512 rows though only 128 are stored: the probe measures
// the cost of that product.
//
// The elementwise parts are bound by device-memory bytes (a plane in and
// out, and the twiddle table).  Four 128-thread blocks a plane (1152 at
// the probe's shape, all resident at once, 8 or 9 an SM); each thread
// issues all 8 of its 16-byte loads (4 at a time for twiddle, with its two
// table reads) before any store, a trip count fixed at compile time.  (One
// or two blocks a plane leave the SMs unevenly loaded: 2 or 3 planes
// each.)
//
// dot and dot2 are bound by bytes (dot: 37.7 MB of x in, 18.9 MB out) and
// by the issued int8 products (9.8 / 19.5 µs at the dense int8 peak for
// all 512 rows).  The design:
//
// * A cluster of 4 CTAs holds w[l]: CTA rank c keeps rows 128b + 32c ..
//   128b + 32c + 31 of each 128-row block b (a 64 KB slab) and computes
//   those rows of every product on wgmma m64n128k32 s8 x s8: warpgroup h
//   takes rows 16h .. 16h + 15 of each of the four blocks' 32 (warp b of
//   the warpgroup holds block b's), 16 k32 steps a product, the sums in
//   64 registers a thread.  So the stored rows 0..127 are spread over all
//   eight warpgroups of the cluster, 16 rows (8 KB) each, in warp 0: one
//   SM's stores (~17 B a cycle) held the whole cluster back when one CTA
//   held all 128, and staging a whole warpgroup's tile held the next
//   plane back.
// * K runs in a permuted order, the same in both products: step (c, kk)
//   (chunk c = 0..3, kk = 0..3) takes the 32 columns 128 kk + 32 c .. of
//   w[l] (one 3-D TMA box a warpgroup: [4 blocks][16 rows][32 k], 32-byte
//   swizzle).  Any order of K gives the same exact sums.  In that order the
//   stored-row interleave costs nothing: chunk c of g, the second
//   product's K, is exactly the rows CTA c computes (row 128 b + 32 c + r
//   at k 32 b + r of chunk c), and the first product's B for step (c, kk)
//   is k32 slice c of x8ᵀ (xs[k] = x8[k mod 128]).
// * A plane's int8 cast transposed, x8ᵀ [128 n][128 k], is wgmma's K-major
//   B operand in the 128-byte swizzle layout (16-byte unit u of row n at
//   u ^ (n & 7)); all four k-chunks of xs = x8 repeated along K point at
//   that one 16 KB tile.  Each CTA reads a quarter of the plane (columns
//   32c .. 32c+31, a plane ahead, 128 contiguous bytes a warp a row),
//   writes its 32 rows of x8ᵀ (one 16-byte unit a thread), and one thread
//   copies those 4 KB to the other three CTAs with bulk copies between
//   shared memories, completing on their mbarriers.  The tile is
//   double-buffered, so the next plane goes out while this one's products
//   run.
// * dot2: each CTA casts its slab's sums to int8 straight from the
//   accumulator fragments (8 lanes of a quad column gather each 4-row word
//   with 4 shuffles) into its chunk of g8ᵀ [128 n][4 x 128 k], and one
//   thread copies the 16 KB chunk to the other three CTAs the same way,
//   each completing on the receiver's barrier for that sender; the second
//   product starts on the CTA's own chunk and takes each other chunk as
//   its barrier completes.
// * Rows 32c + 16h .. +15 leave through P3's epilogue, cut to one warp:
//   warp 0 of warpgroup h stages its sums in four swizzled [16][32] int32
//   boxes and one lane writes them with TMA stores, which drain while the
//   next plane's products run.  (A second set of sums, to stage a plane
//   while the next one's product runs, makes ptxas wait for that product
//   before the staging, C7519.)
// * The cluster runs in step: one cluster barrier a plane (relaxed: it
//   orders reads already done) keeps a CTA from overwriting a tile or g8ᵀ
//   that another still reads; every wgmma issues outside any branch
//   (C7520).
//
// Shared memory: the slab 64 KB, two x8ᵀ tiles 32 KB, g8ᵀ 64 KB (dot2),
// two staging tiles a warpgroup 32 KB.
#include <cooperative_groups.h>

#include "hopper.cuh"
#include "ntt_common.cuh"

namespace cg = cooperative_groups;

namespace {

enum Part { kCopy = 0, kDot = 1, kDot2 = 2, kExtract = 3, kTwiddle = 4,
            kRecomb = 5 };

constexpr int kPn = 128;              // plane side
constexpr int kPlane = kPn * kPn;     // u32 a plane
constexpr int kWk = 4 * kPn;          // 512: w[l] is [kWk, kWk] s8

// ---------------------------------------------------------------- elementwise

constexpr int kEwThreads = 128;
constexpr int kEwVecs = 8;                           // uint4 a thread
constexpr int kEwCtas = kPlane / 4 / (kEwThreads * kEwVecs);  // 4 a plane

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

template <int V>
__global__ void __launch_bounds__(kEwThreads)
    elem_kernel(const uint4* __restrict__ x, const uint4* __restrict__ tw,
                const uint4* __restrict__ tws, uint4* __restrict__ out, int L,
                uint32_t q) {
  // loads in flight a thread: all 8, or 4 with the table's two each
  constexpr int kRun = V == kTwiddle ? 4 : kEwVecs;
  constexpr int kPart = kEwThreads * kEwVecs;       // uint4 a block
  const size_t plane = blockIdx.x / kEwCtas;
  const int part = static_cast<int>(blockIdx.x % kEwCtas) * kPart;
  const int l = static_cast<int>(plane % L);
  const uint4* xp = x + plane * (kPlane / 4) + part;
  uint4* op = out + plane * (kPlane / 4) + part;
  const uint4* twl = tw + static_cast<size_t>(l) * (kPlane / 4);
  const uint4* twsl = tws + static_cast<size_t>(l) * (kPlane / 4);
  uint32_t rc[4] = {0, 0, 0, 0}, rcs[4] = {0, 0, 0, 0};
  if constexpr (V == kRecomb) {
    const uint4 a = __ldg(twl), b = __ldg(twsl);
    rc[0] = a.x; rc[1] = a.y; rc[2] = a.z; rc[3] = a.w;
    rcs[0] = b.x; rcs[1] = b.y; rcs[2] = b.z; rcs[3] = b.w;
  }
  twl += part;
  twsl += part;
#pragma unroll
  for (int r0 = 0; r0 < kEwVecs; r0 += kRun) {
    uint4 v[kRun], w[kRun], s[kRun];
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int idx = (r0 + i) * kEwThreads + threadIdx.x;
      v[i] = __ldcs(xp + idx);
      if constexpr (V == kTwiddle) {
        w[i] = __ldg(twl + idx);
        s[i] = __ldg(twsl + idx);
      } else {
        w[i] = s[i] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      const int idx = (r0 + i) * kEwThreads + threadIdx.x;
      __stcs(op + idx,
             make_uint4(elem_part<V>(v[i].x, w[i].x, s[i].x, q, rc, rcs),
                        elem_part<V>(v[i].y, w[i].y, s[i].y, q, rc, rcs),
                        elem_part<V>(v[i].z, w[i].z, s[i].z, q, rc, rcs),
                        elem_part<V>(v[i].w, w[i].w, s[i].w, q, rc, rcs)));
    }
  }
}

template <int V>
int launch_elem(const void* x, const void* tw, const void* tws, void* out,
                int planes, int L, uint32_t q, cudaStream_t stream) {
  elem_kernel<V><<<planes * kEwCtas, kEwThreads, 0, stream>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(tw),
      static_cast<const uint4*>(tws), static_cast<uint4*>(out), L, q);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- dot, dot2

constexpr int kCluster = 4;                // CTAs a cluster: a slab each
constexpr int kRows = kPn / kCluster;      // 32: a CTA's rows of a block
constexpr int kDotThreads = 256;           // two warpgroups
constexpr int kKc = 128;                   // k bytes a chunk (swizzle row)
constexpr int kPiece = 64 * 32;            // a warpgroup's k32 step of w
constexpr int kSlab = 2 * (kWk / 32) * kPiece;  // 64 KB
constexpr int kTile = kPn * kKc;           // an operand tile [128 n][128 k]
constexpr int kStored = kRows / 2;         // 16 stored rows a warpgroup
constexpr int kOBox = kStored * 32 * 4;    // an output box [16 m][32 n] int32
constexpr int kStaging = 4 * kOBox;        // a warpgroup's stored rows

constexpr int dot_smem(int V) {
  return 1024 + kSlab + 2 * kTile + (V == kDot2 ? (kWk / kKc) * kTile : 0) +
         2 * 2 * kStaging;
}

// The low bytes of four u32 values (their int8 casts), first value lowest.
__device__ __forceinline__ uint32_t low_bytes(uint4 v) {
  return __byte_perm(__byte_perm(v.x, v.y, 0x0040),
                     __byte_perm(v.z, v.w, 0x0040), 0x5410);
}

// The (limb, plane) item i of the limb-major walk → plane index r * L + l.
__device__ __forceinline__ size_t item_plane(int i, int rows, int L) {
  return static_cast<size_t>(i % rows) * L + i / rows;
}

// Thread tid's share of a plane: column 32 rank + tid % 32, k rows 16 kb ..
// 16 kb + 15 (kb = tid / 32), one u32 a row (a warp reads 128 contiguous
// bytes of each row).
__device__ __forceinline__ void load_cols(const uint32_t* __restrict__ x,
                                          size_t plane, int rank, int tid,
                                          uint32_t (&v)[16]) {
  const uint32_t* src = x + plane * kPlane + 16 * (tid >> 5) * kPn +
                        32 * rank + (tid & 31);
#pragma unroll
  for (int r = 0; r < 16; ++r) v[r] = __ldcs(src + r * kPn);
}

// ... cast to int8: the 16-byte unit kb of row n = 32 rank + tid % 32 of
// x8ᵀ, at unit kb ^ (n & 7) of the tile (8 lanes a quarter-warp, 8
// distinct units: no bank conflict).
__device__ __forceinline__ void put_cols(const uint32_t (&v)[16],
                                         uint8_t* tile, int rank, int tid) {
  const int n = 32 * rank + (tid & 31), kb = tid >> 5;
  uint32_t wd[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    wd[q] = low_bytes(make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                 v[4 * q + 3]));
  *reinterpret_cast<uint4*>(tile + n * kKc + ((kb ^ (n & 7)) << 4)) =
      make_uint4(wd[0], wd[1], wd[2], wd[3]);
}

// The int8 cast of this CTA's slab of g (fragment of thread lt of
// warpgroup wg: warp w, lane 4 g + t holds rows 16 w + g and + 8 of the
// warpgroup's 64, columns 8 j + 2 t and + 1) → chunk ``rank`` of g8ᵀ
// [128 n][4 x 128 k] here.  Row r of warp w's 16 (g row 128 w + 32 rank +
// 16 wg + r) is k 32 w + 16 wg + r of the chunk, byte r of unit 2 w + wg;
// lane g of a quad column t gathers word g >> 1
// (rows 4 (g >> 1) .. +3, of the lower or upper 8) of column
// 8 j + 2 t + (g & 1) from lanes 4 (g >> 1 & 1) .. +3 of that column, and
// stores it (32 distinct banks a warp).
__device__ __forceinline__ void put_g(const int (&d)[64], uint8_t* chunk,
                                      int wg, int lt) {
  const int w = lt >> 5, g = (lt & 31) >> 2, t = lt & 3;
  const int e = g & 1, wi = g >> 1;
  const int sel = e + 2 * (wi >> 1);
  const int src0 = 4 * (4 * (wi & 1)) + t;     // lane of row 4 (wi & 1)
  const int u = 2 * w + wg;   // k 32 w + 16 wg + r: row r of block w
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t p = __byte_perm(
        __byte_perm(static_cast<uint32_t>(d[4 * j]),
                    static_cast<uint32_t>(d[4 * j + 1]), 0x0040),
        __byte_perm(static_cast<uint32_t>(d[4 * j + 2]),
                    static_cast<uint32_t>(d[4 * j + 3]), 0x0040), 0x5410);
    uint32_t b[4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
      b[s] = __shfl_sync(0xFFFFFFFFu, p, src0 + 4 * s);
    const uint32_t pick = sel | (4 + sel) << 4;
    const int n = 8 * j + 2 * t + e;
    *reinterpret_cast<uint32_t*>(chunk + n * kKc + ((u ^ (n & 7)) << 4) +
                                 4 * wi) =
        __byte_perm(__byte_perm(b[0], b[1], pick),
                    __byte_perm(b[2], b[3], pick), 0x5410);
  }
}

// Thread 0: this CTA's ``bytes`` at ``part`` (written here, made visible
// to the async proxy and waited for by every thread) to the same place in
// the other CTAs of the cluster, each completing on its ``bar[rank]``;
// and this CTA's ``bar[c]`` expects what CTA c sends (``bar``: one barrier
// for all senders where ``per_sender`` is false).
template <bool per_sender>
__device__ __forceinline__ void share(const uint8_t* part, uint32_t bytes,
                                      uint64_t* bar, int rank) {
  if constexpr (per_sender) {
#pragma unroll
    for (int c = 1; c < kCluster; ++c)
      hetpu::mbar_expect_tx(bar + (rank + c) % kCluster, bytes);
  } else {
    hetpu::mbar_expect_tx(bar, (kCluster - 1) * bytes);
  }
  uint64_t* mine = per_sender ? bar + rank : bar;
#pragma unroll
  for (int c = 1; c < kCluster; ++c) {
    const int peer = (rank + c) % kCluster;
    hetpu::bulk_copy_peer(hetpu::peer_addr(part, peer), part, bytes,
                          hetpu::peer_addr(mine, peer));
  }
}

// Warp 0's rows of warpgroup wg (rows 32 rank + 16 wg .. +15 of plane
// p): the fragment into a staging tile (four [16][32] int32 boxes,
// 128-byte swizzle), then four TMA stores that drain while the next
// plane's products run; a tile is refilled only once its stores of two
// planes ago have read it out.
__device__ __forceinline__ void store_rows(const int (&d)[64], uint8_t* stg,
                                           const CUtensorMap* omap,
                                           size_t p, int rank, int wg,
                                           int lane, int& staged) {
  uint8_t* tile = stg + (staged & 1) * kStaging;
  if (lane == 0 && staged > 1) hetpu::bulk_wait_read<1>();
  __syncwarp();
  hetpu::stage_box<0>(d, tile, lane);
  hetpu::stage_box<1>(d, tile + kOBox, lane);
  hetpu::stage_box<2>(d, tile + 2 * kOBox, lane);
  hetpu::stage_box<3>(d, tile + 3 * kOBox, lane);
  hetpu::fence_proxy_async();
  __syncwarp();
  if (lane == 0) {
    for (int bx = 0; bx < 4; ++bx)
      hetpu::tma_store_3d(omap, tile + bx * kOBox, 32 * bx,
                          kRows * rank + kStored * wg, static_cast<int>(p));
    hetpu::bulk_commit();
  }
  ++staged;
}

// d = this warpgroup's 64 rows of the slab @ B over K = 512 in the
// permuted order: step (c, kk) reads the warpgroup's piece (c, kk) of the
// slab and B at b + c * cstep + 32 kk * kstep (a k32 slice of a
// 128-byte-swizzle tile).
__device__ __forceinline__ void slab_product(int (&d)[64], const uint8_t* ws,
                                             int wg, const uint8_t* b,
                                             int cstep, int kstep) {
  hetpu::wgmma_fence();
#pragma unroll
  for (int c = 0; c < kWk / kKc; ++c)
#pragma unroll
    for (int kk = 0; kk < kKc / 32; ++kk)
      hetpu::wgmma_k32<false, false>(
          d, hetpu::sw32_desc(ws + ((wg * 4 + c) * 4 + kk) * kPiece),
          hetpu::sw128_desc(b + c * cstep + 32 * kk * kstep), c | kk);
  hetpu::wgmma_commit();
}

// The four k32 steps of chunk c of the slab's rows @ B (chunk c of B at
// b + c * kTile), adding to d unless ``first``; no fence or commit.
__device__ __forceinline__ void chunk_product(int (&d)[64], const uint8_t* ws,
                                              int wg, const uint8_t* b, int c,
                                              bool first) {
#pragma unroll
  for (int kk = 0; kk < kKc / 32; ++kk)
    hetpu::wgmma_k32<false, false>(
        d, hetpu::sw32_desc(ws + ((wg * 4 + c) * 4 + kk) * kPiece),
        hetpu::sw128_desc(b + c * kTile + 32 * kk), !first || kk > 0);
}

template <int V>
__global__ void __launch_bounds__(kDotThreads, 1)
    plane_dot_kernel(const __grid_constant__ CUtensorMap wmap,
                     const __grid_constant__ CUtensorMap omap,
                     const uint32_t* __restrict__ x, int rows, int L) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t wbar, xbar[2], gbar[kCluster];
  uint8_t* ws = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* xt = ws + kSlab;        // [2][128 n][128 k]
  uint8_t* gt = xt + 2 * kTile;    // [4][128 n][128 k] (dot2)
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;
  // this warpgroup's two staging tiles
  uint8_t* stg = gt + (V == kDot2 ? (kWk / kKc) * kTile : 0) +
                 wg * 2 * kStaging;
  const int clusters = gridDim.x / kCluster;
  const int cid = blockIdx.x / kCluster;
  const long long items = static_cast<long long>(rows) * L;
  const int i0 = static_cast<int>(items * cid / clusters);
  const int i1 = static_cast<int>(items * (cid + 1) / clusters);
  // this CTA's rows of x8ᵀ: 32 of 128 (4 KB of each tile)
  const int xpart = 32 * rank * kKc;
  if (tid == 0) {
    hetpu::mbar_init(&wbar, 1);
    hetpu::mbar_init(&xbar[0], 1);
    hetpu::mbar_init(&xbar[1], 1);
    for (int c = 0; c < kCluster; ++c) hetpu::mbar_init(&gbar[c], 1);
    hetpu::mbar_init_fence();
  }
  __syncthreads();
  // every CTA's barriers are initialised before any copy completes on them
  cluster.sync();

  // x8ᵀ of item i into tile i & 1 of every CTA: this CTA's 32 rows
  // written here, then copied to the others (a plane ahead of its use)
  uint32_t xr[16];
  auto put_x = [&](int i) {
    uint8_t* tile = xt + (i & 1) * kTile;
    put_cols(xr, tile, rank, tid);
    hetpu::fence_proxy_async();
    __syncthreads();
    if (tid == 0) share<false>(tile + xpart, 32 * kKc, &xbar[i & 1], rank);
  };
  // this CTA's slab of w[l] (by TMA; reloaded where the walk changes limb)
  auto load_w = [&](int l) {
    if (tid != 0) return;
    // piece (h, c, kk): rows 128 b + 32 rank + 16 h .. +15 of blocks
    // b = 0..3, columns 128 kk + 32 c .. +31
    hetpu::mbar_expect_tx(&wbar, kSlab);
    for (int h = 0; h < 2; ++h)
      for (int c = 0; c < 4; ++c)
        for (int kk = 0; kk < 4; ++kk)
          hetpu::tma_load_3d(ws + ((h * 4 + c) * 4 + kk) * kPiece, &wmap,
                             128 * kk + 32 * c, kRows * rank + kStored * h,
                             4 * l, &wbar);
  };
  int limb = i0 / rows;
  bool w_pending = true;
  load_w(limb);
  load_cols(x, item_plane(i0, rows, L), rank, tid, xr);
  put_x(i0);
  if (i0 + 1 < i1) load_cols(x, item_plane(i0 + 1, rows, L), rank, tid, xr);

  int staged = 0;  // planes this warpgroup has staged and stored
  uint32_t wphase = 0, xphase = 0, gphase = 0;  // xphase: bit b for tile b
  // w[l] and x8ᵀ of item i in shared memory (w reloaded first where the
  // walk changes limb: the last item's products are done then)
  auto ready = [&](int i) {
    const int l = i / rows;
    if (l != limb) {  // the same in every CTA of the cluster
      limb = l;
      load_w(l);
      w_pending = true;
    }
    if (w_pending) {
      hetpu::mbar_wait(&wbar, wphase);
      wphase ^= 1;
      w_pending = false;
    }
    hetpu::mbar_wait(&xbar[i & 1], (xphase >> (i & 1)) & 1);
    xphase ^= 1u << (i & 1);
  };

  int acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0;
  for (int i = i0; i < i1; ++i) {
    ready(i);
    // first product: w[l] rows of this slab @ xs (every chunk is x8ᵀ)
    slab_product(acc, ws, wg, xt + (i & 1) * kTile, 32, 0);
    // the next plane's x8ᵀ out to the cluster while the product runs
    if (i + 1 < i1) {
      put_x(i + 1);
      if (i + 2 < i1) load_cols(x, item_plane(i + 2, rows, L), rank, tid, xr);
    }
    hetpu::wgmma_wait<0>();
    hetpu::keep(acc);
    if constexpr (V == kDot2) {
      // int8(g) of this slab → chunk ``rank`` of g8ᵀ, then to the others
      uint8_t* chunk = gt + rank * kTile;
      put_g(acc, chunk, wg, lt);
      hetpu::fence_proxy_async();
      __syncthreads();
      if (tid == 0) share<true>(chunk, kTile, gbar, rank);
      // second product: w[l] rows of this slab @ int8(g), K = all 512 rows;
      // this CTA's own chunk first, each other chunk as it arrives
      hetpu::wgmma_fence();
      chunk_product(acc, ws, wg, gt, rank, true);
#pragma unroll
      for (int s = 1; s < kCluster; ++s) {
        const int c = (rank + s) % kCluster;
        hetpu::mbar_wait(&gbar[c], gphase);
        chunk_product(acc, ws, wg, gt, c, false);
      }
      hetpu::wgmma_commit();
      gphase ^= 1;
      hetpu::wgmma_wait<0>();
      hetpu::keep(acc);
    }
    if (lt < 32)
      store_rows(acc, stg, &omap, item_plane(i, rows, L), rank, wg, lt,
                 staged);
    // no CTA writes a tile or g8ᵀ that another still reads (their reads
    // are done: nothing needs to become visible)
    hetpu::cluster_sync_relaxed();
  }
  if (lt == 0) hetpu::bulk_wait<0>();
}

// Clusters resident at once for a variant (queried once per device).
template <int V>
int max_clusters() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kDotThreads);
    cfg.dynamicSmemBytes = dot_smem(V);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(&n, plane_dot_kernel<V>, &cfg) !=
        cudaSuccess)
      return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

template <int V>
int launch_dot(const void* x, const void* w, void* out, int planes, int L,
               cudaStream_t stream) {
  static uint64_t smem_set = 0;  // devices whose smem limit is set
  cudaError_t err = hetpu::set_smem_once(plane_dot_kernel<V>, dot_smem(V),
                                         smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int fit = max_clusters<V>();
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const hetpu::EncodeTiled encode = hetpu::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // w as [L * 4 blocks][128 rows][512 k] s8 in [4][16][32] boxes, 32-byte
  // swizzle; out [planes][128][128] int32 in [16][32] boxes, 128-byte
  // swizzle
  CUtensorMap wmap, omap;
  const cuuint32_t ones[3] = {1, 1, 1};
  const cuuint64_t wdim[3] = {kWk, kPn, 4ull * L};
  const cuuint64_t wstride[2] = {kWk, static_cast<cuuint64_t>(kPn) * kWk};
  const cuuint32_t wbox[3] = {32, kStored, 4};
  const cuuint64_t odim[3] = {kPn, kPn, static_cast<cuuint64_t>(planes)};
  const cuuint64_t ostride[2] = {4 * kPn, 4ull * kPlane};
  const cuuint32_t obox[3] = {32, kStored, 1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(w),
             wdim, wstride, wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&omap, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, out, odim, ostride,
             obox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int clusters = planes < fit ? planes : fit;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kDotThreads);
  cfg.dynamicSmemBytes = dot_smem(V);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, plane_dot_kernel<V>, wmap, omap,
                           static_cast<const uint32_t*>(x), planes / L, L);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int hetpu_plane_parts(const void* x, const void* w, const void* tw,
                                 const void* tws, void* out, int planes,
                                 int L, unsigned q, int variant,
                                 cudaStream_t stream) {
  switch (variant) {
    case kCopy:
      return launch_elem<kCopy>(x, tw, tws, out, planes, L, q, stream);
    case kDot:
      return launch_dot<kDot>(x, w, out, planes, L, stream);
    case kDot2:
      return launch_dot<kDot2>(x, w, out, planes, L, stream);
    case kExtract:
      return launch_elem<kExtract>(x, tw, tws, out, planes, L, q, stream);
    case kTwiddle:
      return launch_elem<kTwiddle>(x, tw, tws, out, planes, L, q, stream);
    case kRecomb:
      return launch_elem<kRecomb>(x, tw, tws, out, planes, L, q, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
