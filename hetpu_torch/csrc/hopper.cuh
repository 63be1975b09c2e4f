// Hopper (sm_90a) building blocks shared by the probes' P1 (probes.cu), P3
// (dot_i8.cu) and P4 (plane_parts.cu): mbarriers, 1-D bulk copies and
// tensor-map (TMA) copies between device and shared memory, the async-proxy
// fence, named barriers, the s8/u8 warpgroup product (wgmma) with its
// 128-byte-swizzle descriptors and a 4x4 byte transpose, and the
// tensor-map encoder looked up through the CUDA runtime (no -lcuda).  PTX
// ISA 8.x names throughout.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hetpu {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// The barriers' initialisation made visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// One arrival that also expects ``bytes`` of async copies on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma operands, TMA store sources).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- bulk

// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ``bytes`` from shared memory to device memory, in the issuing thread's
// current bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
               "%2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups still read shared
// memory (their sources may be overwritten).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are incomplete.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// The shared::cluster address of ``p`` (this CTA's shared memory) in the
// CTA of cluster rank ``rank``: the same offset in that CTA.
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

// A cluster barrier that orders no memory: every thread of every CTA of
// the cluster arrives, then waits for the others (for hazards where the
// reads are done and nothing written needs to be seen).
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// ``bytes`` (a multiple of 16, both ends 16-byte aligned) of this CTA's
// shared memory into another CTA's of the cluster (``dst``, ``bar``:
// peer_addr), completing on that CTA's mbarrier ``bar``.
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, const void* src,
                                               uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "r"(smem_addr(src)), "r"(bytes), "r"(bar) : "memory");
}

// ---------------------------------------------------------------- TMA

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
         "r"(smem_addr(src))
      : "memory");
}

// ---------------------------------------------------------------- wgmma

#define HETPU_WGMMA_I8(TA, TB)                                                \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." TA "." TB " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "          \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "          \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "          \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "          \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "          \
      "%62, %63}, %64, %65, p;\n}\n"                                          \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),           \
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),           \
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),      \
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),      \
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),      \
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),      \
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),      \
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),      \
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),      \
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),      \
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),      \
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),      \
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])                    \
      : "l"(da), "l"(db), "r"(accumulate))

// d (+)= A (64 x 32, descriptor da) x B (32 x 128, descriptor db); the sum
// starts from zero where ``accumulate`` is 0.
template <bool AU, bool BU>
__device__ __forceinline__ void wgmma_k32(int (&d)[64], uint64_t da,
                                          uint64_t db, int accumulate) {
  if constexpr (!AU && !BU) HETPU_WGMMA_I8("s8", "s8");
  else if constexpr (!AU && BU) HETPU_WGMMA_I8("s8", "u8");
  else if constexpr (AU && !BU) HETPU_WGMMA_I8("u8", "s8");
  else HETPU_WGMMA_I8("u8", "u8");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of the warpgroup's wgmma groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads across the wait.
__device__ __forceinline__ void keep(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// Descriptor of a K-major operand in the 128-byte swizzle layout: rows of
// 128 bytes, 8-row groups 1024 bytes apart (stride offset 64 x 16 bytes),
// the k32 step selected by the start address inside the swizzle row.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// Descriptor of a K-major operand in the 32-byte swizzle layout: rows of
// 32 bytes (one k32 step), 8-row groups 256 bytes apart (stride offset 16 x
// 16 bytes), each group's two 16-byte halves swapped on rows 4..7.
__device__ __forceinline__ uint64_t sw32_desc(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (16ull << 32) | (3ull << 62);
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

// Box BX (columns 32 BX .. +31) of the m64 x n128 accumulator fragment of
// thread lt of a warpgroup (warp w, lane 4 g + t: rows 16 w + g and + 8,
// columns 8 j + 2 t and + 1) → a [64][32] int32 box, 16-byte unit u of row
// r at u ^ (r & 7).
template <int BX>
__device__ __forceinline__ void stage_box(const int (&d)[64], uint8_t* box,
                                          int lt) {
  const int w = lt >> 5, g = (lt & 31) >> 2, t = lt & 3;
  const int r0 = 16 * w + g;
#pragma unroll
  for (int j = 4 * BX; j < 4 * BX + 4; ++j) {
    const int u = 2 * (j & 3) + (t >> 1);
    uint8_t* o = box + ((u ^ g) << 4) + ((t & 1) << 3);
    *reinterpret_cast<int2*>(o + r0 * 128) = make_int2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<int2*>(o + (r0 + 8) * 128) =
        make_int2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// ---------------------------------------------------------------- host

// cuTensorMapEncodeTiled, looked up through the CUDA runtime's entry-point
// query, so the library links no -lcuda.  Null where it is missing.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The current device's SM count (queried once per device).
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 1;
  if (counts[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev] = n > 0 ? n : 1;
  }
  return counts[dev];
}

// Sets a kernel's dynamic shared-memory limit once per device (the first
// launch on each device; later launches skip the call).
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int bytes, uint64_t& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t(1) << (dev & 63);
  if (done & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done |= bit;
  return err;
}

}  // namespace hetpu
