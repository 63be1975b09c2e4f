// The register-radix NTT core of the `ntt` kernel (ntt.cu) and of the
// fused kernels `ntt_fwd_lifted`, `ntt_fwd_fbc` and `ntt_fwd_centered`
// (fused_ntt.cu).  hetpu_torch/core/ntt_passes.py holds the same
// schedule in Python: the twiddle table layout and a plain twin that
// indexes exactly as this file does.
//
// One N = 2^logn plane is split over a cluster of C CTAs (cluster_ctas:
// C = 2, 4, 8 at logn 10, 11, >= 12; launched with a cluster dimension),
// each holding M = N/C residues in shared memory, one thread per 8 of
// them.  Every thread holds its E = 8 residues in registers and runs
// three butterfly stages on them per pass, so the transform is
// ceil(logn / 3) passes with a barrier between passes (not 14 barriers and
// 14 shared-memory round trips).  The passes of stride >= N/8 (the first of the forward
// transform, the last of the inverse) are the only ones that cross CTAs:
// they go through distributed shared memory (cluster.map_shared_rank) and
// end or start with cluster.sync().  The forward's first pass reads device
// memory directly (a column loader: the plane, or fused_ntt.cu's digit
// lift or base conversion),
// its last pass writes 8 contiguous residues a thread with 16-byte stores;
// the inverse mirrors this.
//
// A launch of P planes runs P * N/8 threads, so the number of threads an
// SM holds decides how many waves it takes: the kernels keep to 40
// registers a thread (launch bounds 512 x 3), which lets an SM hold 1536.
// Twiddles: each pass reads one record of 8 twiddles and their Shoup
// companions a thread (the table is the flat fwd_w / inv_w reordered, see
// ntt_passes.py), one sub-stage's worth at a time.  Device-memory latency
// is paid once: at the start a thread issues its plane loads and cp.async
// copies of the CTA's records of the later passes into shared memory (the
// forward's last pass: each thread its own record), before waiting on any
// of them.  Shared memory holds local residue i at swz(i), which keeps
// every pass's accesses free of bank conflicts.
//
// Arithmetic as before: canonical residues in [0, q) after every
// butterfly, Shoup multiply with __umulhi (q < 2^31).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>
#include <utility>

#include "ntt_common.cuh"

namespace hetpu {
namespace passes {

namespace cg = cooperative_groups;

constexpr int kLogE = 3;
constexpr int kE = 1 << kLogE;
constexpr int kThreads = 512;  // threads a CTA at most: N/C <= 4096
constexpr int kMinCtas = 3;    // CTAs of kThreads an SM holds: 40 registers

__host__ __device__ inline int num_passes(int logn) {
  return (logn + kLogE - 1) / kLogE;
}

// stages of the forward's last pass (the inverse's first): 1..3
__host__ __device__ inline int odd_stages(int logn) {
  return logn - kLogE * (num_passes(logn) - 1);
}

// first slot of table block b: blocks of 8^b' records of kE slots before it
__host__ __device__ inline size_t block_offset(int b) {
  return kE * ((size_t{1} << (3 * b)) - 1) / 7;
}

__host__ __device__ inline size_t table_size(int logn) {
  return block_offset(num_passes(logn) - 1) + (size_t{1} << logn);
}

// CTAs a plane: the most that keep 64 threads a CTA, at most 8.  This
// was the fastest C at every plane count of the bench_n14 path, 16 to 288
// (PERF.md); core/ntt_passes.py cluster_size is the same rule.
inline int cluster_ctas(int logn) {
  return logn >= 12 ? 8 : logn == 11 ? 4 : 2;
}

// Call f(std::integral_constant<int, C>) with C = cluster_ctas(logn).
template <class F>
inline cudaError_t with_cluster(int logn, F&& f) {
  switch (cluster_ctas(logn)) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default: return f(std::integral_constant<int, 8>{});
  }
}

__device__ __forceinline__ int swz(int i) { return i ^ ((i >> kLogE) & 31); }

// One record: twiddle `slot` and its Shoup companion.
struct Tw {
  const uint32_t* w;
  const uint32_t* s;
};

// RP Cooley-Tukey stages on a thread's residues: sub-stage u pairs j with
// j + 2^(RP-1-u) and reads slot 2^(3-RP+u) + (j >> (RP-u)).
template <int RP>
__device__ __forceinline__ void fwd_regs(uint32_t (&x)[kE], Tw t, uint32_t q) {
#pragma unroll
  for (int u = 0; u < RP; ++u) {
    const int hb = RP - 1 - u;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if ((j >> hb) & 1) continue;
      const int slot = (1 << (kLogE - RP + u)) + (j >> (hb + 1));
      const uint32_t a = x[j];
      const uint32_t b = shoup_mul(x[j + (1 << hb)], t.w[slot], t.s[slot], q);
      x[j] = mod_add(a, b, q);
      x[j + (1 << hb)] = mod_sub(a, b, q);
    }
  }
}

// RP Gentleman-Sande stages of half 1, 2, .. : sub-stage u pairs j with
// j + 2^u and reads slot 2^(2-u) + (j >> (u+1)).
template <int RP>
__device__ __forceinline__ void inv_regs(uint32_t (&x)[kE], Tw t, uint32_t q) {
#pragma unroll
  for (int u = 0; u < RP; ++u) {
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      if ((j >> u) & 1) continue;
      const int slot = (1 << (kLogE - 1 - u)) + (j >> (u + 1));
      const uint32_t a = x[j], b = x[j + (1 << u)];
      x[j] = mod_add(a, b, q);
      x[j + (1 << u)] = shoup_mul(mod_sub(a, b, q), t.w[slot], t.s[slot], q);
    }
  }
}

__device__ __forceinline__ void fwd_regs_n(int rp, uint32_t (&x)[kE], Tw t,
                                           uint32_t q) {
  if (rp == 1)
    fwd_regs<1>(x, t, q);
  else if (rp == 2)
    fwd_regs<2>(x, t, q);
  else
    fwd_regs<3>(x, t, q);
}

__device__ __forceinline__ void inv_regs_n(int rp, uint32_t (&x)[kE], Tw t,
                                           uint32_t q) {
  if (rp == 1)
    inv_regs<1>(x, t, q);
  else if (rp == 2)
    inv_regs<2>(x, t, q);
  else
    inv_regs<3>(x, t, q);
}

__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Table blocks 0 .. P-2 serve the passes between the device-memory ones:
// a CTA of cluster rank `rank` reads records [rank*8^b/C, (rank+1)*8^b/C)
// of block b >= 1 and record 0 of block 0.  They are staged in that order;
// staged_base(b) is the staged index of block b's first one.
template <int C>
__host__ __device__ inline int staged_base(int b) {
  return b == 0 ? 0 : 1 + ((1 << (3 * b)) - 8) / (7 * C);
}

__device__ __forceinline__ void epilogue(uint32_t (&x)[kE], bool scale,
                                         uint32_t c, uint32_t cs, uint32_t q) {
  if (!scale) return;
#pragma unroll
  for (int j = 0; j < kE; ++j) x[j] = shoup_mul(x[j], c, cs, q);
}

// Pass-0 loader of a plane in device memory: x[j] = p[v + j*cols].
struct PlaneLoad {
  const uint32_t* __restrict__ p;
  __device__ __forceinline__ void operator()(uint32_t (&x)[kE], int v,
                                             int cols) const {
#pragma unroll
    for (int j = 0; j < kE; ++j) x[j] = __ldg(p + v + j * cols);
  }
};

// Where a thread stands: thread vt of cluster rank `rank` is thread
// v = rank * M/8 + vt of the plane.  Shared memory: the CTA's M residues,
// the staged records of blocks 0 .. P-2 (twiddles, then companions), and
// for the forward transform each thread's record of its last pass (M
// twiddles, then M companions).
template <int C>
struct Cta {
  int logn, logm, P, cols, rank, vt, v;
  uint32_t *s, *sw, *ss, *lw, *ls;
  __device__ __forceinline__ Cta(uint32_t* smem, int logn_)
      : logn(logn_),
        logm(logn_ - (C == 2 ? 1 : C == 4 ? 2 : 3)),
        P(num_passes(logn_)),
        cols(1 << (logn_ - kLogE)),
        rank(static_cast<int>(blockIdx.x % C)),
        vt(static_cast<int>(threadIdx.x)),
        v(rank * (1 << (logm - kLogE)) + vt),
        s(smem),
        sw(smem + (1 << logm)),
        ss(sw + kE * staged_base<C>(P - 1)),
        lw(ss + kE * staged_base<C>(P - 1)),
        ls(lw + (1 << logm)) {}

  // residue idx of the plane, in the shared memory of the CTA that owns it
  __device__ __forceinline__ uint32_t* at(int idx) const {
    return cg::this_cluster().map_shared_rank(s, idx >> logm) +
           swz(idx & ((1 << logm) - 1));
  }

  // cp.async the CTA's records of blocks 0 .. P-2 into shared memory
  __device__ __forceinline__ void stage(const uint32_t* tw,
                                        const uint32_t* tws) const {
    for (int b = 0; b < P - 1; ++b) {
      const int cnt = b == 0 ? 1 : (1 << (3 * b)) / C;
      const size_t src = block_offset(b) + static_cast<size_t>(
          b == 0 ? 0 : rank * cnt) * kE;
      const int dst = staged_base<C>(b) * kE;
      for (int k = vt; k < 2 * cnt; k += blockDim.x) {
        copy16(sw + dst + 4 * k, tw + src + 4 * k);
        copy16(ss + dst + 4 * k, tws + src + 4 * k);
      }
    }
  }

  // staged record of block b for group (or superblock) g of the plane
  __device__ __forceinline__ Tw staged(int b, int g) const {
    const int first = b == 0 ? 0 : rank * ((1 << (3 * b)) / C);
    const int i = staged_base<C>(b) + g - first;
    return Tw{sw + i * kE, ss + i * kE};
  }
};

template <int C>
inline size_t cta_smem(int logn, bool inverse) {
  const size_t m = (size_t{1} << logn) / C;
  const size_t staged = 2 * kE * staged_base<C>(num_passes(logn) - 1);
  return sizeof(uint32_t) * (m + staged + (inverse ? 0 : 2 * m));
}

// Forward negacyclic NTT of the plane this CTA's cluster holds, natural
// order in (from `load`) to bit-reversed order out, times c (Shoup cs)
// when `scale`.
template <int C, class Load>
__device__ __forceinline__ void fwd_plane(uint32_t* smem, int logn,
                                          const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ tws,
                                          uint32_t q, const Load& load,
                                          uint32_t* __restrict__ out,
                                          bool scale, uint32_t c,
                                          uint32_t cs) {
  const Cta<C> k(smem, logn);
  k.stage(tw, tws);
  const size_t last = block_offset(k.P - 1) + static_cast<size_t>(k.v) * kE;
  copy16(k.lw + k.vt * kE, tw + last);
  copy16(k.lw + k.vt * kE + 4, tw + last + 4);
  copy16(k.ls + k.vt * kE, tws + last);
  copy16(k.ls + k.vt * kE + 4, tws + last + 4);
  // every CTA of the cluster must have started before a remote store:
  // arrive now, wait just before the first
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // pass 0, stages 0..2 (all cross-CTA stages): device memory → registers
  // → the owners' shared memory; record 0 of block 0 is every thread's
  uint32_t x[kE];
  load(x, k.v, k.cols);
  fwd_regs<kLogE>(x, Tw{tw, tws}, q);
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
#pragma unroll
  for (int j = 0; j < kE; ++j) *k.at(k.v + j * k.cols) = x[j];
  wait_copies();
  cg::this_cluster().sync();

  // passes 1 .. P-2: groups of 2^lb residues, all within this CTA
  for (int p = 1; p < k.P - 1; ++p) {
    const int lb = logn - kLogE * p;
    const int lt = lb - kLogE;
    const int g = k.v >> lt;
    const int li = (g << lb) + (k.v & ((1 << lt) - 1)) - (k.rank << k.logm);
#pragma unroll
    for (int j = 0; j < kE; ++j) x[j] = k.s[swz(li + (j << lt))];
    fwd_regs<kLogE>(x, k.staged(p, g), q);
#pragma unroll
    for (int j = 0; j < kE; ++j) k.s[swz(li + (j << lt))] = x[j];
    __syncthreads();
  }

  // last pass: the odd stages on 8 contiguous residues → device memory
#pragma unroll
  for (int j = 0; j < kE; ++j) x[j] = k.s[swz(k.vt * kE + j)];
  fwd_regs_n(odd_stages(logn), x, Tw{k.lw + k.vt * kE, k.ls + k.vt * kE}, q);
  epilogue(x, scale, c, cs, q);
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(k.v) * kE);
  o[0] = make_uint4(x[0], x[1], x[2], x[3]);
  o[1] = make_uint4(x[4], x[5], x[6], x[7]);
}

// Inverse negacyclic NTT (bit-reversed in, natural out) of the plane at
// `in`, times c (Shoup cs) when `scale`.
template <int C>
__device__ __forceinline__ void inv_plane(uint32_t* smem, int logn,
                                          const uint32_t* __restrict__ tw,
                                          const uint32_t* __restrict__ tws,
                                          uint32_t q,
                                          const uint32_t* __restrict__ in,
                                          uint32_t* __restrict__ out,
                                          bool scale, uint32_t c,
                                          uint32_t cs) {
  const Cta<C> k(smem, logn);
  k.stage(tw, tws);

  // pass 0: the odd stages on 8 contiguous residues from device memory,
  // with this thread's record of block P-1
  const uint4* ip =
      reinterpret_cast<const uint4*>(in + static_cast<size_t>(k.v) * kE);
  const uint4 a = __ldg(ip), b = __ldg(ip + 1);
  uint32_t x[kE] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const size_t first = block_offset(k.P - 1) + static_cast<size_t>(k.v) * kE;
  inv_regs_n(odd_stages(logn), x, Tw{tw + first, tws + first}, q);
#pragma unroll
  for (int j = 0; j < kE; ++j) k.s[swz(k.vt * kE + j)] = x[j];
  wait_copies();

  // passes 1 .. P-2: superblocks of 8 * 2^lh0 residues within this CTA
  for (int p = 1; p < k.P - 1; ++p) {
    __syncthreads();
    const int lh0 = odd_stages(logn) + kLogE * (p - 1);
    const int G = k.v >> lh0;
    const int li =
        (G << (lh0 + kLogE)) + (k.v & ((1 << lh0) - 1)) - (k.rank << k.logm);
#pragma unroll
    for (int j = 0; j < kE; ++j) x[j] = k.s[swz(li + (j << lh0))];
    inv_regs<kLogE>(x, k.staged(k.P - 1 - p, G), q);
#pragma unroll
    for (int j = 0; j < kE; ++j) k.s[swz(li + (j << lh0))] = x[j];
  }
  cg::this_cluster().sync();

  // last pass, half N/16 .. N/2 (all cross-CTA stages): the owners' shared
  // memory → registers → device memory
#pragma unroll
  for (int j = 0; j < kE; ++j) x[j] = *k.at(k.v + j * k.cols);
  inv_regs<kLogE>(x, k.staged(0, 0), q);
  epilogue(x, scale, c, cs, q);
#pragma unroll
  for (int j = 0; j < kE; ++j) out[k.v + j * k.cols] = x[j];
  // no CTA leaves while another may still read its shared memory
  cg::this_cluster().sync();
}

// Launch `kernel` over `planes` planes, C CTAs a plane in clusters of C,
// N/C/8 threads a CTA.
template <int C, typename... Exp, typename... Act>
inline cudaError_t launch_planes(void (*kernel)(Exp...), bool inverse,
                                 unsigned planes, int logn,
                                 cudaStream_t stream, Act&&... args) {
  const int threads = (1 << logn) / C / kE;
  if (threads < 32 || threads > kThreads) return cudaErrorInvalidValue;
  const size_t smem = cta_smem<C>(logn, inverse);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(planes * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Act>(args)...);
}

}  // namespace passes
}  // namespace hetpu
