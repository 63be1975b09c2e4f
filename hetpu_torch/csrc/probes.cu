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
// P4 `plane_parts` lives in plane_parts.cu (wgmma, TMA, clusters).
#include "hopper.cuh"

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
