// Kernel `peer_permute`: the device exchange between the ranks of a mesh,
// the copy and its semaphores.  Exchange e of a buffer is two launches on
// the rank's stream, each behind a stream-ordered wait on the flag words
// (cuStreamWaitValue32, hetpu_peer_wait_value; parallel/peer.py enqueues
// them and computes e, the slots and the masks in `protocol`):
//
//   send wait (stream):    every receiver has read out what this rank
//                          stored at e - 2
//   peer_store:            for each segment s,
//                          dst_s[slot e mod 2][off_s:] = src_s;
//                          then each receiver's "arrived" word of this
//                          rank := e
//   receive wait (stream): every sender that targets this rank has
//                          signalled e
//   peer_read:             out = this rank's slot e mod 2; then every
//                          rank's "read" word of this rank := e, and the
//                          host's progress word := e
//
// where dst_s is another process's exchange buffer mapped into this one
// through a CUDA IPC handle (or this rank's own buffer).  One segment for a
// permute, n for an all-to-all or an all-gather over n ranks.  The waits
// are the stream's and not spins inside the kernel: a stream blocked on a
// wait holds no SM, where a spinning kernel holds its SMs until its
// context's timeslice ends, and ranks in processes of their own
// time-slice one card (PERF.md §6).
//
// Replaces the TPU kernel `right_permute_kernel` of SNIPPETS.md:33-43 and
// :98-132 (`right_permute_wrapper` :39, `right_permute` :128): each device
// sends its [8, 128] f32 shard to device (id + 1) mod n with one
// `pltpu.make_async_remote_copy`, `start()`, and `wait()` on a send and a
// receive DMA semaphore.  Here the copy is stores from the sender's SMs
// straight into the receiver's memory (same card: device memory; another
// card: over NVLink), and the semaphores are 32-bit words in the exchange
// buffers, written with st.release.sys after fence.acq_rel.sys: system
// scope, because the reader of a flag is the receiver's stream (the card's
// front end, not an SM) and, between cards, another device.
//
// Buffer of one rank (one cudaMalloc, so one IPC handle maps all of it):
//   [slot 0: cap bytes][slot 1: cap bytes][flags: kFlagBytes]
//   flags: arrived[kMaxRanks]  sender s stores e after its stores at e
//          read[kMaxRanks]     rank r stores e once it has read out epoch e
//                              (into every rank's buffer: the send
//                              semaphore of every sender)
//          CTA counter         the grid's arrivals (reset by the last CTA)
//          abort               set by hetpu_peer_abort
// A sender's stream waits only on its own buffer's read words and a
// receiver's on its own arrived words; the signals are the remote stores.
// Two data slots let exchange e + 1 store while a slow receiver still
// reads e.
//
// An exchange that stalls (a peer that stopped, or whose exchanges stopped
// matching) never passes its stream wait.  The host's watchdog
// (parallel/peer.py) sees the progress word stand still and calls
// hetpu_peer_abort: it sets the abort word and then lifts every flag of
// the buffer past any wait, and the launches behind the waits find the
// abort word (or an "arrived" value no sender wrote) and trap, so the next
// synchronise raises instead of hanging.
//
// Bound on the card: bytes — each byte is read once and written once by the
// store: 2·bytes over 3.35 TB/s on one card (450 GB/s each way over NVLink
// between two cards); the read-out moves them once more.  Design: 16-byte
// vector loads and stores where a segment's addresses and length allow it
// (4-byte words otherwise), a grid-stride loop in x and one grid row per
// segment in y, so one launch keeps every segment's stores in flight.
//
// The buffers are cudaMalloc'ed here (hetpu_peer_alloc), never by PyTorch's
// caching allocator, whose blocks are sub-allocations of larger ones: an IPC
// handle maps a whole allocation.
#include <cstdint>
#include <cstring>
#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegs = 8;
constexpr int kMaxRanks = 8;
constexpr int kThreads = 256;
constexpr unsigned kMaxCtas = 1024;
constexpr unsigned long long kFlagBytes = 256;
// flag words
constexpr int kArrived = 0;
constexpr int kRead = kMaxRanks;
constexpr int kCtas = 2 * kMaxRanks;
constexpr int kAbort = kCtas + 1;

struct Seg {
  const char* src;
  unsigned long long off;    // byte offset in the receiver's slot
  unsigned long long bytes;
  int rank;                  // receiver
};

struct StoreArgs {
  char* base[kMaxRanks];     // every rank's buffer, mapped (own for me)
  Seg seg[kMaxSegs];
  unsigned long long cap;    // bytes of one data slot
  int me;
  int n;
  unsigned send_mask;        // receivers of this rank's segments
  uint32_t epoch;
};

struct ReadArgs {
  char* base[kMaxRanks];
  char* out;
  unsigned long long out_bytes;
  unsigned long long cap;
  uint32_t* progress;        // the host's word (mapped pinned memory)
  int me;
  int n;
  unsigned recv_mask;        // senders whose segments this rank receives
  uint32_t epoch;
};

__host__ __device__ __forceinline__ uint32_t* flags(char* base,
                                                    unsigned long long cap) {
  return reinterpret_cast<uint32_t*>(base + 2 * cap);
}

__device__ __forceinline__ uint32_t ld_acquire_sys(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(uint32_t* p, uint32_t v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void fence_acq_rel_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

// dst[0, bytes) = src[0, bytes) over the grid's x; from_l2 reads around L1
// (the receiver's slot, written by other SMs or another process).
__device__ __forceinline__ void copy_bytes(char* dst, const char* src,
                                           unsigned long long bytes,
                                           bool from_l2) {
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  if (((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
        bytes) & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (const size_t n = bytes / 16; i < n; i += stride)
      d[i] = from_l2 ? __ldcg(s + i) : s[i];
  } else {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (const size_t n = bytes / 4; i < n; i += stride)
      d[i] = from_l2 ? __ldcg(s + i) : s[i];
  }
}

// Thread 0 of each CTA, after the CTA's stores and reads: true in the
// last CTA of the grid to arrive (which resets the counter for the next
// launch), once every CTA's are done.
__device__ __forceinline__ bool last_cta(uint32_t* ctr) {
  const unsigned ctas = gridDim.x * gridDim.y;
  fence_acq_rel_sys();
  if (atomicAdd(ctr, 1u) != ctas - 1) return false;
  atomicExch(ctr, 0u);
  fence_acq_rel_sys();
  return true;
}

__device__ __forceinline__ void check_abort(const uint32_t* own) {
  if (threadIdx.x == 0 && *reinterpret_cast<const volatile uint32_t*>(
                              own + kAbort) != 0)
    __trap();
}

__global__ void __launch_bounds__(kThreads) peer_store(const StoreArgs a) {
  uint32_t* own = flags(a.base[a.me], a.cap);
  check_abort(own);
  const unsigned long long slot = (a.epoch & 1) * a.cap;
  const Seg g = a.seg[blockIdx.y];
  if (g.bytes > 0)
    copy_bytes(a.base[g.rank] + slot + g.off, g.src, g.bytes, false);
  __syncthreads();
  if (threadIdx.x == 0 && last_cta(own + kCtas)) {
    for (int r = 0; r < a.n; ++r)
      if (a.send_mask >> r & 1)
        st_release_sys(flags(a.base[r], a.cap) + kArrived + a.me, a.epoch);
  }
}

__global__ void __launch_bounds__(kThreads) peer_read(const ReadArgs a) {
  uint32_t* own = flags(a.base[a.me], a.cap);
  check_abort(own);
  if (threadIdx.x == 0) {
    // a sender may already have signalled e + 1 (into the other slot);
    // any other value is an abort's
    for (int s = 0; s < a.n; ++s)
      if ((a.recv_mask >> s & 1) &&
          ld_acquire_sys(own + kArrived + s) - a.epoch > 1u)
        __trap();
  }
  __syncthreads();
  copy_bytes(a.out, a.base[a.me] + (a.epoch & 1) * a.cap, a.out_bytes, true);
  __syncthreads();
  if (threadIdx.x == 0 && last_cta(own + kCtas)) {
    for (int r = 0; r < a.n; ++r)
      st_release_sys(flags(a.base[r], a.cap) + kRead + a.me, a.epoch);
    st_release_sys(a.progress, a.epoch);
  }
}

unsigned ctas_for(unsigned long long bytes) {
  const unsigned long long per_cta = 16ull * kThreads;
  const unsigned long long c = (bytes + per_cta - 1) / per_cta;
  return c < 1 ? 1u : c > kMaxCtas ? kMaxCtas : static_cast<unsigned>(c);
}

bool bad_mesh(int n, int me) {
  return n < 1 || n > kMaxRanks || me < 0 || me >= n;
}

}  // namespace

// The store and signal of exchange `epoch`: bases are the n ranks' buffers
// (own pointer at index me); srcs, ranks, offs, bytes host arrays of nseg
// (<= 8) segments, every pointer and length a multiple of 4 bytes (the
// wrapper checks); send_mask the receivers to signal.
extern "C" int hetpu_peer_store(void* const* bases, int n, int me,
                                unsigned long long cap,
                                const void* const* srcs, const int* ranks,
                                const unsigned long long* offs,
                                const unsigned long long* bytes, int nseg,
                                unsigned send_mask, unsigned epoch,
                                cudaStream_t stream) {
  if (bad_mesh(n, me) || nseg < 0 || nseg > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  StoreArgs a;
  std::memset(&a, 0, sizeof(a));
  for (int r = 0; r < n; ++r) a.base[r] = static_cast<char*>(bases[r]);
  unsigned long long most = 0;
  for (int s = 0; s < nseg; ++s) {
    a.seg[s] = Seg{static_cast<const char*>(srcs[s]), offs[s], bytes[s],
                   ranks[s]};
    if (bytes[s] > most) most = bytes[s];
  }
  a.cap = cap;
  a.me = me;
  a.n = n;
  a.send_mask = send_mask;
  a.epoch = epoch;
  const dim3 grid(ctas_for(most), nseg > 0 ? nseg : 1);
  peer_store<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The read-out and acknowledgement of exchange `epoch`: out receives
// out_bytes from this rank's slot (null for none); recv_mask the senders
// whose "arrived" words the stream waited on; progress the device pointer
// of the host's word (hetpu_peer_progress).
extern "C" int hetpu_peer_read(void* const* bases, int n, int me,
                               unsigned long long cap, void* out,
                               unsigned long long out_bytes,
                               unsigned recv_mask, void* progress,
                               unsigned epoch, cudaStream_t stream) {
  if (bad_mesh(n, me)) return static_cast<int>(cudaErrorInvalidValue);
  ReadArgs a;
  std::memset(&a, 0, sizeof(a));
  for (int r = 0; r < n; ++r) a.base[r] = static_cast<char*>(bases[r]);
  a.out = static_cast<char*>(out);
  a.out_bytes = out_bytes;
  a.cap = cap;
  a.progress = static_cast<uint32_t*>(progress);
  a.me = me;
  a.n = n;
  a.recv_mask = recv_mask;
  a.epoch = epoch;
  peer_read<<<ctas_for(out_bytes), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Stream-ordered wait until the 32-bit word at p reads >= value (modulo
// 2^32): cuStreamWaitValue32, looked up through the CUDA runtime's
// entry-point query (no -lcuda).  Any failure comes back as
// cudaErrorNotSupported (the wrapper names the call).
extern "C" int hetpu_peer_wait_value(void* p, unsigned value,
                                     cudaStream_t stream) {
  using WaitValue = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t,
                                 unsigned int);
  static WaitValue fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuStreamWaitValue32", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuStreamWaitValue32", &f, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<WaitValue>(f)
               : nullptr;
  }();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const CUresult r = fn(reinterpret_cast<CUstream>(stream),
                        reinterpret_cast<CUdeviceptr>(p), value,
                        CU_STREAM_WAIT_VALUE_GEQ);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorNotSupported);
}

// The exchange buffer: cudaMalloc'ed, so its IPC handle maps all of it;
// its flags zeroed and the zeroes on the card before the call returns (no
// peer can signal into memory that is not yet zeroed: the handles are
// swapped after this).
extern "C" int hetpu_peer_alloc(unsigned long long cap, void** out) {
  cudaError_t err = cudaMalloc(out, 2 * cap + kFlagBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(static_cast<char*>(*out) + 2 * cap, 0, kFlagBytes);
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

extern "C" int hetpu_peer_free(void* p) {
  return static_cast<int>(cudaFree(p));
}

// The progress word of a buffer: one zeroed 32-bit word of pinned host
// memory that peer_read stores each completed epoch into, mapped for the
// card (dev); the host reads it with no CUDA call.
extern "C" int hetpu_peer_progress(void** host, void** dev) {
  cudaError_t err = cudaHostAlloc(host, sizeof(uint32_t), cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  *static_cast<volatile uint32_t*>(*host) = 0;
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

extern "C" int hetpu_peer_free_host(void* p) {
  return static_cast<int>(cudaFreeHost(p));
}

// Aborts the exchanges of this rank's buffer at p: on a stream of its own
// (not blocked behind the stalled one), the abort word := 1 and then every
// arrived and read word := poison, which the wrapper picks past every
// value its stream waits for; returns once both are on the card.
extern "C" int hetpu_peer_abort(void* p, unsigned long long cap,
                                unsigned poison) {
  uint32_t* f = flags(static_cast<char*>(p), cap);
  uint32_t words[2 * kMaxRanks];
  const uint32_t one = 1;
  for (uint32_t& w : words) w = poison;
  cudaStream_t s;
  cudaError_t err = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(f + kAbort, &one, sizeof(one),
                        cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess)
    err = cudaMemcpyAsync(f + kArrived, words, sizeof(words),
                          cudaMemcpyHostToDevice, s);
  const cudaError_t sync = cudaStreamSynchronize(s);
  cudaStreamDestroy(s);
  return static_cast<int>(err != cudaSuccess ? err : sync);
}

// Writes the 64-byte cudaIpcMemHandle_t of p to handle.
extern "C" int hetpu_peer_handle(void* p, void* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, p);
  if (err == cudaSuccess) std::memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// Maps another process's buffer from its 64-byte handle.  CUDA refuses a
// handle exported by the calling process: a rank uses its own pointer.
extern "C" int hetpu_peer_open(const void* handle, void** out) {
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int hetpu_peer_close(void* p) {
  return static_cast<int>(cudaIpcCloseMemHandle(p));
}

// cudaMemcpyAsync device to device: the library yardstick of the store.
extern "C" int hetpu_peer_copy(void* dst, const void* src,
                               unsigned long long bytes,
                               cudaStream_t stream) {
  return static_cast<int>(
      cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, stream));
}
