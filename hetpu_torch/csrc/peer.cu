// Kernel `peer_permute`: the device exchange between the ranks of a mesh.
//
//   for each segment s:  dst_s[0 : bytes_s) = src_s[0 : bytes_s)
//
// where dst_s is another process's exchange buffer mapped into this one
// through a CUDA IPC handle (or this rank's own buffer).  One launch stores
// every segment of one exchange: one for a permute, n for an all-to-all or
// an all-gather over n ranks.
//
// Replaces the TPU kernel `right_permute_kernel` of SNIPPETS.md:33-43 and
// :98-132 (`right_permute_wrapper` :39, `right_permute` :128): each device
// sends its [8, 128] f32 shard to device (id + 1) mod n with one
// `pltpu.make_async_remote_copy` and waits on a send and a receive DMA
// semaphore.  Here the copy is stores from the sender's SMs straight into
// the receiver's memory (same card: device memory; another card: over
// NVLink); that is the DMA's `start`.
// The semaphores' `wait` is the host's: the wrapper synchronises its stream
// and meets the other ranks at a barrier before the receiver reads, and at
// a second one before the buffer is written again (parallel/peer.py).  The
// kernel's completion, which that stream sync waits for, makes its stores
// visible, so the kernel needs no fence of its own; a wait on the device
// (a flag the receiver polls) would need a system-scope fence before the
// flag's store.
//
// Bound on the card: bytes — each byte is read once and written once,
// 2·bytes over 3.35 TB/s on one card (450 GB/s each way over NVLink between
// two cards).  Design: 16-byte vector loads and stores where a segment's
// addresses and length allow it (4-byte words otherwise), a grid-stride
// loop in x and one grid row per segment in y, so one launch keeps every
// segment's stores in flight.
//
// The buffers are cudaMalloc'ed here (hetpu_peer_alloc), never by PyTorch's
// caching allocator, whose blocks are sub-allocations of larger ones: an IPC
// handle maps a whole allocation.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSegs = 8;

struct Seg {
  const char* src;
  char* dst;
  unsigned long long bytes;
};

struct Segs {
  Seg s[kMaxSegs];
};

__global__ void peer_store(Segs segs) {
  const Seg g = segs.s[blockIdx.y];
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool vec = ((reinterpret_cast<uintptr_t>(g.src) |
                     reinterpret_cast<uintptr_t>(g.dst) | g.bytes) & 15) == 0;
  if (vec) {
    const uint4* src = reinterpret_cast<const uint4*>(g.src);
    uint4* dst = reinterpret_cast<uint4*>(g.dst);
    for (const size_t n = g.bytes / 16; i < n; i += stride) dst[i] = src[i];
  } else {
    const uint32_t* src = reinterpret_cast<const uint32_t*>(g.src);
    uint32_t* dst = reinterpret_cast<uint32_t*>(g.dst);
    for (const size_t n = g.bytes / 4; i < n; i += stride) dst[i] = src[i];
  }
}

}  // namespace

// srcs, dsts, bytes: host arrays of nseg (<= 8) entries; every pointer and
// length a multiple of 4 bytes (the wrapper checks).
extern "C" int hetpu_peer_permute(const void* const* srcs,
                                  void* const* dsts,
                                  const unsigned long long* bytes, int nseg,
                                  cudaStream_t stream) {
  if (nseg < 1 || nseg > kMaxSegs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Segs segs;
  std::memset(&segs, 0, sizeof(segs));
  unsigned long long most = 0;
  for (int s = 0; s < nseg; ++s) {
    segs.s[s] = Seg{static_cast<const char*>(srcs[s]),
                    static_cast<char*>(dsts[s]), bytes[s]};
    if (bytes[s] > most) most = bytes[s];
  }
  const int threads = 256;
  const unsigned long long per_block = 16ull * threads;
  unsigned long long blocks = (most + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;
  if (blocks > 1056) blocks = 1056;  // 8 blocks an SM, grid-stride beyond
  peer_store<<<dim3(static_cast<unsigned>(blocks), nseg), threads, 0,
               stream>>>(segs);
  return static_cast<int>(cudaGetLastError());
}

// The exchange buffer: cudaMalloc'ed, so its IPC handle maps all of it.
extern "C" int hetpu_peer_alloc(unsigned long long bytes, void** out) {
  return static_cast<int>(cudaMalloc(out, bytes));
}

extern "C" int hetpu_peer_free(void* p) {
  return static_cast<int>(cudaFree(p));
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

// cudaMemcpyAsync device to device: the receiver's read of its own buffer
// into a fresh tensor, and the library yardstick of the kernel.
extern "C" int hetpu_peer_copy(void* dst, const void* src,
                               unsigned long long bytes,
                               cudaStream_t stream) {
  return static_cast<int>(
      cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDeviceToDevice, stream));
}

