"""P5 ``peer_permute``: device data exchange between the ranks of a mesh.

Counterpart of the TPU kernel ``right_permute_kernel`` (``SNIPPETS.md:33-43,
98-132``: ``right_permute_wrapper`` :39 and ``right_permute`` :128), in
which each device sends its [8, 128] f32 shard to device (id + 1) mod n
with one ``pltpu.make_async_remote_copy`` and a send and a receive DMA
semaphore.  Here every exchange of the parallel layer — each round of the
``mod_all_reduce`` butterfly, the all-to-all of the coefficient-sharded
NTT, the gathers of the sharded programs — is one launch of the
``peer_permute`` kernel (``csrc/peer.cu``):

  * each rank owns an exchange buffer, ``cudaMalloc``'ed by the library
    (never PyTorch's caching allocator, whose blocks are sub-allocations);
    the ranks swap its ``cudaIpcGetMemHandle`` handles over the mesh's
    gloo group once per buffer size, and each rank maps its peers' buffers
    with ``cudaIpcOpenMemHandle`` (on one card between processes, and over
    NVLink between cards alike).  A rank never opens its own handle (CUDA
    refuses it): a store to itself uses its own pointer;
  * the kernel stores the sender's bytes straight into the receivers'
    mapped buffers (the DMA's ``start``);
  * the semaphores' ``wait`` is the host's: synchronise the stream (the
    kernel's completion makes its stores visible; no fence in the kernel),
    a gloo barrier, the receiver copies its buffer into a fresh tensor, and
    a second barrier before any rank writes that buffer again.

Plain twin: the same exchange as ``torch.distributed.batch_isend_irecv``
over gloo on CPU tensors.  A CPU tensor takes it; a CUDA tensor launches
the kernel or raises (no fallback to gloo or to ``cudaMemcpyPeer``).
A permutation follows ``jax.lax.ppermute``: rank dst's output is rank
src's input for every (src, dst) pair, and a rank that no pair targets
gets zeros.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

from ..core import cuda_lib

HANDLE_BYTES = 64            # sizeof(cudaIpcMemHandle_t)
MAX_SEGS = 8                 # segments a launch (csrc/peer.cu kMaxSegs)
MIN_BUFFER = 1 << 16


def _call(fn_name: str, *args) -> None:
    """A buffer call of the library (no kernel: not counted); raises on a
    CUDA error."""
    handle = cuda_lib.lib()
    err = getattr(handle, fn_name)(*args)
    if err != 0:
        msg = handle.hetpu_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} ({err})")


class Exchange:
    """One rank's exchange buffers for one mesh, mapped into its peers.

    ``buffer(nbytes)`` returns (own pointer, {group rank: mapped pointer})
    of a buffer of at least ``nbytes``; capacities are powers of two, and
    every rank of the mesh asks for the same sizes in the same order (the
    programs are SPMD), so all of them allocate and swap handles together.
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self._bufs: dict[int, tuple[int, dict[int, int]]] = {}

    def buffer(self, nbytes: int) -> tuple[int, dict[int, int]]:
        cap = max(MIN_BUFFER, 1 << max(nbytes - 1, 0).bit_length())
        hit = self._bufs.get(cap)
        if hit is not None:
            return hit
        mesh = self.mesh
        ptr = ctypes.c_void_p()
        with torch.cuda.device(mesh.device):
            _call("hetpu_peer_alloc", cap, ctypes.addressof(ptr))
        own, peers = ptr.value, {}
        self._bufs[cap] = (own, peers)
        if mesh.size > 1:
            raw = (ctypes.c_char * HANDLE_BYTES)()
            _call("hetpu_peer_handle", own, ctypes.addressof(raw))
            mine = torch.frombuffer(bytearray(raw.raw), dtype=torch.uint8)
            got = [torch.empty(HANDLE_BYTES, dtype=torch.uint8)
                   for _ in range(mesh.size)]
            dist.all_gather(got, mine, group=mesh.group)
            for r, h in enumerate(got):
                if r == mesh.rank:
                    continue
                hb = (ctypes.c_char * HANDLE_BYTES).from_buffer_copy(
                    bytes(h.tolist()))
                mapped = ctypes.c_void_p()
                with torch.cuda.device(mesh.device):
                    _call("hetpu_peer_open", ctypes.addressof(hb),
                          ctypes.addressof(mapped))
                peers[r] = mapped.value
        return own, peers

    def close(self) -> None:
        """Unmap the peers' buffers, wait for every rank to do the same,
        then free this rank's own."""
        if not self._bufs:
            return
        with torch.cuda.device(self.mesh.device):
            for _, peers in self._bufs.values():
                for p in peers.values():
                    _call("hetpu_peer_close", p)
            self.mesh.barrier()
            for own, _ in self._bufs.values():
                _call("hetpu_peer_free", own)
        self._bufs.clear()


# ----------------------------------------------------------------------
# the exchange: kernel on the card, gloo point-to-point on the CPU
# ----------------------------------------------------------------------

def store(mesh, segs, cap: int) -> int:
    """One ``peer_permute`` launch (no wait): segs are (src tensor, byte
    offset, dst group rank, dst byte offset, bytes); each lands in the
    destination rank's exchange buffer of ``cap`` bytes (the size every
    rank asks for).  Returns this rank's own buffer pointer."""
    own, peers = mesh.exchange.buffer(cap)
    segs = [s for s in segs if s[4] > 0]
    if len(segs) > MAX_SEGS:
        raise ValueError(f"peer_permute: {len(segs)} segments, at most "
                         f"{MAX_SEGS} a launch")
    if not segs:
        return own
    srcs = [t.data_ptr() + off for t, off, _, _, _ in segs]
    dsts = [(own if r == mesh.rank else peers[r]) + off
            for _, _, r, off, _ in segs]
    sizes = [n for *_, n in segs]
    if any(v % 4 for v in srcs + dsts + sizes):
        raise ValueError("peer_permute: addresses and sizes must be "
                         "multiples of 4 bytes")
    n = len(segs)
    src_a = (ctypes.c_void_p * n)(*srcs)
    dst_a = (ctypes.c_void_p * n)(*dsts)
    len_a = (ctypes.c_ulonglong * n)(*sizes)
    cuda_lib.launch("peer_permute", "hetpu_peer_permute", mesh.device,
                    ctypes.addressof(src_a), ctypes.addressof(dst_a),
                    ctypes.addressof(len_a), n)
    return own


def copy(dst: int, src: int, nbytes: int, device) -> None:
    """``cudaMemcpyAsync`` device to device on the current stream (not a
    kernel of the package: not counted)."""
    with torch.cuda.device(device):
        _call("hetpu_peer_copy", dst, src, nbytes,
              torch.cuda.current_stream(device).cuda_stream)


def _exchange_card(mesh, segs, cap: int, out: torch.Tensor | None) -> None:
    """:func:`store`, then the wait: after every rank has stored, ``out``
    (if given) receives the first ``out.nbytes`` of this rank's buffer,
    and no rank writes that buffer again before every rank has read."""
    own = store(mesh, segs, cap)
    stream = torch.cuda.current_stream(mesh.device)
    stream.synchronize()
    mesh.barrier()                       # every store has landed
    if out is not None and out.numel():
        copy(out.data_ptr(), own, out.nbytes, mesh.device)
        stream.synchronize()
    mesh.barrier()                       # the buffer may be written again


def _exchange_plain(mesh, sends, recvs) -> None:
    """sends: (tensor, dst group rank); recvs: (tensor, src group rank);
    a rank's send to itself is a copy."""
    ops = []
    for t, r in sends:
        if r != mesh.rank:
            ops.append(dist.P2POp(dist.isend, t, mesh.global_rank(r),
                                  mesh.group))
    for t, r in recvs:
        if r != mesh.rank:
            ops.append(dist.P2POp(dist.irecv, t, mesh.global_rank(r),
                                  mesh.group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    own = [t for t, r in sends if r == mesh.rank]
    for t, r in recvs:
        if r == mesh.rank:
            t.copy_(own[0])


def _on_card(x: torch.Tensor, mesh) -> bool:
    """True for a tensor on the mesh's card (the kernel), False for a CPU
    tensor (the twin, over the mesh's gloo group); raises otherwise."""
    if x.dtype.itemsize % 4:
        raise TypeError(f"peer_permute moves 32-bit words, got {x.dtype}")
    card = cuda_lib.on_card(x)
    if card and x.device != mesh.device:
        raise ValueError(f"tensor on {x.device}, mesh on {mesh.device}")
    return card


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """``jax.lax.ppermute`` over ``mesh[axis]``: for every (src, dst) pair
    of axis indices, rank dst gets rank src's ``x``; a rank that no pair
    targets gets zeros."""
    n = mesh.shape[axis]
    perm = [(int(s), int(d)) for s, d in perm]
    srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts) \
            or not all(0 <= v < n for v in srcs + dsts):
        raise ValueError(f"ppermute: {perm} is no permutation of 0..{n - 1}")
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    to = [d for s, d in perm if s == i]
    frm = [s for s, d in perm if d == i]
    x = x.contiguous()
    out = torch.empty_like(x) if frm else torch.zeros_like(x)
    if _on_card(x, mesh):
        segs = [(x, 0, ranks[to[0]], 0, x.nbytes)] if to else []
        _exchange_card(mesh, segs, x.nbytes, out if frm else None)
    else:
        _exchange_plain(mesh, [(x, ranks[to[0]])] if to else [],
                        [(out, ranks[frm[0]])] if frm else [])
    return out


def right_permute(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The snippet's exchange: rank i's ``x`` to rank (i + 1) mod n."""
    n = mesh.shape[axis]
    return ppermute(x, mesh, axis, [(i, (i + 1) % n) for i in range(n)])


def _blocks(send: torch.Tensor, mesh, axis: str, dst_block) -> torch.Tensor:
    """Exchange the n blocks of ``send`` [n, ...] (contiguous): block k goes
    to axis rank k at block slot ``dst_block``; returns the n blocks this
    rank received, in the order of their senders."""
    ranks, i = mesh.axis_ranks(axis), mesh.axis_index(axis)
    n = len(ranks)
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    if _on_card(send, mesh):
        nb = send[0].nbytes
        segs = [(send, k * nb if send.stride(0) else 0, ranks[k],
                 dst_block * nb, nb) for k in range(n)]
        _exchange_card(mesh, segs, recv.nbytes, recv)
    else:
        _exchange_plain(mesh, [(send[k], ranks[k]) for k in range(n)],
                        [(recv[k], ranks[k]) for k in range(n)])
    return recv


def all_to_all(x: torch.Tensor, mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(..., tiled=True)``: split ``x`` into n blocks
    along ``split_axis``; block k goes to axis rank k; the blocks received
    are concatenated along ``concat_axis`` in the order of their senders.
    One launch stores all n blocks."""
    n = mesh.shape[axis]
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: axis {split_axis} of "
                         f"{tuple(x.shape)} does not split {n} ways")
    send = torch.stack([c.contiguous() for c in x.chunk(n, split_axis)])
    recv = _blocks(send, mesh, axis, mesh.axis_index(axis))
    return torch.cat(recv.unbind(0), dim=concat_axis)


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every axis rank's ``x`` concatenated along ``dim`` in axis order, on
    every rank; one launch stores ``x`` into all n buffers."""
    n = mesh.shape[axis]
    x = x.contiguous()
    send = x.unsqueeze(0).expand(n, *x.shape)
    if not cuda_lib.on_card(x):
        send = send.contiguous()
    recv = _blocks(send, mesh, axis, mesh.axis_index(axis))
    return torch.cat(recv.unbind(0), dim=dim)
