"""P5 ``peer_permute``: device data exchange between the ranks of a mesh.

Counterpart of the TPU kernel ``right_permute_kernel`` (``SNIPPETS.md:33-43,
98-132``: ``right_permute_wrapper`` :39 and ``right_permute`` :128), in
which each device sends its [8, 128] f32 shard to device (id + 1) mod n
with one ``pltpu.make_async_remote_copy``, starts it and waits on a send
and a receive DMA semaphore.  Here every exchange of the parallel layer —
each round of the ``mod_all_reduce`` butterfly, the all-to-all of the
coefficient-sharded NTT, the gathers of the sharded programs — is the
``peer_permute`` kernel (``csrc/peer.cu``) and its semaphores, the copy
and its wait:

  * each rank owns an exchange buffer per size, ``cudaMalloc``'ed by the
    library (never PyTorch's caching allocator, whose blocks are
    sub-allocations): two data slots and a few flag words, the flags
    zeroed before the ranks swap its ``cudaIpcGetMemHandle`` handles over
    the mesh's gloo group; each rank maps its peers' buffers with
    ``cudaIpcOpenMemHandle`` (on one card between processes, and over
    NVLink between cards alike).  A rank never opens its own handle (CUDA
    refuses it): a store to itself uses its own pointer;
  * an exchange waits until its receivers have read the slot it is about
    to fill (the send semaphore), stores the sender's bytes straight into
    the receivers' mapped buffers and marks them arrived (one launch),
    waits until its own senders have arrived (the receive semaphore), then
    copies its slot into the output and tells every rank it has read it
    (a second launch).  The waits are ``cuStreamWaitValue32`` on the flag
    words, between the launches; :func:`protocol` is the arithmetic.

The host waits for nothing inside an exchange: the waits are on the
current stream like the launches, and the output is ready for the next
op on that stream.  The host meets the other ranks only when a buffer is
allocated (its handles are swapped) and in :meth:`Exchange.close`.  A
watchdog thread stands in for the barriers' timeout: an exchange of a
mesh of several ranks that makes no progress on the card for ``HANG_S``
seconds is aborted, and the next synchronise raises (:func:`stall`).

Plain twin: the same exchange as ``torch.distributed.batch_isend_irecv``
over gloo on CPU tensors.  A CPU tensor takes it; a CUDA tensor launches
the kernel or raises (no fallback to gloo or to ``cudaMemcpyPeer``).
A permutation follows ``jax.lax.ppermute``: rank dst's output is rank
src's input for every (src, dst) pair, and a rank that no pair targets
gets zeros.
"""

from __future__ import annotations

import atexit
import ctypes
import threading
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..core import cuda_lib

HANDLE_BYTES = 64            # sizeof(cudaIpcMemHandle_t)
MAX_SEGS = 8                 # segments a launch (csrc/peer.cu kMaxSegs)
MAX_RANKS = 8                # ranks a mesh on the card (kMaxRanks)
MIN_BUFFER = 1 << 16
SLOTS = 2                    # data slots a buffer: epoch e uses e mod 2
# flag words after the slots (csrc/peer.cu): arrived[s] by sender, read[r]
ARRIVED_WORD, READ_WORD = 0, MAX_RANKS
HANG_S = 10.0                # no progress this long: the exchange aborts
WATCH_S = 0.25               # the watchdog looks this often
EPOCHS = 1 << 32             # epochs compare modulo 2^32 (the flag words)


@dataclass(frozen=True)
class Step:
    """One rank's part of exchange ``epoch`` (1, 2, ...) on one buffer."""
    epoch: int
    slot: int                      # data slot of every store and read-out
    signals: tuple[int, ...]       # receivers: their "arrived" word of this
    #                                rank := epoch after the stores
    send_after: dict[int, int]     # receiver → what its "read" word of this
    #                                rank must show before this rank stores
    waits: tuple[int, ...]         # senders: their "arrived" word here must
    #                                show epoch before the read-out
    acks: tuple[int, ...]          # ranks whose "read" word of this rank :=
    #                                epoch after the read-out (all of them)


def protocol(rank: int, n: int, pairs, epoch: int) -> Step:
    """The flag arithmetic of ``csrc/peer.cu`` for ``rank`` of ``n`` at
    exchange ``epoch`` of a buffer; ``pairs`` are the exchange's (sender,
    receiver) group ranks (a rank needs only the pairs it is in).

    A sender stores into slot ``epoch mod 2`` of a receiver once that
    receiver has read out epoch ``epoch − 2``, the last use of the slot
    (every rank publishes each epoch it completes to every rank, so the
    word moves even while the two do not exchange); a receiver reads out
    once each of its senders, and no other rank, has marked ``epoch``
    arrived."""
    if epoch < 1:
        raise ValueError(f"protocol: epoch {epoch} (epochs start at 1)")
    to = tuple(sorted({d for s, d in pairs if s == rank}))
    frm = tuple(sorted({s for s, d in pairs if d == rank}))
    return Step(epoch=epoch, slot=epoch % SLOTS, signals=to,
                send_after={r: max(epoch - SLOTS, 0) for r in to},
                waits=frm, acks=tuple(range(n)))


def stall(seen, done: int, enqueued: int, now: float):
    """The watchdog's rule for one buffer: ``done`` is the last epoch the
    card completed (the progress word), ``enqueued`` the last the host
    enqueued, ``seen`` what the previous look returned.  Returns (what the
    next look gets, stalled): stalled once ``done`` has stood behind
    ``enqueued`` at one value for more than ``HANG_S``."""
    if not 0 < (enqueued - done) % EPOCHS < EPOCHS // 2:
        return None, False
    if seen is None or seen[0] != done:
        return (done, now), False
    return seen, now - seen[1] > HANG_S


def _mask(ranks) -> int:
    return sum(1 << r for r in ranks)


def _call(fn_name: str, *args) -> None:
    """A buffer call of the library (no kernel: not counted); raises on a
    CUDA error."""
    handle = cuda_lib.lib()
    err = getattr(handle, fn_name)(*args)
    if err != 0:
        msg = handle.hetpu_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed: {msg} ({err})")


class _Watchdog:
    """One daemon thread a process, running while an exchange buffer of a
    mesh of more than one rank is open: every ``WATCH_S`` it has each such
    :class:`Exchange` look at its buffers (:meth:`Exchange.check`, a read
    of pinned host words: no CUDA call unless it aborts)."""

    def __init__(self):
        self.exchanges: set = set()
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.thread: threading.Thread | None = None

    def add(self, ex) -> None:
        with self.lock:
            self.exchanges.add(ex)
            if self.thread is None:
                self.thread = threading.Thread(
                    target=self._run, name="peer_permute watchdog",
                    daemon=True)
                self.thread.start()

    def remove(self, ex) -> None:
        with self.lock:
            self.exchanges.discard(ex)
        self.wake.set()

    def stop(self) -> None:
        with self.lock:
            self.exchanges.clear()
            thread = self.thread
        self.wake.set()
        if thread is not None:
            thread.join()

    def _run(self) -> None:
        while True:
            self.wake.wait(WATCH_S)
            self.wake.clear()
            with self.lock:
                if not self.exchanges:
                    self.thread = None
                    return
                exchanges = list(self.exchanges)
            now = time.monotonic()
            for ex in exchanges:
                if not ex.check(now):
                    self.remove(ex)


_WATCH = _Watchdog()
atexit.register(_WATCH.stop)


class Exchange:
    """One rank's exchange buffers for one mesh, mapped into its peers.

    ``buffer(nbytes)`` returns (own pointer, {group rank: mapped pointer})
    of a buffer whose slots hold at least ``nbytes``; capacities are powers
    of two, and every rank of the mesh asks for the same sizes in the same
    order (the programs are SPMD), so all of them allocate and swap handles
    together, and a buffer's exchanges carry the same epochs on every
    rank.  ``epochs[cap]`` counts the exchanges this host enqueued on a
    buffer: the values its stream waits for.  Each buffer has a progress
    word in pinned host memory, the last epoch its read-out completed on
    the card, which the watchdog reads; ``failed`` says why it aborted."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._bufs: dict[int, tuple[int, dict[int, int]]] = {}
        self._progress: dict[int, tuple[int, int]] = {}   # host, device
        self._seen: dict[int, tuple[int, float] | None] = {}
        self._lock = threading.Lock()
        self.epochs: dict[int, int] = {}
        self.failed: str | None = None

    @staticmethod
    def capacity(nbytes: int) -> int:
        return max(MIN_BUFFER, 1 << max(nbytes - 1, 0).bit_length())

    def buffer(self, nbytes: int) -> tuple[int, dict[int, int]]:
        cap = self.capacity(nbytes)
        hit = self._bufs.get(cap)
        if hit is not None:
            return hit
        mesh = self.mesh
        if mesh.size > MAX_RANKS:
            raise ValueError(f"peer_permute: {mesh.size} ranks, at most "
                             f"{MAX_RANKS} on the card")
        ptr, host, dev = ctypes.c_void_p(), ctypes.c_void_p(), \
            ctypes.c_void_p()
        with torch.cuda.device(mesh.device):
            _call("hetpu_peer_alloc", cap, ctypes.addressof(ptr))
            _call("hetpu_peer_progress", ctypes.addressof(host),
                  ctypes.addressof(dev))
        own, peers = ptr.value, {}
        with self._lock:
            self._bufs[cap] = (own, peers)
            self._progress[cap] = (host.value, dev.value)
            self.epochs[cap] = 0
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
            _WATCH.add(self)
        return own, peers

    def flag(self, cap: int, word: int) -> int:
        """Address of flag ``word`` of this rank's buffer of ``cap``."""
        return self._bufs[cap][0] + SLOTS * cap + 4 * word

    def check(self, now: float) -> bool:
        """The watchdog's look at this rank's buffers (:func:`stall` on
        each progress word).  A stalled buffer is aborted: its flags are
        lifted past every wait and its abort word set, so the launches
        behind the waits trap and the next synchronise raises; ``failed``
        then names the exchange.  Returns False once aborted."""
        with self._lock:
            for cap, (host, _) in self._progress.items():
                done = ctypes.c_uint32.from_address(host).value
                enqueued = self.epochs[cap]
                self._seen[cap], stalled = stall(self._seen.get(cap), done,
                                                 enqueued, now)
                if stalled:
                    self.failed = (
                        f"peer_permute: exchange {done + 1} on the "
                        f"{cap}-byte buffer of rank {self.mesh.rank} made "
                        f"no progress in {HANG_S} s (a peer stopped, or "
                        f"its exchanges differ from this rank's); aborted")
                    with torch.cuda.device(self.mesh.device):
                        _call("hetpu_peer_abort", self._bufs[cap][0], cap,
                              (enqueued + EPOCHS // 4) % EPOCHS)
                    return False
        return True

    def close(self) -> None:
        """Wait for this rank's exchanges on the card (the watchdog still
        bounds the wait), then unmap the peers' buffers, wait for every
        rank to do the same, and free this rank's own."""
        if not self._bufs:
            return
        dev = self.mesh.device
        try:
            with torch.cuda.device(dev):
                torch.cuda.current_stream(dev).synchronize()
        except RuntimeError as err:
            if self.failed:
                raise RuntimeError(self.failed) from err
            raise
        finally:
            _WATCH.remove(self)
        if self.failed:
            raise RuntimeError(self.failed)
        with torch.cuda.device(dev):
            for _, peers in self._bufs.values():
                for p in peers.values():
                    _call("hetpu_peer_close", p)
            self.mesh.barrier()
            with self._lock:
                for own, _ in self._bufs.values():
                    _call("hetpu_peer_free", own)
                for host, _ in self._progress.values():
                    _call("hetpu_peer_free_host", host)
                self._bufs.clear()
                self._progress.clear()
                self._seen.clear()
                self.epochs.clear()


# ----------------------------------------------------------------------
# the exchange: kernel on the card, gloo point-to-point on the CPU
# ----------------------------------------------------------------------

def _bases(mesh, cap: int):
    own, peers = mesh.exchange.buffer(cap)
    n = mesh.size
    return (ctypes.c_void_p * n)(*[own if r == mesh.rank else peers[r]
                                   for r in range(n)])


def store(mesh, segs, cap: int, send_mask: int, epoch: int) -> None:
    """The store and signal of exchange ``epoch`` (one ``peer_permute``
    launch, no wait): segs are (src tensor, byte offset, dst group rank,
    dst byte offset, bytes), each landing in slot ``epoch mod 2`` of the
    destination rank's buffer of ``cap`` bytes (the size every rank asks
    for); then the "arrived" word of this rank := ``epoch`` at each rank
    of ``send_mask``."""
    cap = mesh.exchange.capacity(cap)
    segs = [s for s in segs if s[4] > 0]
    if len(segs) > MAX_SEGS:
        raise ValueError(f"peer_permute: {len(segs)} segments, at most "
                         f"{MAX_SEGS} a launch")
    srcs = [t.data_ptr() + off for t, off, _, _, _ in segs]
    offs = [off for _, _, _, off, _ in segs]
    sizes = [n for *_, n in segs]
    if any(v % 4 for v in srcs + offs + sizes):
        raise ValueError("peer_permute: addresses and sizes must be "
                         "multiples of 4 bytes")
    if any(off + n > cap for off, n in zip(offs, sizes)):
        raise ValueError("peer_permute: a segment overruns the buffer")
    k = max(len(segs), 1)
    bases = _bases(mesh, cap)
    src_a = (ctypes.c_void_p * k)(*srcs)
    rank_a = (ctypes.c_int * k)(*[r for _, _, r, _, _ in segs])
    off_a = (ctypes.c_ulonglong * k)(*offs)
    len_a = (ctypes.c_ulonglong * k)(*sizes)
    cuda_lib.launch("peer_permute", "hetpu_peer_store", mesh.device,
                    ctypes.addressof(bases), mesh.size, mesh.rank, cap,
                    ctypes.addressof(src_a), ctypes.addressof(rank_a),
                    ctypes.addressof(off_a), ctypes.addressof(len_a),
                    len(segs), send_mask, epoch % EPOCHS,
                    nbytes=2 * sum(sizes))


def read(mesh, cap: int, out: torch.Tensor | None, recv_mask: int,
         epoch: int) -> None:
    """The read-out and acknowledgement of exchange ``epoch`` (one
    ``peer_permute`` launch, no wait): ``out`` receives its first
    ``out.nbytes`` of this rank's slot ``epoch mod 2`` (the senders of
    ``recv_mask`` stored them); then the "read" word of this rank :=
    ``epoch`` at every rank, and the buffer's progress word too."""
    ex = mesh.exchange
    cap = ex.capacity(cap)
    out_ptr = out.data_ptr() if out is not None and out.numel() else 0
    out_bytes = out.nbytes if out_ptr else 0
    if out_ptr % 4 or out_bytes % 4:
        raise ValueError("peer_permute: addresses and sizes must be "
                         "multiples of 4 bytes")
    if out_bytes > cap:
        raise ValueError("peer_permute: the output overruns the buffer")
    bases = _bases(mesh, cap)
    cuda_lib.launch("peer_permute", "hetpu_peer_read", mesh.device,
                    ctypes.addressof(bases), mesh.size, mesh.rank, cap,
                    out_ptr or None, out_bytes, recv_mask,
                    ex._progress[cap][1], epoch % EPOCHS,
                    nbytes=2 * out_bytes)


def copy(dst: int, src: int, nbytes: int, device) -> None:
    """``cudaMemcpyAsync`` device to device on the current stream (not a
    kernel of the package: not counted)."""
    with torch.cuda.device(device):
        _call("hetpu_peer_copy", dst, src, nbytes,
              torch.cuda.current_stream(device).cuda_stream)


def _wait(ex, cap: int, word: int, value: int, device) -> None:
    """Stream-ordered wait until flag ``word`` of this rank's buffer of
    ``cap`` shows ``value`` (``cuStreamWaitValue32``; not a kernel: not
    counted)."""
    with torch.cuda.device(device):
        _call("hetpu_peer_wait_value", ex.flag(cap, word), value % EPOCHS,
              torch.cuda.current_stream(device).cuda_stream)


def _exchange_card(mesh, segs, pairs, cap: int,
                   out: torch.Tensor | None) -> None:
    """One exchange, enqueued on the current stream: ``segs`` (as
    :func:`store` takes them) are this rank's sends, ``pairs`` the
    exchange's (sender, receiver) group ranks; ``out`` (if given) receives
    the first ``out.nbytes`` of this rank's slot once its senders have
    stored.  Every rank of the mesh calls it, the ranks that neither send
    nor receive too (their epoch moves on with the others').

    The semaphores' waits are the stream's (``cuStreamWaitValue32``,
    greater or equal): each receiver's "read" word before the launch that
    stores and signals (none for a rank with no receivers), each sender's
    "arrived" word before the launch that reads out and acknowledges.  A
    stream blocked on a wait holds no SM, so the ranks' contexts, which
    time-slice one card, hand it over at once (PERF.md §6).  The wait
    values are the host's count of the buffer's exchanges, so an exchange
    refuses CUDA graph capture: a replay would wait for the captured
    epoch."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("peer_permute: an exchange waits for values "
                           "that the host counts, so it cannot be "
                           "captured in a CUDA graph")
    ex = mesh.exchange
    if ex.failed:
        raise RuntimeError(ex.failed)
    ex.buffer(cap)
    cap = ex.capacity(cap)
    step = protocol(mesh.rank, mesh.size, pairs, ex.epochs[cap] + 1)
    if {s[2] for s in segs if s[4] > 0} - set(step.signals):
        raise ValueError("peer_permute: a segment goes to a rank that no "
                         "pair names")
    for r, v in step.send_after.items():
        if v > 0:
            _wait(ex, cap, READ_WORD + r, v, mesh.device)
    if step.signals:
        store(mesh, segs, cap, _mask(step.signals), step.epoch)
    for s in step.waits:
        _wait(ex, cap, ARRIVED_WORD + s, step.epoch, mesh.device)
    read(mesh, cap, out, _mask(step.waits), step.epoch)
    ex.epochs[cap] = step.epoch


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
    tensor (the twin, over the mesh's gloo group); raises otherwise, and
    for a card whose exchanges the watchdog aborted (before any call that
    would meet the card's error instead)."""
    if x.dtype.itemsize % 4:
        raise TypeError(f"peer_permute moves 32-bit words, got {x.dtype}")
    card = cuda_lib.on_card(x)
    if card and x.device != mesh.device:
        raise ValueError(f"tensor on {x.device}, mesh on {mesh.device}")
    if card and mesh.exchange.failed:
        raise RuntimeError(mesh.exchange.failed)
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
    card = _on_card(x, mesh)
    x = x.contiguous()
    out = torch.empty_like(x) if frm else torch.zeros_like(x)
    if card:
        segs = [(x, 0, ranks[to[0]], 0, x.nbytes)] if to else []
        pairs = [(ranks[s], ranks[d]) for s, d in perm]
        _exchange_card(mesh, segs, pairs, x.nbytes, out if frm else None)
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
    card = _on_card(send, mesh)
    recv = torch.empty(send.shape, dtype=send.dtype, device=send.device)
    if card:
        nb = send[0].nbytes
        segs = [(send, k * nb if send.stride(0) else 0, ranks[k],
                 dst_block * nb, nb) for k in range(n)]
        pairs = [(a, b) for a in ranks for b in ranks]
        _exchange_card(mesh, segs, pairs, recv.nbytes, recv)
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
