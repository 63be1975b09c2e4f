"""P5 ``peer_permute``'s flag protocol (``parallel.peer.protocol``, the
arithmetic that ``csrc/peer.cu`` runs on the card), simulated on the CPU.

Every rank of a simulated mesh makes the same random sequence of
exchanges on one buffer (permutations, shifts, butterflies, all-to-alls,
gathers, empty ones), each as the kernel's steps: send wait, a store into
each receiver's slot, the signals, receive wait, read-out, the
acknowledgements.  A random interleaving picks, at each tick, one rank
whose next step may run.  Checked: no sender stores into a slot that its
receiver has still to read, every read-out finds exactly its senders'
data of its own epoch, each receiver waits on exactly its senders, and
every rank finishes (no deadlock).  The wrapper's launch is built from
the same function.
"""

import contextlib
import ctypes
import random

import pytest
import torch
from hypothesis import given, settings, strategies as st

from hetpu_torch.parallel import peer

PATTERNS = ("perm", "right", "xor", "all", "gather_one", "none")


def _pairs(kind: str, n: int, rng: random.Random) -> list:
    if kind == "perm":
        src = rng.sample(range(n), rng.randint(1, n))
        dst = rng.sample(range(n), len(src))
        return list(zip(src, dst))
    if kind == "right":
        return [(i, (i + 1) % n) for i in range(n)]
    if kind == "xor":
        shift = 1 << rng.randrange(n.bit_length() - 1)
        return [(i, i ^ shift) for i in range(n)]
    if kind == "all":
        return [(a, b) for a in range(n) for b in range(n)]
    if kind == "gather_one":
        root = rng.randrange(n)
        return [(a, root) for a in range(n)]
    return []


class Rank:
    """One simulated rank: its position in the sequence and the step of
    the current exchange it runs next."""

    def __init__(self, rank: int):
        self.rank, self.k, self.step, self.todo = rank, 0, "send_wait", []


def _simulate(n: int, sequence: list, seed: int) -> None:
    rng = random.Random(seed)
    # flags[r]: rank r's buffer; data[r][slot][s] = (epoch, s) stored by s
    arrived = [[0] * n for _ in range(n)]
    read = [[0] * n for _ in range(n)]
    data = [[{}, {}] for _ in range(n)]
    # the epochs each rank has still to read out (those with senders)
    unread = [{k + 1 for k, pairs in enumerate(sequence)
               if any(d == r for _, d in pairs)} for r in range(n)]
    ranks = [Rank(r) for r in range(n)]

    def plan(me: Rank) -> peer.Step:
        pairs = sequence[me.k]
        step = peer.protocol(me.rank, n, pairs, me.k + 1)
        assert set(step.waits) == {s for s, d in pairs if d == me.rank}
        assert set(step.signals) == {d for s, d in pairs if s == me.rank}
        assert step.acks == tuple(range(n))
        assert step.slot == (me.k + 1) % peer.SLOTS
        return step

    def enabled(me: Rank) -> bool:
        if me.k == len(sequence):
            return False
        step = plan(me)
        if me.step == "send_wait":
            return all(read[me.rank][r] >= v
                       for r, v in step.send_after.items())
        if me.step == "recv_wait":
            return all(arrived[me.rank][s] >= step.epoch for s in step.waits)
        return True

    def run(me: Rank) -> None:
        step = plan(me)
        e, slot = step.epoch, step.slot
        if me.step == "send_wait":
            me.todo = list(step.signals)
            rng.shuffle(me.todo)
            me.step = "store"
        elif me.step == "store":
            if me.todo:
                r = me.todo.pop()
                older = [u for u in unread[r] if u < e and u % 2 == slot]
                assert not older, (f"rank {me.rank} stores epoch {e} into "
                                   f"slot {slot} of rank {r}, which has "
                                   f"still to read epochs {older}")
                data[r][slot][me.rank] = (e, me.rank)
            if not me.todo:
                me.step = "signal"
        elif me.step == "signal":
            for r in step.signals:
                arrived[r][me.rank] = e
            me.step = "recv_wait"
        elif me.step == "recv_wait":
            me.step = "read_out"
        elif me.step == "read_out":
            for s in step.waits:
                assert data[me.rank][slot].get(s) == (e, s), (
                    f"rank {me.rank} reads {data[me.rank][slot].get(s)} "
                    f"from rank {s} at epoch {e}")
            unread[me.rank].discard(e)
            me.step = "ack"
        else:
            for r in step.acks:
                read[r][me.rank] = e
            me.k, me.step = me.k + 1, "send_wait"

    while True:
        ready = [r for r in ranks if enabled(r)]
        if not ready:
            break
        run(rng.choice(ready))
    stuck = [(r.rank, r.k, r.step) for r in ranks if r.k < len(sequence)]
    assert not stuck, f"deadlock: {stuck}"


@settings(max_examples=300, deadline=None)
@given(n=st.sampled_from([2, 4, 8]),
       kinds=st.lists(st.sampled_from(PATTERNS), min_size=1, max_size=12),
       seed=st.integers(0, 2 ** 32 - 1))
def test_protocol_interleavings(n, kinds, seed):
    """Random exchange sequences, random interleavings of 2, 4 and 8
    simulated ranks."""
    rng = random.Random(seed ^ 0x5EED)
    _simulate(n, [_pairs(k, n, rng) for k in kinds], seed)


@pytest.mark.parametrize("n", [2, 4])
def test_protocol_stress_sequence(n):
    """The card's stress sequence: 64 exchanges alternating the right
    shift and the butterfly, every interleaving seed of a few."""
    seq = [[(i, (i + 1) % n) for i in range(n)] if k % 2 == 0
           else [(i, i ^ 1) for i in range(n)] for k in range(64)]
    for seed in range(20):
        _simulate(n, seq, seed)


def test_protocol_values():
    """Slots alternate from epoch 1; a receiver's "read" word must show
    epoch − 2 (0 for the first two); a rank in no pair waits for no one
    and still acknowledges to every rank; epoch 0 is refused."""
    pairs = [(0, 1), (1, 2), (2, 0)]
    s = peer.protocol(0, 4, pairs, 1)
    assert (s.slot, s.signals, s.send_after, s.waits) == (1, (1,), {1: 0},
                                                          (2,))
    s = peer.protocol(0, 4, pairs, 6)
    assert (s.slot, s.send_after) == (0, {1: 4})
    s = peer.protocol(3, 4, pairs, 6)
    assert (s.signals, s.send_after, s.waits, s.acks) == ((), {}, (),
                                                          (0, 1, 2, 3))
    with pytest.raises(ValueError, match="epoch 0"):
        peer.protocol(0, 2, pairs, 0)


class _FakeExchange(peer.Exchange):
    def buffer(self, nbytes):
        cap = self.capacity(nbytes)
        self.epochs.setdefault(cap, 0)
        return 0x10000, {r: 0x20000 * (r + 1) for r in range(self.mesh.size)
                         if r != self.mesh.rank}


class _FakeMesh:
    def __init__(self, rank, size):
        self.rank, self.size, self.device = rank, size, torch.device("cpu")
        self.exchange = _FakeExchange(self)


def test_exchange_builds_launch_from_protocol(monkeypatch):
    """``_exchange_card`` enqueues the exchange from :func:`protocol`: the
    stream waits on each receiver's "read" word (from the third epoch on),
    a launch that stores and signals (none for a rank with no receivers),
    the waits on each sender's "arrived" word, a launch that reads out and
    acknowledges; it counts the buffer's epoch and refuses a segment to a
    rank that no pair names.  Nothing in it waits on the host."""
    calls = []
    monkeypatch.setattr(peer, "store",
                        lambda mesh, segs, cap, send, epoch: calls.append(
                            ("store", send, epoch, len(segs))))
    monkeypatch.setattr(peer, "read",
                        lambda mesh, cap, out, recv, epoch: calls.append(
                            ("read", recv, epoch, out is not None)))
    monkeypatch.setattr(peer, "_wait", lambda ex, cap, word, value, dev:
                        calls.append(("wait", word, value)))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    mesh = _FakeMesh(1, 4)
    x = torch.zeros(16, dtype=torch.int32)
    pairs = [(0, 1), (1, 3), (3, 0)]
    for e in range(1, 4):
        calls.clear()
        peer._exchange_card(mesh, [(x, 0, 3, 0, x.nbytes)], pairs, x.nbytes,
                            x)
        sends = [("wait", peer.READ_WORD + 3, e - 2)] if e > 2 else []
        assert calls == sends + [("store", 0b1000, e, 1),
                                 ("wait", peer.ARRIVED_WORD + 0, e),
                                 ("read", 0b1, e, True)]
        assert mesh.exchange.epochs[peer.MIN_BUFFER] == e
    calls.clear()
    peer._exchange_card(_FakeMesh(2, 4), [], pairs, x.nbytes, None)
    assert calls == [("read", 0, 1, False)]
    with pytest.raises(ValueError, match="no pair names"):
        peer._exchange_card(mesh, [(x, 0, 2, 0, x.nbytes)], pairs, x.nbytes,
                            x)
    mesh.exchange.failed = "peer_permute: exchange 4 ... aborted"
    with pytest.raises(RuntimeError, match="exchange 4"):
        peer._exchange_card(mesh, [(x, 0, 3, 0, x.nbytes)], pairs, x.nbytes,
                            x)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        peer._exchange_card(mesh, [(x, 0, 3, 0, x.nbytes)], pairs, x.nbytes,
                            x)


@pytest.mark.parametrize("base", [0, 2 ** 32 - 3])
def test_stall_rule(base):
    """The watchdog's rule, epochs modulo 2^32 (``base`` puts a wrap inside
    the run): caught up is never stalled; behind, the clock starts at the
    first look and restarts whenever the card's epoch moves; stalled only
    after more than ``HANG_S`` at one value."""
    e = lambda k: (base + k) % peer.EPOCHS
    h = peer.HANG_S
    assert peer.stall(None, e(5), e(5), 0.0) == (None, False)
    assert peer.stall((e(4), 0.0), e(5), e(5), 99.0) == (None, False)
    seen, hit = peer.stall(None, e(4), e(7), 1.0)
    assert (seen, hit) == ((e(4), 1.0), False)
    assert peer.stall(seen, e(4), e(7), 1.0 + h) == (seen, False)
    assert peer.stall(seen, e(4), e(8), 1.0 + h + 0.01) == (seen, True)
    assert peer.stall(seen, e(5), e(8), 2.0 + h) == ((e(5), 2.0 + h), False)


def test_watchdog_aborts_a_stalled_buffer(monkeypatch):
    """``Exchange.check`` reads each buffer's progress word (here a word
    of host memory), leaves a buffer whose card keeps up or moves alone,
    and aborts one whose card stood still for ``HANG_S`` behind the host:
    the abort's poison lies a quarter of the epoch space past the host's
    count, ``failed`` names the exchange, and the buffer is watched no
    more."""
    calls = []
    monkeypatch.setattr(peer, "_call", lambda *a: calls.append(a))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    ex = peer.Exchange(_FakeMesh(1, 2))
    words = {cap: ctypes.c_uint32(0) for cap in (1 << 16, 1 << 20)}
    for cap, w in words.items():
        ex._bufs[cap] = (0x1000 * cap, {0: 0})
        ex._progress[cap] = (ctypes.addressof(w), 0)
        ex.epochs[cap] = 3
    words[1 << 20].value = 3                   # caught up
    assert ex.check(0.0) and ex.check(5.0)
    words[1 << 16].value = 1                   # moved: the clock restarts
    assert ex.check(6.0) and ex.check(6.0 + peer.HANG_S)
    assert calls == [] and ex.failed is None
    assert not ex.check(6.1 + peer.HANG_S)
    assert calls == [("hetpu_peer_abort", 0x1000 << 16, 1 << 16,
                      3 + peer.EPOCHS // 4)]
    assert "exchange 2 on the 65536-byte buffer of rank 1" in ex.failed


def test_watchdog_thread_runs_while_watched():
    """The watchdog's thread starts with the first watched exchange, asks
    each one to look every ``WATCH_S``, drops one whose look aborted it,
    and ends once none is left."""
    class Looks:
        def __init__(self, aborts_at):
            self.n, self.aborts_at = 0, aborts_at

        def check(self, now):
            self.n += 1
            return self.n < self.aborts_at

    dog = peer._Watchdog()
    a, b = Looks(2), Looks(4)
    dog.add(a)
    dog.add(b)
    thread = dog.thread
    thread.join(timeout=20 * peer.WATCH_S)
    assert not thread.is_alive() and dog.thread is None
    assert (a.n, b.n) == (2, 4)
    dog.add(a)
    dog.stop()
    assert dog.thread is None and not dog.exchanges
