"""The set-up phases (``utils.profiling.phase`` and ``host_s``), on the CPU
at test_tiny and test_bfv_crt:

  * ``Session.create`` / ``BfvSession.create`` and two encryptions fill
    ``host_s`` with ``context``, ``keys``, ``encode`` and ``encrypt``, and
    their sum stays within the block's wall time;
  * a plan built inside ``encrypt`` counts under ``context`` only (self
    time);
  * under ``torch.profiler`` the phases open no span, and keys and
    ciphertexts are bit-equal with and without the profiler;
  * ``cuda_lib.reset_launches`` clears ``host_s``, a steady-state
    evaluator op, in-slot FFT (test_deep) or diagonal-method matrix
    product adds nothing to it, and nested phases opened from many
    threads at once count each self time once, none lost;
  * a tiny ``mul_stream`` cell through the benchmark's harness, traced,
    reports the five ``setup_*_s`` metrics, which sum to its
    ``setup_s``.
"""

import dataclasses
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hebench import harness
from hebench.tests import tiny
from hetpu_torch.bfv import BfvSession
from hetpu_torch.core import cuda_lib
from hetpu_torch.fft import bfft
from hetpu_torch.linalg import BatchedMatrix
from hetpu_torch.session import Session
from hetpu_torch.utils import profiling

torch.set_num_threads(1)

KEY_SEED = bytes(range(32))
ENC_SEEDS = (b"\x11" * 32, b"\x22" * 32)
PHASES = ("context", "keys", "encode", "encrypt")
SETUP = ("setup_card_s", "setup_context_s", "setup_keys_s",
         "setup_encrypt_s", "setup_rest_s")
THREADS, ENTRIES = 16, 2000
SCHEMES = {
    "ckks": (Session, "test_tiny", [1, 2, 3], [0.5, -0.25, 0.125]),
    "bfv": (BfvSession, "test_bfv_crt", [], [1, 2, 3, 4]),
}


def _setup(scheme: str):
    """A session from the key seed, and two ciphertexts from fixed
    seeds."""
    cls, name, steps, values = SCHEMES[scheme]
    sess = cls.create(name, seed=KEY_SEED, galois_steps=steps, device="cpu")
    cts = [sess.encrypt(values, seed=s) for s in ENC_SEEDS]
    return sess, cts


def _bits(sess, cts) -> list:
    """Every key and ciphertext tensor the set-up made, in one order."""
    enc = sess.encryptor
    ks = [sess.rk.key, *sess.gk.keys]
    return ([enc.sk.data, enc.pk.data] + [k.data for k in ks]
            + [k.shoup for k in ks] + [c.data for c in cts])


@pytest.fixture(scope="module")
def sessions():
    return {s: _setup(s) for s in SCHEMES}


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_create_and_encrypt_fill_the_phases(scheme):
    cuda_lib.reset_launches()
    t = time.perf_counter()
    _setup(scheme)
    wall = time.perf_counter() - t
    got = profiling.host_s
    assert all(got.get(p, 0) > 0 for p in PHASES), got
    assert got.get("card", 0) == 0
    assert sum(got.values()) <= wall


def test_plan_built_inside_encrypt_counts_under_context(monkeypatch):
    """The level-0 Montgomery constants, first asked for by ``encrypt``,
    are built under ``context``: their slowed upload lands there, and
    ``encrypt``'s self time stays below it."""
    sess, _ = _setup("ckks")
    slow, pause = [], 0.05
    make = sess.ctx._t

    def slowed(a):
        time.sleep(pause)
        slow.append(1)
        return make(a)
    monkeypatch.setattr(sess.ctx, "_t", slowed)
    pt = sess.encode([0.5], level=0)
    cuda_lib.reset_launches()
    sess.encryptor.encrypt(pt, seed=ENC_SEEDS[0])
    slept = pause * len(slow)
    assert slow and profiling.host_s["context"] >= slept
    assert 0 < profiling.host_s["encrypt"] < slept


@pytest.mark.parametrize("scheme", list(SCHEMES))
def test_phases_open_no_span_and_change_no_bit(scheme, sessions):
    """Under the profiler the set-up fills ``host_s`` and opens no
    ``hetpu/<phase>`` span; the keys and ciphertexts equal the unprofiled
    set-up's."""
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sess, cts = _setup(scheme)
    assert all(profiling.host_s.get(p, 0) > 0 for p in PHASES)
    names = {e.name for e in prof.events()}
    assert not names & {profiling.PREFIX + p for p in (*PHASES, "card")}
    want = _bits(*sessions[scheme])
    got = _bits(sess, cts)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_reset_launches_clears_host_s():
    with profiling.phase("keys"):
        pass
    assert profiling.host_s["keys"] > 0
    cuda_lib.reset_launches()
    assert not any(profiling.host_s.values())


def test_nested_phases_from_many_threads(monkeypatch):
    """Threads open nested phases at once, on a clock that each thread
    advances by 1 a read: an inner phase counts 1 and its outer 2 (3 less
    the inner 1) an entry, and no update is lost."""
    ticks = threading.local()

    def perf_counter():
        ticks.n = getattr(ticks, "n", 0) + 1
        return float(ticks.n)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=perf_counter))

    def work():
        for _ in range(ENTRIES):
            with profiling.phase("outer"):
                with profiling.phase("inner"):
                    pass
    cuda_lib.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert profiling.host_s["inner"] == THREADS * ENTRIES
    assert profiling.host_s["outer"] == 2 * THREADS * ENTRIES


@pytest.fixture(scope="module")
def apps(sessions):
    """The in-slot FFT's session (test_deep, 4 points) and a tiny
    diag × col matrix pair (4 × 4 at test_tiny), as their cells call
    them."""
    fft = Session.create("test_deep", seed=KEY_SEED,
                         galois_steps=[1, -1, 2, -2], device="cpu")
    sig = np.tile([0.5, -0.25, 0.125j, 0.75], fft.slots // 4)
    sess = sessions["ckks"][0]
    m = np.arange(16.0).reshape(4, 4) / 16
    return {"bfft": (fft, (fft.encrypt(sig, seed=ENC_SEEDS[0]), None)),
            "matmul": (sess, (BatchedMatrix.encrypt(sess, m, "diag"),
                              BatchedMatrix.encrypt(sess, m.T, "col")))}


OPS = {
    "multiply_relin_rescale": ("ckks", lambda s, a, b:
                               s.ev.multiply_relin_rescale(a, b, s.rk)),
    "rotate": ("ckks", lambda s, a, b: s.ev.rotate(a, 1, s.gk)),
    "bfv_multiply_relin": ("bfv", lambda s, a, b: s.multiply_relin(a, b)),
    "bfft": ("bfft", lambda s, a, b: bfft(s, a, 4)),
    "diag_matmul": ("matmul", lambda s, a, b: a.matmul(b)),
}


@pytest.mark.parametrize("op", list(OPS))
def test_steady_state_op_opens_no_phase(op, sessions, request):
    """A call made once before adds nothing to ``host_s``: every plan
    and plaintext it uses is built, and it encodes and encrypts nothing."""
    case, fn = OPS[op]
    pool = sessions if case in SCHEMES else request.getfixturevalue("apps")
    sess, (a, b) = pool[case]
    fn(sess, a, b)
    before = dict(profiling.host_s)
    fn(sess, a, b)
    assert profiling.host_s == before


def test_tiny_cell_reports_the_setup_split():
    """Traced, the harness reads the five metrics; with ``setup_s`` read
    beside them they sum to it, and the rest is not negative."""
    c = tiny.cell("mul_stream")
    c = dataclasses.replace(c, per_layer=[*SETUP, "setup_s"])
    cuda_lib.reset_launches()
    out = harness.run_cell(c, tiny.SEED, 0.05, True, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert out["correct"], out["checks"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(m) == {*SETUP, "setup_s"}
    assert all(out["metrics"][k]["unit"] == "s" for k in SETUP)
    assert m["setup_card_s"] == 0
    assert m["setup_context_s"] > 0 and m["setup_keys_s"] > 0
    assert m["setup_encrypt_s"] > 0 and m["setup_rest_s"] >= 0
    assert np.isclose(sum(m[k] for k in SETUP), m["setup_s"],
                      rtol=1e-12, atol=1e-12)
