"""The evaluator's stage spans and the kernels' launch bytes, on the CPU.

  * under ``torch.profiler``, ``multiply_relin_rescale`` (test_tiny) opens
    ``hetpu/mul.tensor``, ``hetpu/ks.decompose``, ``hetpu/ks.inner`` and
    ``hetpu/ks.tail`` once each, in that order, apart, inside the caller's
    span; ``rotate`` (test_dnum) opens ``hetpu/rot.galois`` for the
    gathers of c0 and c1, then the decompose, the inner product and
    ``hetpu/ks.mod_down``; ``rescale`` opens ``hetpu/rescale``;
  * with no profiler ``span`` is the one shared no-op, and the outputs
    are bit-equal with and without profiling;
  * every kernel wrapper's bytes (``cuda_lib.plane_bytes``) equal a hand
    count from the shapes: the wrappers are driven down their kernel path
    with the launch recorded instead of made (``on_card`` true, a fake
    ``launch``), at test_tiny and test_dnum;
  * ``launch_bytes`` counts only while a profiler records, a capture
    records its bytes apart, a replay adds them, and a reset clears them.
"""

import contextlib
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hetpu_torch.core import centered_fbc, cuda_lib
from hetpu_torch.probes import copy as probe_copy
from hetpu_torch.probes import dot as probe_dot
from hetpu_torch.probes import kernel_parts, overhead2
from hetpu_torch.session import Session
from hetpu_torch.utils import profiling

torch.set_num_threads(1)

SEED = b"\x5a" * 32
B = 2
N = 1024


def _session(name, **kw):
    return Session.create(name, seed=SEED, galois_steps=[1], device="cpu",
                          **kw)


def _batch(sess, salt):
    cts = [sess.encrypt([0.25 * (i + salt)] * 4) for i in range(B)]
    return cts[0].with_(data=torch.stack([c.data for c in cts]))


@pytest.fixture(scope="module")
def tiny():
    s = _session("test_tiny")
    return s, _batch(s, 1), _batch(s, 2)


@pytest.fixture(scope="module")
def tiny_centered():
    s = _session("test_tiny", centered_fbc=True)
    return s, _batch(s, 1), _batch(s, 2)


@pytest.fixture(scope="module")
def dnum():
    s = _session("test_dnum")
    return s, _batch(s, 3)


def _spans(fn, tmp_path):
    """The ``hetpu/`` spans and the caller's ``evaluate`` span that
    ``fn`` opens under the profiler, in start order, and fn's result."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("evaluate"):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ev.sort(key=lambda e: e["ts"])
    outer = next(e for e in ev if e["name"] == "evaluate")
    return [e for e in ev if e["name"].startswith("hetpu/")], outer, out


def test_mul_relin_rescale_spans(tiny, tmp_path):
    sess, a, b = tiny
    spans, outer, _ = _spans(
        lambda: sess.ev.multiply_relin_rescale(a, b, sess.rk), tmp_path)
    assert [s["name"] for s in spans] == [
        "hetpu/mul.tensor", "hetpu/ks.decompose", "hetpu/ks.inner",
        "hetpu/ks.tail"]
    for s, t in zip(spans, spans[1:]):
        assert s["ts"] + s["dur"] <= t["ts"]
    assert outer["ts"] <= spans[0]["ts"]
    assert spans[-1]["ts"] + spans[-1]["dur"] <= outer["ts"] + outer["dur"]


def test_rotate_and_rescale_spans(dnum, tmp_path):
    sess, a = dnum
    spans, _, _ = _spans(lambda: sess.ev.rotate(a, 1, sess.gk), tmp_path)
    assert [s["name"] for s in spans] == [
        "hetpu/rot.galois", "hetpu/rot.galois", "hetpu/ks.decompose",
        "hetpu/ks.inner", "hetpu/ks.mod_down"]
    spans, _, _ = _spans(lambda: sess.ev.rescale(a), tmp_path)
    assert [s["name"] for s in spans] == ["hetpu/rescale"]


def test_span_off_is_the_shared_noop_and_outputs_bit_equal(tiny, tmp_path):
    sess, a, b = tiny
    assert not profiling.profiler_on()
    assert profiling.span("ks.tail") is profiling.span("mul.tensor")
    assert isinstance(profiling.span("x"), contextlib.nullcontext)
    plain = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    _, _, traced = _spans(
        lambda: sess.ev.multiply_relin_rescale(a, b, sess.rk), tmp_path)
    assert torch.equal(plain.data, traced.data)
    assert plain.level == traced.level and plain.scale == traced.scale


# ----------------------------------------------------------------------
# launch bytes: every wrapper's reckoning against a hand count
# ----------------------------------------------------------------------

@pytest.fixture
def made(monkeypatch):
    """The launches the wrappers make, as (kernel, bytes), with every
    tensor taken for a card tensor and no launch made."""
    got = []

    def launch(kernel, fn_name, device, *args, nbytes):
        got.append((kernel, nbytes))
    monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "launch", launch)
    return got


def _planes(*pairs):
    """(kernel, int32 planes of N words) → (kernel, bytes)."""
    return [(k, 4 * N * p) for k, p in pairs]


# test_tiny at its top level: L = 3 data primes, K = 1 special, α = 1,
# J = 3 digits over R = L + K = 4 primes, g = 1; B = 2 pairs.  The
# decompose reads c2 in place, lifts each digit to its R − 1 foreign primes
# (F = J·R − L = 9) and stores its L own-prime limbs beside them.
# The tail's divide has Lo = R − L + g = 2 sources and L − g = 2 targets,
# on 2B part rows.
TINY_KS = [("ntt", 2 * 3 * 2),                # c2 [B, L] in and out
           ("ntt_fwd_lifted", 2 * (3 + 9)),   # c2's L in, F out
           ("ks_tail", 2 * (3 + 3)),          # own limbs: c2's L in, L out
           ("inner_product",
            2 * 3 * 4 + 2 * (3 * 2 * 4) + 2 * 2 * 4),  # digits, k + ks, out
           ("ks_tail", 4 * 2 + 4 * 1 + 4 * 2),  # acc's Lo, c's g, out Lo
           ("ntt", 4 * 2 * 2),
           ("ntt_fwd_fbc", 4 * (2 + 2)),
           ("ks_tail", 4 * 2 * 4)]              # acc, c, r and out, L − g


def _centered(pairs):
    names = {"ntt_fwd_lifted": "ntt_fwd_centered",
             "ntt_fwd_fbc": "ntt_fwd_centered"}
    return [(names.get(k, k), p) for k, p in pairs]


CASES = {
    # x and y [B, 2, L] in, [B, 3, L] out
    "multiply_relin_rescale": ("tiny", [("tensor_product",
                                         2 * 2 * 3 * 2 + 2 * 3 * 3)]
                               + TINY_KS),
    "square_relin_rescale": ("tiny", [("tensor_product",
                                       2 * 2 * 3 + 2 * 3 * 3)] + TINY_KS),
    "multiply_relin_rescale_centered": (
        "tiny_centered", _centered([("tensor_product",
                                     2 * 2 * 3 * 2 + 2 * 3 * 3)] + TINY_KS)),
    # test_dnum at its top level: L = 8, K = 3, α = 3, J = 3, R = 11,
    # F = 33 − 8 = 25; the mod-down by P on 2B part rows: its 3 special
    # limbs in, the 8 data limbs out
    "rotate": ("dnum", [("ntt", 2 * 8 * 2),
                        ("ntt_fwd_lifted", 2 * (8 + 25)),
                        ("ks_tail", 2 * (8 + 8)),
                        ("inner_product", 2 * 3 * 11 + 2 * 3 * 2 * 11
                         + 2 * 2 * 11),
                        ("ntt", 4 * 3 * 2),
                        ("ntt_fwd_fbc", 4 * (3 + 8)),
                        ("ks_tail", 4 * 8 * 3)]),    # x's 8, r, out
    # the last limb's INTT, its lift to the other 7, their NTT, the divide
    "rescale": ("dnum", [("ntt", 4 * 1 * 2), ("ks_tail", 4 * (1 + 7)),
                         ("ntt", 4 * 7 * 2), ("ks_tail", 4 * 7 * 3)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_launch_bytes(case, tiny, tiny_centered, dnum, made):
    # the sessions (module fixtures) are made before ``made`` patches
    fixture, want = CASES[case]
    sess, a, *rest = {"tiny": tiny, "tiny_centered": tiny_centered,
                      "dnum": dnum}[fixture]
    ev = sess.ev
    op = case.removesuffix("_centered")
    if op == "multiply_relin_rescale":
        ev.multiply_relin_rescale(a, rest[0], sess.rk)
    elif op == "square_relin_rescale":
        ev.square_relin_rescale(a, sess.rk)
    elif op == "rotate":
        ev.rotate(a, 1, sess.gk)
    else:
        ev.rescale(a)
    assert made == _planes(*want)


def test_centered_fbc_and_probe_launch_bytes(dnum, made):
    sess, a = dnum
    # K5: digit 0's 3 primes lifted to its 8 foreign ones, on [B, 3] rows
    plan = centered_fbc.lift_plan(sess.ctx.keyswitch_plan(7), 0)
    plan.apply(a.data[:, 0, :3].contiguous())
    assert made.pop() == ("centered_fbc", 4 * N * 2 * (3 + 8))
    x = torch.zeros(8, 2, 32, 32, dtype=torch.int32)
    probe_copy.copy_planes(x)
    overhead2.muladd_u32(x)
    assert made[-2:] == [("copy_planes", 2 * x.nbytes),
                         ("muladd_u32", 2 * x.nbytes)]
    ua = torch.zeros(64, 32, dtype=torch.uint8)
    sb = torch.zeros(2, 32, 128, dtype=torch.int8)
    probe_dot.dot_i8(ua, sb)
    assert made[-1] == ("dot_i8", 64 * 32 + 2 * 32 * 128 + 4 * 2 * 64 * 128)
    n = kernel_parts.N1
    xp = torch.zeros(1, 1, n, n, dtype=torch.int32)
    w = torch.zeros(1, 4 * n, 4 * n, dtype=torch.int8)
    tw = torch.zeros(1, n, n, dtype=torch.int32)
    kernel_parts.plane_parts("copy", xp, w, tw, tw)
    assert made[-1] == ("plane_parts", 2 * xp.nbytes)     # no tables


# ----------------------------------------------------------------------
# launch_bytes: when it counts
# ----------------------------------------------------------------------

@pytest.fixture
def fake_lib(monkeypatch):
    """``launch`` against a library whose every entry succeeds, off the
    card; the counters start at 0."""
    handle = type("Lib", (), {"hetpu_ntt": staticmethod(lambda *a: 0)})()
    stream = type("S", (), {"cuda_stream": 0})()
    monkeypatch.setattr(cuda_lib, "lib", lambda: handle)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: stream)
    monkeypatch.setattr(cuda_lib, "launches",
                        dict.fromkeys(cuda_lib.launches, 0))
    monkeypatch.setattr(cuda_lib, "launch_bytes",
                        dict.fromkeys(cuda_lib.launches, 0))
    return lambda nbytes: cuda_lib.launch("ntt", "hetpu_ntt", "cpu",
                                          nbytes=nbytes)


def test_launch_bytes_count_only_under_a_profiler(fake_lib):
    fake_lib(100)
    assert cuda_lib.launches["ntt"] == 1 and cuda_lib.launch_bytes["ntt"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        fake_lib(100)
        fake_lib(28)
    assert cuda_lib.launches["ntt"] == 3
    assert cuda_lib.launch_bytes["ntt"] == 128
    cuda_lib.reset_launches()
    assert not any(cuda_lib.launches.values())
    assert not any(cuda_lib.launch_bytes.values())


def test_recorded_bytes_and_replays(fake_lib):
    with cuda_lib.recording() as rec:
        fake_lib(64)
        fake_lib(36)
    assert rec["ntt"] == 2 and rec.nbytes["ntt"] == 100
    assert cuda_lib.launches["ntt"] == 0 and cuda_lib.launch_bytes["ntt"] == 0
    kernels = {k: n for k, n in rec.items() if n}
    nbytes = {k: b for k, b in rec.nbytes.items() if b}
    cuda_lib.count_replay(kernels, nbytes)
    assert cuda_lib.launches["ntt"] == 2 and cuda_lib.launch_bytes["ntt"] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        cuda_lib.count_replay(kernels, nbytes)
        cuda_lib.count_replay(kernels)
    assert cuda_lib.launches["ntt"] == 6
    assert cuda_lib.launch_bytes["ntt"] == 100


def test_stage_device_us_by_launch():
    """``trace_op``'s split: each device operation under the innermost
    ``hetpu/`` span open at its launch (nested spans too), else "none"."""
    x = lambda cat, name, ts, dur, **a: {"ph": "X", "cat": cat,
                                         "name": name, "ts": ts, "dur": dur,
                                         "args": a}
    ev = [x("user_annotation", "hetpu/ks.mod_down", 0, 50),
          x("user_annotation", "hetpu/rescale", 10, 10),
          x("user_annotation", "other", 60, 10),
          x("cuda_runtime", "cudaLaunchKernel", 5, 1, correlation=1),
          x("cuda_runtime", "cudaLaunchKernel", 12, 1, correlation=2),
          x("cuda_runtime", "cudaMemcpyAsync", 30, 1, correlation=3),
          x("cuda_runtime", "cudaLaunchKernel", 61, 1, correlation=4),
          x("kernel", "a", 40, 8, correlation=1),
          x("kernel", "b", 48, 4, correlation=2),
          x("gpu_memcpy", "Memcpy DtoD", 52, 2, correlation=3),
          x("kernel", "c", 70, 6, correlation=4),
          x("gpu_user_annotation", "hetpu/ks.mod_down", 40, 14)]
    assert profiling.stage_device_us(ev, steps=2) == {
        "hetpu/ks.mod_down": 5.0, "none": 3.0, "hetpu/rescale": 2.0}
