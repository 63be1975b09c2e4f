"""BFV in the benchmark: the harness's session by the configuration's
scheme, and the BFV referee against the definition and the port: its
secret, its exact scale-and-round, its slot order and its plain math."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from hebench import harness
from hebench.reference import bfv, bfv_mul_stream, ckks
from hebench.tests import tiny

SEED = bytes(range(32))


@pytest.fixture(scope="module")
def sess():
    from hetpu_torch.bfv import BfvSession
    return BfvSession.create("test_bfv_crt", seed=SEED, galois_steps=[],
                             device="cpu")


def test_harness_builds_the_schemes_session(monkeypatch):
    """A configuration of scheme ``bfv`` gets a ``BfvSession`` (on the CPU
    at ``test_bfv_crt``), with the keyword arguments a CKKS one gets."""
    from hetpu_torch.bfv import BfvSession
    from hetpu_torch.session import Session
    assert harness.session_class("ckks") is Session
    assert harness.session_class("bfv") is BfvSession
    made, create = [], BfvSession.create.__func__

    def spy(cls, preset, **kw):
        made.append((preset, sorted(kw)))
        return create(cls, preset, **kw)
    monkeypatch.setattr(BfvSession, "create", classmethod(spy))
    out = tiny.run("bfv_mul_stream")
    assert out["correct"], out["checks"]
    assert made == [("test_bfv_crt", ["device", "galois_steps", "seed"])]


def test_harness_stops_on_an_unknown_scheme():
    c = tiny.cell("bfv_mul_stream")
    c = dataclasses.replace(c, config={**c.config, "scheme": "tfhe"})
    with pytest.raises(SystemExit, match="tfhe"):
        harness.run_cell(c, tiny.SEED, 0.05, False, "cpu",
                         time.perf_counter(), log=lambda s: None)


def test_secret_is_the_ports(sess):
    """The referee's secret, re-derived from the key seed, is the port's
    ``KeyGenerator`` secret (Montgomery evaluation form over every
    prime)."""
    p = sess.ctx.params
    b = ckks.Basis.make(p.poly_degree, p.moduli + p.special_moduli, "cpu")
    want = ckks.secret_eval(SEED, b) * ((1 << 32) % b.t["q"]) % b.t["q"]
    got = sess.sk_data.to(torch.int64) % b.t["q"]
    assert torch.equal(got, want)


def _exact(x, primes, t):
    """round(t·x/Q) mod t and |t·x/Q − that| with Python integers."""
    Q = int(np.prod([int(q) for q in primes], dtype=object))
    ms, offs = [], []
    for col in zip(*[r.tolist() for r in x]):
        v = sum(r * (Q // q) * pow(Q // q, -1, q)
                for r, q in zip(col, primes)) % Q
        m = (2 * t * v + Q) // (2 * Q)
        ms.append(m % t)
        offs.append(abs(t * v - m * Q) / Q)
    return ms, offs


def test_scale_round_is_exact():
    """Against Python integers: residues of random values, of edge values
    and of values whose t·x/Q lies within t/(2Q) of a half (Q is odd, so
    never on it), which the float sum cannot place."""
    primes = [1073643521, 1073479681, 1073184769, 1073053697]
    t = (1 << 60) - 93
    Q = int(np.prod(primes, dtype=object))
    rng = np.random.default_rng(7)
    vals = [int(rng.integers(0, 2**62)) * int(rng.integers(0, 2**62)) % Q
            for _ in range(200)]
    vals += [((2 * k + 1) * Q + t) // (2 * t) + d
             for k in range(0, t, t // 97) for d in (-1, 0, 1)]
    vals += [0, 1, Q - 1, Q // 2, Q // 2 + 1, Q // t, Q // t + 1]
    x = torch.tensor([[v % q for v in vals] for q in primes],
                     dtype=torch.int64)
    m, off = bfv.scale_round(x, primes, t)
    want_m, want_off = _exact(x, primes, t)
    assert m.tolist() == want_m
    np.testing.assert_allclose(off.numpy(), want_off, rtol=0, atol=1e-9)
    assert sum(abs(o - 0.5) < 1e-6 for o in want_off) >= 97


def test_decrypt_agrees_with_the_port(sess):
    """The referee's slots of a multiply_relin at test_bfv_crt are the
    port's decryption and x·y mod t, with a margin in every
    coefficient."""
    p = sess.ctx.params
    t = p.plain_modulus
    rng = np.random.default_rng(11)
    x = rng.integers(0, t, (2, sess.slots))
    y = rng.integers(0, t, (2, sess.slots))
    enc = lambda v: [sess.encrypt(r, seed=bytes([i + 1]) * 32)
                     for i, r in enumerate(v)]
    stack = lambda cs: cs[0].with_(data=torch.stack([c.data for c in cs]))
    out = sess.multiply_relin(stack(enc(x)), stack(enc(y)))
    cfg = {"moduli": list(p.moduli), "plain_modulus": t,
           "plain_factors": list(p.plain_factors)}
    a = ckks.Answer(data=out.data, scales=[1.0, 1.0], slots=sess.slots,
                    inputs={"x": x, "y": y, "t": t})
    (slots, bad), = bfv.values([a], SEED, cfg, "cpu")
    assert bad == 0
    for i in range(2):
        port = sess.decrypt(out.with_(data=out.data[i]))
        assert slots[i].tolist() == [int(v) for v in port]
    j = bfv.judge([(slots, bad)], [a], bfv_mul_stream.expected, "cpu")
    assert j["checks"] == {"slot_mismatch": 0, "limb_mismatch": 0}


def test_plain_math_is_exact():
    """x·y mod t for 60-bit t as Python integers give it; the float64
    control loses low bits in almost every slot."""
    t = (1 << 60) - 93
    rng = np.random.default_rng(3)
    x = rng.integers(0, t, (3, 64))
    y = rng.integers(0, t, (3, 64))
    inputs = {"x": x, "y": y, "t": t}
    got = bfv_mul_stream.expected(inputs, torch.int64, "cpu")
    want = [[int(a) * int(b) % t for a, b in zip(r, s)] for r, s in zip(x, y)]
    assert got.tolist() == want
    low = torch.round(bfv_mul_stream.expected(inputs, torch.float64, "cpu"))
    assert int((low.to(torch.int64) % t != got).sum()) > 0.9 * got.numel()
