"""BFV of hetpu_torch against hetpu's, bit for bit, on the CPU — the analogs
of tests/test_bfv_crt.py: the shared cases (tests/torch_bfv_cases.py) at
test_bfv_crt (CRT plaintext modulus t = t₁·t₂ ≈ 2^34, 6 data primes) and
test_bfv_pow (coefficient encoding, t = 2^16), then at test_bfv_crt the
multiply at a dropped level, the k-part multiply of a deferred-relin
chain, ``crt_lift_auto`` and golden_pins ``bfv_out``
(tests/test_golden.py: seed 0x34, galois_steps=[1])."""

import pathlib

import numpy as np
import pytest

from hetpu_torch import convert
from hetpu_torch.bfv import BfvSession
from hetpu_torch.core.modular import from_u32, to_u32
from torch_bfv_cases import (_ints, case_for, eq,  # noqa: F401
                             test_decrypt_and_budget, test_encode_encrypt,
                             test_keys_equal, test_mod_switch, test_multiply,
                             test_multiply_relin, test_plain_ops,
                             test_rotations)

GOLD = pathlib.Path(__file__).parent / "golden"
CASES = [("test_bfv_crt", b"\x0b" * 32), ("test_bfv_pow", b"\x0c" * 32)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return case_for(*request.param)


@pytest.fixture(scope="module")
def crt():
    return case_for(*CASES[0])


def test_crt_params(crt):
    p = crt.port.ctx.params
    assert len(p.plain_factors) == 2
    assert p.plain_modulus == p.plain_factors[0] * p.plain_factors[1]
    top = len(p.moduli) - 1
    lvl, want = crt.port.scheme._lvl(top), crt.ref.scheme._lvl(top)
    for k in ("Q", "B_primes", "G_primes", "G"):
        assert lvl[k] == want[k], k
    for k in ("delta_mod_q", "t_mod_qb", "qinv_mod_b", "delta_shoup",
              "t_shoup_qb", "qinv_shoup_b"):
        np.testing.assert_array_equal(to_u32(lvl[k]), want[k], err_msg=k)
    assert lvl["tables_B"].primes == tuple(want["tables_B"].primes)


def test_multiply_at_dropped_level(crt):
    ref, port = crt.ref, crt.port
    ca, cb = (crt.ref_op(("ms", i), lambda i=i: ref.mod_switch(crt.rcts[i]))
              for i in (0, 1))
    assert ca.level == ref.ctx.num_data - 2
    want = ref.multiply_relin(ca, cb)
    got = port.multiply_relin(convert.ciphertext(ca, "cpu"),
                              convert.ciphertext(cb, "cpu"))
    eq(got, want, "multiply_relin at a dropped level")
    assert port.noise_budget(got) == ref.noise_budget(want) > 0
    np.testing.assert_array_equal(_ints(port.decrypt(got)),
                                  crt.plain_product(*crt.vals[:2]))


def test_multiply_kpart(crt):
    """(a·b) [3 parts] × c [2 parts] → 4 parts: the general part-wise
    convolution over both bases."""
    ref, port = crt.ref, crt.port
    c3 = crt.ref_product()
    want = ref.scheme.multiply(c3, crt.rcts[2], ref.ev)
    got = port.scheme.multiply(convert.ciphertext(c3, "cpu"), crt.pcts[2],
                               port.ev)
    assert got.num_parts == 4
    eq(got, want, "k-part multiply")
    assert port.noise_budget(got) == ref.noise_budget(want) > 0
    t = crt.t
    np.testing.assert_array_equal(
        _ints(port.scheme.decrypt(got, port.sk_data)),
        crt.vals[0] * crt.vals[1] % t * crt.vals[2] % t)


def test_crt_lift_auto_matches_full(crt, rng):
    """crt_lift_auto equals the exact full lift and hetpu's, for small,
    medium and full-range values."""
    ctx, rctx = crt.port.ctx, crt.ref.ctx
    lvl = ctx.num_data - 1
    primes = ctx.params.moduli[: lvl + 1]
    Q = ctx.q_at(lvl)
    for hi in (1 << 16, 1 << 60, Q - 1):
        vals = [int(rng.integers(0, min(hi, 1 << 62))) for _ in range(64)]
        vals[0] = hi - 1
        res = np.stack([np.array([v % q for v in vals], dtype=np.uint32)
                        for q in primes])
        got = ctx.crt_lift_auto(res, lvl)
        want = ctx.crt_lift(res, lvl)
        assert all(int(a) == int(b) for a, b in zip(got, want))
        assert all(int(a) == int(b)
                   for a, b in zip(got, rctx.crt_lift_auto(res, lvl)))


def test_bfv_golden_pin():
    """golden_pins bfv_out: multiply_relin of bfv_a, bfv_b under seed 0x34
    (tests/test_golden.py:103-115), on the port's CPU path."""
    z = np.load(GOLD / "golden_pins.npz")
    bs = BfvSession.create("test_bfv_crt", seed=b"\x34" * 32,
                           galois_steps=[1], device="cpu")
    proto = bs.encrypt(np.zeros(4, dtype=np.int64))
    ca = proto.with_(data=from_u32(z["bfv_a"]))
    cb = proto.with_(data=from_u32(z["bfv_b"]))
    out = bs.multiply_relin(ca, cb)
    np.testing.assert_array_equal(to_u32(out.data), z["bfv_out"])
