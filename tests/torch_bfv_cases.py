"""Shared BFV cases of tests/test_torch_bfv.py and test_torch_bfv_crt.py:
the same test functions, each module picking its presets through its own
``case`` fixture (``case_for``).

A case holds a hetpu BfvSession and the port's on the CPU under one seed,
and three of hetpu's ciphertexts (seeded encryptions) carried over with
``hetpu_torch.convert``.  hetpu's BFV runs its conversions eagerly, so
each new shape costs it tens of seconds of XLA compiles: every hetpu
result is computed once per case (``Case.ref_op``) and shared by the
tests.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from hetpu.bfv import BfvSession as RefBfvSession
from hetpu.core.evaluator import Evaluator as RefEvaluator
from hetpu_torch import convert
from hetpu_torch.bfv import BfvSession
from hetpu_torch.core.modular import to_u32

torch.set_num_threads(1)

STEPS = [1]


class Case:
    def __init__(self, name: str, seed: bytes):
        self.name = name
        self.seed = seed
        self.ref = RefBfvSession.create(name, seed=seed, galois_steps=STEPS)
        self.port = BfvSession.create(name, seed=seed, galois_steps=STEPS,
                                      device="cpu")
        p = self.port.ctx.params
        self.t = p.plain_modulus
        self.batching = p.plain_batching
        rng = np.random.default_rng(len(name))
        # batching: a full slot vector mod t; coefficients: a short poly,
        # so the product has no negacyclic wrap
        size = self.port.slots if self.batching else 8
        self.vals = [np.array([int(x) % self.t for x in
                               rng.integers(0, 1 << 62, size)], dtype=object)
                     for _ in range(3)]
        self.rcts = [self.ref.scheme.encrypt(
            self.ref.encryptor, self.ref.encode(v), seed=bytes([0x40 + i]) * 32)
            for i, v in enumerate(self.vals)]
        self.pcts = [convert.ciphertext(c, "cpu") for c in self.rcts]
        self._ref = {}

    def ref_op(self, key, fn):
        """hetpu's result of ``fn()``, computed once per case."""
        if key not in self._ref:
            self._ref[key] = fn()
        return self._ref[key]

    def ref_product(self):
        """hetpu's 3-part multiply of ciphertexts 0 and 1."""
        return self.ref_op("mul", lambda: self.ref.multiply(*self.rcts[:2]))

    def plain_product(self, a, b):
        """The expected decrypt of a·b: slotwise, or the polynomial
        product of two short coefficient vectors."""
        if self.batching:
            return (a * b) % self.t
        out = np.zeros(self.port.slots, dtype=object)
        out[: 2 * len(a) - 1] = np.convolve(a, b) % self.t
        return out

    def decoded(self, vals):
        """``vals`` as the decrypt returns them (full length)."""
        if self.batching:
            return vals
        out = np.zeros(self.port.slots, dtype=object)
        out[: len(vals)] = vals
        return out


@functools.cache
def case_for(name: str, seed: bytes) -> Case:
    """One Case per (preset, seed) and process: a module's ``case``
    fixture and its own fixtures share hetpu's results."""
    return Case(name, seed)


def eq(got, want, msg=""):
    assert (got.level, got.scale) == (want.level, want.scale), msg
    np.testing.assert_array_equal(to_u32(got.data), np.asarray(want.data),
                                  err_msg=msg)


def _ints(x):
    return np.array([int(v) for v in x], dtype=object)


def test_keys_equal(case):
    ref, port = case.ref, case.port
    np.testing.assert_array_equal(to_u32(port.sk_data),
                                  np.asarray(ref.sk_data))
    np.testing.assert_array_equal(to_u32(port.encryptor.pk.data),
                                  np.asarray(ref.encryptor.pk.data))
    np.testing.assert_array_equal(to_u32(port.rk.key.data),
                                  np.asarray(ref.rk.key.data))
    assert port.gk.elts == tuple(ref.gk.elts)
    for g, w in zip(port.gk.keys, ref.gk.keys, strict=True):
        np.testing.assert_array_equal(to_u32(g.data), np.asarray(w.data))
        np.testing.assert_array_equal(to_u32(g.shoup), np.asarray(w.shoup))


def test_encode_encrypt(case):
    ref, port, v = case.ref, case.port, case.vals[0]
    pt, rpt = port.encode(v), ref.encode(v)
    assert (pt.level, pt.scale) == (rpt.level, rpt.scale)
    np.testing.assert_array_equal(to_u32(pt.data), np.asarray(rpt.data))
    np.testing.assert_array_equal(to_u32(pt.shoup), np.asarray(rpt.shoup))
    eq(port.scheme.encrypt(port.encryptor, pt, bytes([0x40]) * 32),
       case.rcts[0], "scheme.encrypt")
    eq(port.encrypt(v, seed=bytes([0x40]) * 32), case.rcts[0], "encrypt")


def test_multiply(case):
    eq(case.port.multiply(*case.pcts[:2]), case.ref_product(), "multiply")


@pytest.mark.parametrize("centered", [False, True])
def test_multiply_relin(case, centered, monkeypatch):
    """Relinearize of hetpu's product with the default FBC, and with
    ``centered_fbc=True`` against a fresh hetpu evaluator under
    HETPU_MXU_FBC=1; the decrypt is exact."""
    ref, port = case.ref, case.port
    c3 = case.ref_product()
    if centered:
        monkeypatch.setenv("HETPU_MXU_FBC", "1")
        ref = dataclasses.replace(ref, ev=RefEvaluator(ref.ctx))
        port = dataclasses.replace(port, ev=type(port.ev)(port.ctx,
                                                           centered_fbc=True))
    want = ref.relinearize(c3)
    got = port.relinearize(convert.ciphertext(c3, "cpu"))
    eq(got, want, "relinearize")
    eq(port.multiply_relin(*case.pcts[:2]), want, "multiply_relin")
    np.testing.assert_array_equal(
        _ints(port.decrypt(got)), case.plain_product(*case.vals[:2]))


def test_decrypt_and_budget(case):
    ref, port = case.ref, case.port
    c3 = case.ref_product()
    c2 = case.ref_op("relin", lambda: ref.relinearize(c3))
    for ct in (case.rcts[0], c2, c3):
        pct = convert.ciphertext(ct, "cpu")
        np.testing.assert_array_equal(
            port.scheme.decrypt_coeffs_mod_t(pct, port.sk_data),
            ref.scheme.decrypt_coeffs_mod_t(ct, ref.sk_data))
        np.testing.assert_array_equal(_ints(port.decrypt(pct)),
                                      _ints(ref.decrypt(ct)))
        assert port.noise_budget(pct) == ref.noise_budget(ct)
    fresh = port.noise_budget(case.pcts[0])
    assert 0 < port.noise_budget(convert.ciphertext(c2, "cpu")) < fresh
    np.testing.assert_array_equal(_ints(port.decrypt(case.pcts[0])),
                                  case.decoded(case.vals[0]))


def test_mod_switch(case):
    ref, port = case.ref, case.port
    want = case.ref_op("ms", lambda: ref.mod_switch(case.rcts[0]))
    got = port.mod_switch(case.pcts[0])
    eq(got, want, "mod_switch")
    assert got.level == ref.ctx.num_data - 2
    np.testing.assert_array_equal(_ints(port.decrypt(got)),
                                  case.decoded(case.vals[0]))
    with pytest.raises(ValueError):
        port.mod_switch(got.with_(level=0, data=got.data[..., :1, :]))
    a, b = port.align(case.pcts[1], got)
    assert a.level == b.level == got.level
    eq(a, ref.align(case.rcts[1], want)[0], "align")


def test_rotations(case):
    ref, port = case.ref, case.port
    eq(port.rotate_rows(case.pcts[0], 1), ref.rotate_rows(case.rcts[0], 1),
       "rotate_rows")
    eq(port.rotate_columns(case.pcts[0]), ref.rotate_columns(case.rcts[0]),
       "rotate_columns")
    if case.batching:
        v, half = case.vals[0], port.slots // 2
        got = _ints(port.decrypt(port.rotate_rows(case.pcts[0], 1)))
        want = np.concatenate([np.roll(v[:half], -1), np.roll(v[half:], -1)])
        np.testing.assert_array_equal(got, want)


def test_plain_ops(case):
    ref, port = case.ref, case.port
    a, pa = case.rcts[0], case.pcts[0]
    v = case.vals[2]
    pt, rpt = port.encode(v), ref.encode(v)
    eq(port.add_plain(pa, pt), ref.add_plain(a, rpt), "add_plain")
    eq(port.sub_plain(pa, pt), ref.sub_plain(a, rpt), "sub_plain")
    prod = port.multiply_plain(pa, pt)
    eq(prod, ref.multiply_plain(a, rpt), "multiply_plain")
    eq(port.add(pa, case.pcts[1]), ref.add(a, case.rcts[1]), "add")
    eq(port.sub(pa, case.pcts[1]), ref.sub(a, case.rcts[1]), "sub")
    eq(port.negate(pa), ref.negate(a), "negate")
    np.testing.assert_array_equal(_ints(port.decrypt(prod)),
                                  case.plain_product(case.vals[0], v))
