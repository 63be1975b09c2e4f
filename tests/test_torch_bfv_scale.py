"""The BFV multiply's scale-and-round, on the CPU at test_bfv_crt and
bfv_batch (B=1), each at the top level and one ``mod_switch`` below it
(one session a preset for the module):

  * the inverse transform with t in its epilogue (``ntt_inv(...,
    strip_mont=True, extra=t mod q)``) equals the transform followed by
    the Shoup multiply by t, over Q_ℓ and over the auxiliary basis B;
  * ``ks_tail.sub_mul`` equals ``shoup_mul(mod_sub(u, r), Q⁻¹)`` over B;
  * ``BfvScheme.multiply`` equals the same multiply with the scale's
    steps spelled as those plain passes, bit for bit;
  * ``BfvSession.multiply_relin`` decrypts to x·y mod t in every slot.

Products and residues are uniform in [0, q) for every limb.
"""

import numpy as np
import pytest
import torch

from hetpu_torch.bfv import BfvSession
from hetpu_torch.core import bfv as bfv_core
from hetpu_torch.core import ks_tail
from hetpu_torch.core.modular import from_u32, mod_sub, shoup_mul
from hetpu_torch.core.ntt import ntt_inv

torch.set_num_threads(1)

B = 1
PRESETS = ["test_bfv_crt", "bfv_batch"]
CASES = [(p, d) for p in PRESETS for d in (0, 1)]
IDS = [f"{p}-drop{d}" for p, d in CASES]


@pytest.fixture(scope="module")
def sessions():
    return {p: BfvSession.create(p, seed=b"\x5c" * 32, galois_steps=[],
                                 device="cpu") for p in PRESETS}


def _level(sess, drop):
    return len(sess.ctx.params.moduli) - 1 - drop


def _uniform(rng, shape, primes):
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    return from_u32((rng.integers(0, 1 << 62, shape, dtype=np.uint64) % q
                     ).astype(np.uint32), "cpu")


def _bases(sess, drop):
    """(the level's constants, (tables, primes, t rows) over Q_ℓ and B)."""
    lvl = _level(sess, drop)
    plans = sess.scheme._lvl(lvl)
    L = lvl + 1
    return plans, [
        (sess.ctx.tables(lvl), sess.ctx.params.moduli[:L], slice(0, L)),
        (plans["tables_B"], plans["B_primes"], slice(L, None))]


@pytest.mark.parametrize("preset,drop", CASES, ids=IDS)
def test_inverse_epilogue_folds_t(sessions, preset, drop):
    sess = sessions[preset]
    plans, bases = _bases(sess, drop)
    n = sess.ctx.params.poly_degree
    rng = np.random.default_rng(240 + drop)
    for tabs, primes, rows in bases:
        prod = _uniform(rng, (B, 3, len(primes), n), primes)
        t_mod, t_shoup = plans["t_mod_qb"][rows], plans["t_shoup_qb"][rows]
        got = ntt_inv(prod, tabs, strip_mont=True, extra=t_mod)
        want = shoup_mul(ntt_inv(prod, tabs, strip_mont=True), t_mod,
                         t_shoup, tabs.q)
        assert torch.equal(got, want)


@pytest.mark.parametrize("preset,drop", CASES, ids=IDS)
def test_sub_mul_is_subtract_then_qinv(sessions, preset, drop):
    sess = sessions[preset]
    plans, [_, (tabs_b, primes_b, _)] = _bases(sess, drop)
    n = sess.ctx.params.poly_degree
    rng = np.random.default_rng(250 + drop)
    ub, r_b = (_uniform(rng, (B, 3, len(primes_b), n), primes_b)
               for _ in range(2))
    got = ks_tail.sub_mul(ub, r_b, plans["qinv_mod_b"],
                          plans["qinv_shoup_b"], tabs_b.q)
    want = shoup_mul(mod_sub(ub, r_b, tabs_b.q), plans["qinv_mod_b"],
                     plans["qinv_shoup_b"], tabs_b.q)
    assert torch.equal(got, want)


def _encrypted_pair(sess, drop, seed):
    t = sess.ctx.params.plain_modulus
    rng = np.random.default_rng(seed)
    x, y = (rng.integers(0, t, sess.slots) for _ in range(2))
    a, b = sess.encrypt(x), sess.encrypt(y)
    for _ in range(drop):
        a, b = sess.mod_switch(a), sess.mod_switch(b)
    assert a.level == _level(sess, drop)
    return x, y, a, b


@pytest.mark.parametrize("preset,drop", CASES, ids=IDS)
def test_multiply_equals_the_plain_pass_route(sessions, preset, drop,
                                              monkeypatch):
    """The multiply with t·x as a Shoup pass after each inverse transform
    and (u − r)·Q⁻¹ as a subtract and a Shoup pass gives the same
    ciphertext."""
    sess = sessions[preset]
    _, _, a, b = _encrypted_pair(sess, drop, 260 + drop)
    plans = sess.scheme._lvl(a.level)
    got = sess.multiply(a, b)

    def inv_then_shoup(x, tabs, *, strip_mont=False, extra=None):
        out = ntt_inv(x, tabs, strip_mont=strip_mont)
        if extra is None:
            return out
        rows = (slice(0, a.level + 1) if tabs is sess.ctx.tables(a.level)
                else slice(a.level + 1, None))
        assert torch.equal(extra, plans["t_mod_qb"][rows])
        return shoup_mul(out, extra, plans["t_shoup_qb"][rows], tabs.q)

    def sub_then_shoup(x, r, w, w_shoup, q):
        return shoup_mul(mod_sub(x, r, q), w, w_shoup, q)

    monkeypatch.setattr(bfv_core, "ntt_inv", inv_then_shoup)
    monkeypatch.setattr(bfv_core, "sub_mul", sub_then_shoup)
    want = sess.multiply(a, b)
    assert (got.level, got.data.shape) == (want.level, want.data.shape)
    assert torch.equal(got.data, want.data)


@pytest.mark.parametrize("preset,drop", CASES, ids=IDS)
def test_multiply_relin_decrypts_to_the_product(sessions, preset, drop):
    sess = sessions[preset]
    x, y, a, b = _encrypted_pair(sess, drop, 270 + drop)
    out = sess.multiply_relin(a, b)
    t = sess.ctx.params.plain_modulus
    want = (x.astype(object) * y.astype(object)) % t
    assert out.level == a.level
    assert np.array_equal(np.asarray(sess.decrypt(out), dtype=object), want)
