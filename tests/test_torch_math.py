"""The port's encrypted elementary functions (``hetpu_torch.math``) and the
``HE`` operator DSL (``hetpu_torch.ops``) against hetpu's on the CPU, bit
for bit on the ciphertext residues, with each result's level and scale.

The math functions run at test_deep on hetpu's seeded encryptions, with
the inputs of tests/test_math.py and shorter iterations (hetpu compiles
every op at every level it reaches on the CPU), and their decrypts against
the same iterations on the plain values; each hetpu result is computed
once.  The DSL runs at test_tiny: every operator, plain operands
auto-encoded at the ciphertext's level and scale.
"""

import numpy as np
import pytest

from hetpu import math as ref_math
from hetpu.ops import HE as RefHE
from hetpu.session import Session as RefSession
from hetpu_torch import math as port_math
from hetpu_torch.ops import HE
from hetpu_torch.session import Session
from torch_app_cases import (abs_replica, assert_same, encrypt_pair,
                             inv_replica, inv_sqrt_twice_replica)

SEED = b"\x03" * 32
DSL_SEED = b"\x0a" * 32


class Deep:
    """hetpu and the port at test_deep under one seed, with the operands
    of every function as (hetpu ciphertext, port ciphertext) pairs."""

    def __init__(self):
        self.ref = RefSession.create("test_deep", seed=SEED, galois_steps=[1])
        self.port = Session.create("test_deep", seed=SEED, galois_steps=[1],
                                   device="cpu")
        rng = np.random.default_rng(7)
        slots = self.port.slots
        base = rng.uniform(-0.5, 0.5, slots)
        diff = rng.uniform(0.6, 1.0, slots) * rng.choice([-1, 1], slots)
        self.values = {
            "inv": rng.uniform(0.5, 1.5, slots),
            "isqrt": rng.uniform(0.4, 0.7, slots),
            "sqrt": rng.uniform(0.4, 0.9, slots),
            "abs": rng.uniform(0.5, 1.0, slots) * rng.choice([-1, 1], slots),
            "x1": base + diff / 2, "x2": base - diff / 2,
        }
        self.cts = {k: encrypt_pair(self.ref, v, bytes([0x50 + i]) * 32)
                    for i, (k, v) in enumerate(self.values.items())}
        self._ref = {}

    def ref_op(self, name, fn):
        if name not in self._ref:
            self._ref[name] = fn()
        return self._ref[name]


@pytest.fixture(scope="module")
def deep():
    return Deep()


def _sqrt(x, a, k):
    return inv_sqrt_twice_replica(x, a, k) * np.sqrt(2.0) * x


def _twice_max(v):
    return v["x1"] + v["x2"] + abs_replica(v["x1"] - v["x2"], 1.0, ITERS)


def _twice_min(v):
    return v["x1"] + v["x2"] - abs_replica(v["x1"] - v["x2"], 1.0, ITERS)


# Short iterations: hetpu compiles every op at every level it reaches.
ITERS, INV_ITERS = 2, 2
# name → (operands, call(module, session, *cts), the same iterations on
# the plain values)
MATH = {
    "mult_const_to": (("inv",), lambda m, s, c: m.mult_const_to(
        s, c, -2.5, c.scale), lambda v: -2.5 * v["inv"]),
    "signed_inv": (("inv",), lambda m, s, c: m.signed_inv(
        s, c, 0.8, INV_ITERS), lambda v: inv_replica(v["inv"], 0.8,
                                                     INV_ITERS)),
    "inv_sqrt_twice": (("isqrt",), lambda m, s, c: m.inv_sqrt_twice(
        s, c, 1.0, ITERS), lambda v: inv_sqrt_twice_replica(v["isqrt"], 1.0,
                                                            ITERS)),
    "sqrt": (("sqrt",), lambda m, s, c: m.sqrt(s, c, 1.0, ITERS),
             lambda v: _sqrt(v["sqrt"], 1.0, ITERS)),
    "abs_": (("abs",), lambda m, s, c: m.abs_(s, c, 1.0, ITERS),
             lambda v: abs_replica(v["abs"], 1.0, ITERS)),
    "twice_max": (("x1", "x2"), lambda m, s, a, b: m.twice_max(
        s, a, b, 1.0, ITERS), _twice_max),
    "max_": (("x1", "x2"), lambda m, s, a, b: m.max_(s, a, b, 1.0, ITERS),
             lambda v: _twice_max(v) / 2),
    "min_": (("x1", "x2"), lambda m, s, a, b: m.min_(s, a, b, 1.0, ITERS),
             lambda v: _twice_min(v) / 2),
}


@pytest.mark.parametrize("name", list(MATH))
def test_math_function(deep, name):
    """Bit-exact against hetpu; the decrypt within 1e-3 of the same
    iterations run on the plain values."""
    ops, call, replica = MATH[name]
    want = deep.ref_op(name, lambda: call(
        ref_math, deep.ref, *(deep.cts[k][0] for k in ops)))
    got = call(port_math, deep.port, *(deep.cts[k][1] for k in ops))
    assert_same(got, want)
    np.testing.assert_allclose(deep.port.decrypt(got).real,
                               replica(deep.values), rtol=0, atol=1e-3)


def test_math_rejects_bad_iterations(deep):
    ct = deep.cts["inv"][1]
    for fn in (port_math.signed_inv, port_math.inv_sqrt_twice):
        with pytest.raises(ValueError, match="iter_num"):
            fn(deep.port, ct, 1.0, 0)


# ----------------------------------------------------------------------
# the HE DSL at test_tiny
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    ref = RefSession.create("test_tiny", seed=DSL_SEED,
                            galois_steps=[1, 2, -1])
    port = Session.create("test_tiny", seed=DSL_SEED, galois_steps=[1, 2, -1],
                          device="cpu")
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-1, 1, (2, port.slots))
    (rx, px), (ry, py) = (encrypt_pair(ref, v, bytes([0x70 + i]) * 32)
                          for i, v in enumerate((x, y)))
    return ref, port, (rx, ry), (px, py), (x, y)


VEC = np.linspace(-1, 1, 512)
DSL = {   # name → (expression on (x, y, session), expected of (x, y))
    "neg": (lambda x, y, s: -x, lambda x, y: -x),
    "add": (lambda x, y, s: x + y, lambda x, y: x + y),
    "sub": (lambda x, y, s: x - y, lambda x, y: x - y),
    "add_scalar": (lambda x, y, s: x + 0.5, lambda x, y: x + 0.5),
    "radd_scalar": (lambda x, y, s: 0.25 + x, lambda x, y: x + 0.25),
    "sub_vector": (lambda x, y, s: x - VEC, lambda x, y: x - VEC),
    "mul_relin_rescale": (lambda x, y, s: ((x * y) & s.rk) ^ 1,
                          lambda x, y: x * y),
    "mul_scalar_rescale": (lambda x, y, s: (x * 2.0) ^ 1,
                           lambda x, y: 2 * x),
    "mul_vector_rescale": (lambda x, y, s: (x * VEC) ^ 1,
                           lambda x, y: VEC * x),
    "rmul_scalar_rescale": (lambda x, y, s: (0.5 * x) ^ 1,
                            lambda x, y: 0.5 * x),
    "mod_switch": (lambda x, y, s: x | 1, lambda x, y: x),
    "mod_switch_then_scalar": (lambda x, y, s: (x | 1) + 0.5,
                               lambda x, y: x + 0.5),
    "mixed_levels": (lambda x, y, s: (x | 1) + y, lambda x, y: x + y),
    "rotate_left": (lambda x, y, s: x << 2, lambda x, y: np.roll(x, -2)),
    "rotate_right": (lambda x, y, s: x >> 1, lambda x, y: np.roll(x, 1)),
}


@pytest.mark.parametrize("name", list(DSL))
def test_dsl_operator(tiny, name):
    ref, port, (rx, ry), (px, py), (x, y) = tiny
    expr, expect = DSL[name]
    want = expr(RefHE(ref, rx), RefHE(ref, ry), ref)
    got = expr(HE(port, px), HE(port, py), port)
    assert isinstance(got, HE)
    assert_same(got.ct, want.ct)
    np.testing.assert_allclose(got.decrypt().real, expect(x, y), atol=1e-3)


def test_dsl_raw_product_is_three_parts(tiny):
    ref, port, (rx, ry), (px, py), _ = tiny
    got = (HE(port, px) * HE(port, py)).ct
    assert got.num_parts == 3
    assert_same(got, (RefHE(ref, rx) * RefHE(ref, ry)).ct)
