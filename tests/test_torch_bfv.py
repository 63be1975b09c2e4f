"""BFV of hetpu_torch against hetpu's, bit for bit, on the CPU — the analogs
of tests/test_bfv.py at test_bfv_tiny (batching, one 17-bit t) and
test_bfv_scalar (coefficient encoding, t = 2^20): keys under one seed,
encode and encrypt, the HPS multiply, relinearize in both FBC modes,
decrypt / decrypt_coeffs_mod_t / noise_budget, mod_switch, the rotations
and the plain ops (tests/torch_bfv_cases.py holds the test functions),
plus the session's protocol and the entry points' device default."""

import inspect

import numpy as np
import pytest
import torch

from hetpu_torch.bfv import BfvSession
from hetpu_torch.core.params import preset
from torch_bfv_cases import (case_for, eq, test_decrypt_and_budget,  # noqa: F401
                             test_encode_encrypt, test_keys_equal,
                             test_mod_switch, test_multiply,
                             test_multiply_relin, test_plain_ops,
                             test_rotations)

CASES = [("test_bfv_tiny", b"\x07" * 32), ("test_bfv_scalar", b"\x0b" * 32)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def case(request):
    return case_for(*request.param)


def test_session_protocol():
    """The mat_* protocol of the linalg layer, square_relin and the
    scalar (coefficient) products of tests/test_bfv_crt.py."""
    s = BfvSession.create("test_bfv_scalar", seed=b"\x0b" * 32,
                          galois_steps=[1], device="cpu")
    t = s.ctx.params.plain_modulus
    x, y = 12345, 54321
    cx, cy = s.encrypt([x], seed=b"\x01" * 32), s.encrypt([y], seed=b"\x02" * 32)
    prod = s.multiply_relin(cx, cy)
    got = s.decrypt(prod)
    assert int(got[0]) == x * y % t and not np.asarray(got[1:]).any()
    eq(s.mat_mult_finish(cx, cy), prod)
    eq(s.mat_reduce_finish(s.mat_multiply(cx, cy)), prod)
    assert int(s.decrypt(s.square_relin(cx))[0]) == x * x % t
    with pytest.raises(ValueError, match="BFV"):
        from hetpu_torch.core.bfv import BfvScheme
        BfvScheme(type(s.ctx)(preset("test_tiny"), "cpu"))


def test_entry_point_defaults_to_the_card():
    assert inspect.signature(BfvSession.create).parameters[
        "device"].default == "cuda"
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError):
        BfvSession.create("test_bfv_tiny", seed=b"\x01" * 32)
