"""The port's element-per-ciphertext ``Matrix`` over BFV against hetpu's
on the CPU (test_bfv_tiny): the same residues and exact integer decrypts.

Its own file because hetpu's BFV multiply compiles for over a minute on
the CPU at each new batch shape: one 2×2 product shape serves both
products here, computed once.
"""

import numpy as np
import pytest

from hetpu.bfv import BfvSession as RefBfvSession
from hetpu.linalg import Matrix as RefMatrix
from hetpu_torch.bfv import BfvSession
from hetpu_torch.linalg import Matrix
from torch_app_cases import assert_same, fixed_seeds

BFV_SEED = b"\x0b" * 32


@pytest.fixture(scope="module")
def products():
    """A 2×2 product and the product with the left operand transposed,
    computed by hetpu's Matrix and the port's from the same encryptions."""
    ref = RefBfvSession.create("test_bfv_tiny", seed=BFV_SEED,
                               galois_steps=[1])
    port = BfvSession.create("test_bfv_tiny", seed=BFV_SEED, galois_steps=[1],
                             device="cpu")
    rng = np.random.default_rng(14)
    a, b = rng.integers(0, 1000, (2, 2, 2))
    outs = []
    for pkg, sess in ((RefMatrix, ref), (Matrix, port)):
        with fixed_seeds("bfv"):
            ma, mb = pkg.encrypt(sess, a), pkg.encrypt(sess, b)
        outs.append({"matmul": ma.matmul(mb),
                     "transposed": ma.transp().matmul(mb)})
    want = {"matmul": a @ b, "transposed": a.T @ b}
    return port.ctx.params.plain_modulus, outs[0], outs[1], want


@pytest.mark.parametrize("op", ["matmul", "transposed"])
def test_matrix_bfv_exact(products, op):
    """Through the session's mat_* protocol (relinearize, no rescale):
    the same residues as hetpu and exact integer decrypts."""
    t, ref, port, want = products
    got = port[op]
    assert got.ct.num_parts == 2
    assert_same(got.ct, ref[op].ct)
    exact = got.decrypt_exact()
    assert exact.dtype == object and exact.shape == (2, 2)
    np.testing.assert_array_equal(exact.astype(np.int64), want[op] % t)
