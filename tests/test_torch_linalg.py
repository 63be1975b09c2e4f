"""The port's encrypted linear algebra (``hetpu_torch.linalg``) against
hetpu's on the CPU, bit for bit on the ciphertext residues.

test_tiny (N=2^10, 512 slots), one session per package under one seed:
``BatchedVector.sum_elems`` on both branches (a dim ≤ 32 with a key for
every step: one hoisted decomposition; a non-power-of-2 dim > 32: hoisted
block windows, then doubling chains over power-of-2 keys), ``mask``,
``replicate_slot0`` (hoisted, and the doubling fallback), the elementwise
ops, ``BatchedMatrix`` diag×col and col×colᵀ through a lazy transpose, and
``Matrix`` matmul, transposed operands and ``matmul_pow``
(test_torch_linalg_bfv.py holds ``Matrix`` over BFV).  The constructors
encrypt by themselves, so both packages draw the same fresh seeds
(``fixed_seeds``).
"""

import numpy as np
import pytest

from hetpu.linalg import BatchedMatrix as RefBatchedMatrix
from hetpu.linalg import BatchedVector as RefBatchedVector
from hetpu.linalg import Matrix as RefMatrix
from hetpu.session import Session as RefSession
from hetpu_torch.linalg import BatchedMatrix, BatchedVector, Matrix
from hetpu_torch.session import Session
from torch_app_cases import assert_same, encrypt_pair, fixed_seeds

SEED = b"\x02" * 32
# every step 1..7 (hoisted sums and 4×4 / 8×8 matmuls), the power-of-2
# chain to 32 (the doubling branch), right-rotations 1..4 (replicate_slot0)
STEPS = [1, 2, 3, 4, 5, 6, 7, 8, 16, 32, -1, -2, -3, -4]


@pytest.fixture(scope="module")
def env():
    ref = RefSession.create("test_tiny", seed=SEED, galois_steps=STEPS)
    port = Session.create("test_tiny", seed=SEED, galois_steps=STEPS,
                          device="cpu")
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, port.slots)
    y = rng.uniform(-1, 1, port.slots)
    return ref, port, x, y, encrypt_pair(ref, x, b"\x61" * 32), \
        encrypt_pair(ref, y, b"\x62" * 32)


def _vectors(env, dim):
    ref, port, x, y, (rx, px), (ry, py) = env
    return (RefBatchedVector(ref, rx, dim), RefBatchedVector(ref, ry, dim),
            BatchedVector(port, px, dim), BatchedVector(port, py, dim))


@pytest.mark.parametrize("dim,branch", [(10, "hoisted"), (32, "hoisted"),
                                        (40, "doubling"), (48, "doubling"),
                                        (1, "identity")])
def test_sum_elems(env, dim, branch):
    """dim ≤ 32 with keys for 1..dim-1: one hoisted decomposition; a
    non-power-of-2 dim > 32: the block windows hoisted, then a doubling
    chain over the power-of-2 keys.  Slot 0 holds the sum of the first dim
    slots."""
    rv, _, pv, _ = _vectors(env, dim)
    if branch == "hoisted":
        assert dim <= pv._HOIST_DIM
    got, want = pv.sum_elems(), rv.sum_elems()
    assert got.dim == want.dim == 1
    assert_same(got.ct, want.ct)
    x = env[2]
    np.testing.assert_allclose(got.decrypt().real[0], x[:dim].sum(),
                               atol=1e-3)


def test_sum_elems_without_every_step_key(env):
    """dim 12 ≤ 32 lacks keys 9..11, so it takes the doubling branch."""
    rv, _, pv, _ = _vectors(env, 12)
    got = pv.sum_elems()
    assert_same(got.ct, rv.sum_elems().ct)
    np.testing.assert_allclose(got.decrypt().real[0], env[2][:12].sum(),
                               atol=1e-3)


@pytest.mark.parametrize("out_dim", [4, 6])
def test_mask_and_replicate_slot0(env, out_dim):
    """out_dim 4: hoisted right-rotations 1..3; out_dim 6 lacks -5, so it
    doubles over -1, -2, -4."""
    rv, _, pv, _ = _vectors(env, 8)
    got, want = pv.mask([0, 3]), rv.mask([0, 3])
    assert_same(got.ct, want.ct)
    x = env[2]
    np.testing.assert_allclose(got.decrypt().real[[0, 1, 3]],
                               [x[0], 0, x[3]], atol=1e-3)
    got, want = pv.replicate_slot0(out_dim), rv.replicate_slot0(out_dim)
    assert got.dim == want.dim == out_dim
    assert_same(got.ct, want.ct)
    np.testing.assert_allclose(got.decrypt().real[:4], [x[0]] * 4, atol=1e-3)


VEC_OPS = {
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b,
    "neg": lambda a, b: -a, "mul": lambda a, b: a * b,
    "add_scalar": lambda a, b: a + 0.5, "mul_scalar": lambda a, b: a * 2.5,
    "square": lambda a, b: a.square(), "rotate": lambda a, b: a << 3,
    "rotate_right": lambda a, b: a >> 2,
}


@pytest.mark.parametrize("op", list(VEC_OPS))
def test_batched_vector_ops(env, op):
    rx, ry, px, py = _vectors(env, 16)
    assert_same(VEC_OPS[op](px, py).ct, VEC_OPS[op](rx, ry).ct)


@pytest.fixture(scope="module")
def mats(env):
    ref, port = env[0], env[1]
    rng = np.random.default_rng(8)
    a, b = rng.uniform(-1, 1, (2, 8, 8))
    out = {}
    for name, pkg, s in (("ref", RefBatchedMatrix, ref),
                         ("port", BatchedMatrix, port)):
        with fixed_seeds("batched"):
            out[name] = (pkg.encrypt(s, a, "diag"), pkg.encrypt(s, b, "col"),
                         pkg.encrypt(s, a, "col"))
    return a, b, out


def test_batched_matrix_encrypt(mats):
    """The ×2 slot tiling and the diagonal layout: same ciphertexts."""
    a, b, m = mats
    for got, want in zip(m["port"], m["ref"]):
        assert (got.rows, got.cols, got.layout) == (want.rows, want.cols,
                                                    want.layout)
        assert_same(got.ct, want.ct)
    np.testing.assert_allclose(m["port"][0].decrypt().real, a, atol=1e-4)
    np.testing.assert_allclose(m["port"][1].transp().decrypt().real, b.T,
                               atol=1e-4)


def test_batched_matmul_diag_col(mats):
    a, b, m = mats
    got = m["port"][0].matmul(m["port"][1])
    want = m["ref"][0].matmul(m["ref"][1])
    assert (got.layout, got.rows, got.cols) == ("col", 8, 8)
    assert_same(got.ct, want.ct)
    np.testing.assert_allclose(got.decrypt().real, a @ b, atol=1e-3)


def test_batched_matmul_cols_t(mats):
    """col × (col, transposed): A·Bᵀ in diag layout, B never moved."""
    a, b, m = mats
    bt = m["port"][1].transp()
    assert bt.transposed and bt.ct is m["port"][1].ct
    got = m["port"][2].matmul(bt)
    want = m["ref"][2].matmul(m["ref"][1].transp())
    assert got.layout == "diag"
    assert_same(got.ct, want.ct)
    np.testing.assert_allclose(got.decrypt().real, a @ b.T, atol=1e-3)


def test_batched_matrix_elementwise_and_refusals(mats):
    a, b, m = mats
    pa, pb, pc = m["port"]
    ra, rb, rc = m["ref"]
    assert_same((pb + pc).ct, (rb + rc).ct)
    assert_same((pb - pc).ct, (rb - rc).ct)
    assert_same(pb.hadamard(pc).ct, rb.hadamard(rc).ct)
    assert_same(pb.square_elems().ct, rb.square_elems().ct)
    with pytest.raises(ValueError):
        pa + pb                                # layouts differ
    with pytest.raises(ValueError):
        pa.transp().matmul(pb)                 # left operand transposed
    with pytest.raises(ValueError):
        pc.matmul(pb)                          # col×col needs Bᵀ


@pytest.fixture(scope="module")
def cmats(env):
    ref, port = env[0], env[1]
    rng = np.random.default_rng(12)
    a = rng.uniform(-1, 1, (2, 3))
    b = rng.uniform(-1, 1, (3, 2))
    s = rng.uniform(-0.9, 0.9, (2, 2))
    out = {}
    for name, pkg, sess in (("ref", RefMatrix, ref), ("port", Matrix, port)):
        with fixed_seeds("matrix"):
            out[name] = (pkg.encrypt(sess, a), pkg.encrypt(sess, b),
                         pkg.encrypt(sess, s))
    return a, b, s, out


MATRIX_OPS = {
    "matmul": (lambda a, b, s: a.matmul(b), lambda a, b, s: a @ b),
    "matmul_transposed": (lambda a, b, s: b.transp().matmul(a.transp()),
                          lambda a, b, s: b.T @ a.T),
    "left_matmul_with_transp": (lambda a, b, s: a.left_matmul_with_transp(),
                                lambda a, b, s: a.T @ a),
    "matmul_pow3": (lambda a, b, s: s.matmul_pow(3),
                    lambda a, b, s: s @ s @ s),
    "add_transposed": (lambda a, b, s: a + b.transp(),
                       lambda a, b, s: a + b.T),
    "sub_transposed": (lambda a, b, s: a.transp() - b,
                       lambda a, b, s: a.T - b),
    "hadamard": (lambda a, b, s: a.hadamard(b.transp()),
                 lambda a, b, s: a * b.T),
    "neg": (lambda a, b, s: -a.transp(), lambda a, b, s: -a.T),
}


@pytest.mark.parametrize("op", list(MATRIX_OPS))
def test_matrix_ckks(cmats, op):
    a, b, s, m = cmats
    fn, expect = MATRIX_OPS[op]
    got, want = fn(*m["port"]), fn(*m["ref"])
    assert got.get_dims() == want.get_dims()
    assert got.transposed == want.transposed
    assert_same(got.ct, want.ct)
    np.testing.assert_allclose(got.decrypt().real, expect(a, b, s), atol=1e-3)


def test_matrix_slot_batched(env):
    """Each element slot-batched: four independent 2×2 products at once,
    ``decrypt_batch`` returns all of them."""
    ref, port = env[0], env[1]
    rng = np.random.default_rng(13)
    a, b = rng.uniform(-1, 1, (2, 2, 2, 4))
    outs = []
    for pkg, sess in ((RefMatrix, ref), (Matrix, port)):
        with fixed_seeds("slot_batched"):
            outs.append(pkg.encrypt(sess, a).matmul(pkg.encrypt(sess, b)))
    assert_same(outs[1].ct, outs[0].ct)
    np.testing.assert_allclose(outs[1].decrypt_batch(4).real,
                               np.einsum("ikb,kjb->ijb", a, b), atol=1e-3)
