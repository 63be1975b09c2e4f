"""Matrix-operation demos (reference ``src/demos/matrix_operations.cpp``).

Counterpart of ``hetpu/demos/matrix_operations.py``: the same nine demos,
presets, seeds, inputs and printed lines, on ``device``.  Dispatch parity
(reference :1191-1199): op, elemwise_square, matmul, batch_matmul_bfv,
batch_matmul_ckks, matpow, sum_elems, least_squares_2d,
batched_matmul_ckks.  The BFV demos (elemwise_square, matmul,
batch_matmul_bfv, matpow) run the exact-integer path with noise-budget
probes, like the reference.  ``small`` shrinks parameters for quick runs.
"""

from __future__ import annotations

import numpy as np

from ..bfv import BfvSession
from ..linalg import BatchedMatrix, BatchedVector, Matrix
from ..models.least_squares import least_squares_2d
from ..utils.keycache import cached_session
from ..utils.timer import Timer


def _sess(preset, small, steps, device):
    t = Timer()
    # disk key cache: repeat demo runs skip the deep-chain keygen (fixed
    # demo seed: these are demos, not production keys)
    s = cached_session("test_deep" if small else preset,
                       seed=b"\x77" * 32, galois_steps=steps, device=device)
    t.toc("keygen+context time", block_on=s.rk)
    return s


def _bfv_sess(preset, small, small_preset, device):
    t = Timer()
    s = BfvSession.create(small_preset if small else preset,
                          galois_steps=[1], device=device)
    t.toc("keygen+context time", block_on=s.rk)
    return s


def demo_op(small=False, device="cuda"):
    """Single complex multiply (reference :58-138, CKKS N=2^13)."""
    sess = _sess("ckks_small", small, [1], device)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, sess.slots) + 1j * rng.uniform(-1, 1, sess.slots)
    y = rng.uniform(-1, 1, sess.slots) + 1j * rng.uniform(-1, 1, sess.slots)
    t = Timer()
    out = sess.ev.multiply_relin_rescale(sess.encrypt(x), sess.encrypt(y),
                                         sess.rk)
    t.toc("HE complex multiply time", block_on=out.data)
    got = sess.decrypt(out)[:4]
    print("op1*op2 =", got, "\nexpected =", (x * y)[:4])


def demo_elemwise_square(small=False, device="cuda"):
    """Elementwise square: BFV with noise-budget probes (reference
    :140-209: BatchEncoder slots, invariant_noise_budget before/after)."""
    sess = _bfv_sess("bfv_small", small, "test_bfv_tiny", device)
    t_mod = sess.ctx.params.plain_modulus
    rng = np.random.default_rng(0)
    v = rng.integers(0, 1 << 9, sess.slots, dtype=np.int64)
    ct = sess.encrypt(v)
    print("noise budget fresh:", sess.noise_budget(ct), "bits")
    t = Timer()
    sq = sess.square_relin(ct)
    t.toc("HE square time", block_on=sq.data)
    print("noise budget after square:", sess.noise_budget(sq), "bits")
    got = sess.decrypt(sq)
    want = (v.astype(object) ** 2) % t_mod
    print("exact:", bool(np.array_equal(got, want)), "| x^2[:4] =", got[:4])


def demo_matmul(small=False, device="cuda"):
    """Element-per-ct matmul + pow: BFV transp + A^5 (reference :211-349:
    t = 2^32 coefficient encoding, binary square-and-multiply)."""
    sess = _bfv_sess("bfv_matpow", small, "test_bfv_pow", device)
    t_mod = sess.ctx.params.plain_modulus
    rng = np.random.default_rng(0)
    a = rng.integers(0, 6, (2, 2), dtype=np.int64)
    ma = Matrix.encrypt(sess, a).transp().transp()    # lazy transp parity
    print("noise budget fresh:",
          sess.noise_budget(ma.ct.with_(data=ma.ct.data[0])), "bits")
    t = Timer()
    out = ma.matmul_pow(5)
    t.toc("HE (no batch) matrix multiplication time", block_on=out.ct.data)
    print("noise budget after A^5:",
          sess.noise_budget(out.ct.with_(data=out.ct.data[0])), "bits")
    got = out.decrypt_exact()
    want = np.linalg.matrix_power(a.astype(object), 5) % t_mod
    print("A^5 exact:", bool(np.array_equal(got, want)), "\n", got)


def demo_batch_matmul_ckks(small=False, device="cuda"):
    """5×5 × slot_count independent matmuls (reference :495-629)."""
    sess = _sess("ckks_small", small, [1], device)
    rng = np.random.default_rng(0)
    batch = sess.slots
    a = rng.uniform(-1, 1, (5, 5, batch))
    b = rng.uniform(-1, 1, (5, 5, batch))
    ma, mb = Matrix.encrypt(sess, a), Matrix.encrypt(sess, b)
    t = Timer()
    out = ma.matmul(mb)
    t.toc("HE matrix multiplication time", block_on=out.ct.data)
    got = out.decrypt_batch(batch).real
    want = np.einsum("ikb,kjb->ijb", a, b)
    print(f"batch={batch} max err =", np.abs(got - want).max())


def demo_batch_matmul_bfv(small=False, device="cuda"):
    """5×5 × slot_count independent integer matmuls: BFV with the 60-bit
    CRT batching plain modulus (reference :351-493,
    ``PlainModulus::Batching(poly, 60)`` :360-361)."""
    sess = _bfv_sess("bfv_batch", small, "test_bfv_crt", device)
    t_mod = sess.ctx.params.plain_modulus
    print(f"plain modulus t = {t_mod} ({t_mod.bit_length()} bits, "
          f"factors {sess.ctx.params.plain_factors or (t_mod,)})")
    rng = np.random.default_rng(0)
    d = 2 if small else 5
    batch = sess.slots
    A = rng.integers(0, 1 << 10, (d, d, batch), dtype=np.int64)
    B = rng.integers(0, 1 << 10, (d, d, batch), dtype=np.int64)
    ma, mb = Matrix.encrypt(sess, A), Matrix.encrypt(sess, B)
    print("noise budget fresh:",
          sess.noise_budget(ma.ct.with_(data=ma.ct.data[0])), "bits")
    t = Timer()
    out = ma.matmul(mb)
    t.toc("HE matrix multiplication time", block_on=out.ct.data)
    print("noise budget after matmul:",
          sess.noise_budget(out.ct.with_(data=out.ct.data[0])), "bits")
    got = out.decrypt_exact(batch)
    want = np.einsum("ikb,kjb->ijb", A.astype(object), B.astype(object)) % t_mod
    print(f"batch={batch} exact:", bool(np.array_equal(got, want)))


def demo_matpow(small=False, device="cuda"):
    """A^5 binary exponentiation: BFV t = 2^32 (reference :631-743: one
    ct per element, noise budgets through the chain)."""
    sess = _bfv_sess("bfv_matpow", small, "test_bfv_pow", device)
    t_mod = sess.ctx.params.plain_modulus
    rng = np.random.default_rng(0)
    a = rng.integers(0, 6, (2, 2), dtype=np.int64)
    ma = Matrix.encrypt(sess, a)
    print("noise budget fresh:",
          sess.noise_budget(ma.ct.with_(data=ma.ct.data[0])), "bits")
    t = Timer()
    out = ma.matmul_pow(5)
    t.toc("HE matrix power time", block_on=out.ct.data)
    print("noise budget after A^5:",
          sess.noise_budget(out.ct.with_(data=out.ct.data[0])), "bits")
    got = out.decrypt_exact()
    want = np.linalg.matrix_power(a.astype(object), 5) % t_mod
    print("A^5 exact:", bool(np.array_equal(got, want)), "\n", got)


def demo_sum_elems(small=False, device="cuda"):
    """dim=10 non-power-of-2 reduction (reference :745-831)."""
    sess = _sess("ckks_small", small, [1, 2, 4, 8], device)
    rng = np.random.default_rng(0)
    dim = 10
    x = np.zeros(sess.slots)
    x[:dim] = rng.uniform(-1, 1, dim)
    bv = BatchedVector(sess, sess.encrypt(x), dim)
    t = Timer()
    out = bv.sum_elems()
    t.toc("HE sum_elems time", block_on=out.ct.data)
    print("sum =", out.decrypt().real[0], "expected =", x.sum())


def demo_least_squares_2d(small=False, device="cuda"):
    """THE flagship pipeline (reference :833-1040, SURVEY §3.1)."""
    # the reference runs this at scale 2^40 (matrix_operations.cpp:845-852);
    # ckks_deep_hi is the pair-rescale scale-2^55 preset: depth 11 is
    # exactly the pipeline's consumption at inv_iters=6
    sess = _sess("ckks_deep_hi", small, [1, 2, 4], device)
    rng = np.random.default_rng(0)
    n = 5
    x = rng.uniform(0.5, 2.0, n)
    y = 0.7 * x + 0.3 + rng.normal(0, 0.02, n)
    px, py = np.zeros(sess.slots), np.zeros(sess.slots)
    px[:n], py[:n] = x, y
    sx, sxx = x.sum(), (x * x).sum()
    D = n * sxx - sx * sx
    t = Timer()
    ct_a, ct_b = least_squares_2d(sess, sess.encrypt(px), sess.encrypt(py),
                                  n, inv_guess=1.0 / D,
                                  inv_iters=4 if small else 6)
    t.toc("HE least squares time", block_on=(ct_a.data, ct_b.data))
    a, b = sess.decrypt(ct_a).real[0], sess.decrypt(ct_b).real[0]
    sy, sxy = y.sum(), (x * y).sum()
    ea, eb = (n * sxy - sx * sy) / D, (sxx * sy - sx * sxy) / D
    print(f"fit: a={a:.6f} b={b:.6f}")
    print(f"expected: a={ea:.6f} b={eb:.6f}")
    err = max(abs(a - ea), abs(b - eb))
    print(f"max err = {err:.3e}")
    if not small:
        assert err < 2 ** -10, f"least-squares error {err} above 2^-10"


def demo_batched_matmul_ckks(small=False, device="cuda"):
    """64×64 diagonal-method matmul (reference :1042-1175): the rotation
    hot loop, with hoisted decomposition."""
    d = 8 if small else 64
    # full size runs the scale-2^44 high-precision pair-rescale preset
    # (above the reference's 2^40 working precision, matrix_operations.cpp:845)
    sess = _sess("ckks_hi", small, list(range(1, d)), device)
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (d, d))
    b = rng.uniform(-1, 1, (d, d))
    ma = BatchedMatrix.encrypt(sess, a, layout="diag")
    mb = BatchedMatrix.encrypt(sess, b, layout="col")
    t = Timer()
    out = ma.matmul(mb)
    t.toc("HE matrix multiplication time", block_on=out.ct.data)
    err = np.abs(out.decrypt().real - a @ b).max()
    print(f"{d}x{d} max err =", err)
    if not small:
        assert err < 2 ** -10, f"batched matmul error {err} above 2^-10"


DEMOS = {
    "op": demo_op,
    "elemwise_square": demo_elemwise_square,
    "matmul": demo_matmul,
    "batch_matmul_bfv": demo_batch_matmul_bfv,
    "batch_matmul_ckks": demo_batch_matmul_ckks,
    "matpow": demo_matpow,
    "sum_elems": demo_sum_elems,
    "least_squares_2d": demo_least_squares_2d,
    "batched_matmul_ckks": demo_batched_matmul_ckks,
}
