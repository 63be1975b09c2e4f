"""The streamed hoisted rotation and the diagonal method's loop over it, on
the CPU at test_tiny (8×8 matrices, keys for steps 1..7):

  * ``Evaluator.rotate_hoisted_iter`` decomposes once and yields, step by
    step, the ciphertexts of the former list construction (one
    ``_decompose``, then per step the gathers of c0 and of the digits,
    the inner product with the mod-down, and (c0 + p0, p1)), bit for bit;
    ``rotate_hoisted`` is its list;
  * ``BatchedMatrix`` diag×col and col×colᵀ give, bit for bit, the former
    form: every rotation held, every product held, one balanced tree of
    modular sums, then relinearize and rescale (hetpu's bits are held by
    ``test_torch_linalg.py``);
  * the loops hold one step's rotation at a time, and no earlier product:
    weak references to what the wrapped generator yielded and to what
    ``multiply`` returned; diag×col adds each step into one sum in place
    (``multiply_acc``);
  * under ``torch.profiler`` each step opens ``hetpu/rot.step`` (closed
    before the caller's multiply), each gather ``hetpu/rot.galois`` inside
    it, each multiply-and-add ``hetpu/mm.accumulate``; and
    ``galois.gather_bytes`` counts every gathered plane read and written
    once, only while a profiler records.
"""

import weakref

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hetpu_torch.core import cuda_lib, galois
from hetpu_torch.core.ciphertext import Ciphertext
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import mod_add
from hetpu_torch.linalg import BatchedMatrix
from hetpu_torch.linalg.batched import _tree_mod_add
from hetpu_torch.session import Session

torch.set_num_threads(1)

D = 8
SEED = b"\x5b" * 32


@pytest.fixture(scope="module")
def env():
    sess = Session.create("test_tiny", seed=SEED,
                          galois_steps=list(range(1, D)), device="cpu")
    rng = np.random.default_rng(25)
    a, b, c = (rng.uniform(-1, 1, (D, D)) for _ in range(3))
    return (sess, BatchedMatrix.encrypt(sess, a, layout="diag"),
            BatchedMatrix.encrypt(sess, b, layout="col"),
            BatchedMatrix.encrypt(sess, c, layout="col"))


def _former_rotations(ev, ct, steps, gk):
    """The list construction of hoisted rotations as it stood before the
    stream: one decomposition, then every step's rotation."""
    n = ev.ctx.params.poly_degree
    q = ev.ctx.mont(ct.level)["q"]
    ext = ev._decompose(ct.data[..., 1, :, :], ct.level)
    outs = []
    for s in steps:
        if s % (n // 2) == 0:
            outs.append(ct)
            continue
        elt = galois.rotation_elt(n, s)
        c0 = galois.apply(ct.data[..., 0, :, :], n, elt)
        p0, p1 = ev._inner_product(galois.apply(ext, n, elt), ct.level,
                                   gk.key_for(elt))
        outs.append(ct.with_(data=torch.stack([mod_add(c0, p0, q), p1],
                                              dim=-3)))
    return outs


def _same(got, want):
    assert (got.level, got.scale) == (want.level, want.scale)
    assert torch.equal(got.data, want.data)


def test_stream_yields_the_former_list_bit_for_bit(env, monkeypatch):
    sess, _, mb, _ = env
    ev, ct = sess.ev, mb.ct
    steps = [0, 1, 3, 7, 512, 5, 2]            # 512: a whole turn of slots
    calls = []
    real = Evaluator._decompose
    monkeypatch.setattr(Evaluator, "_decompose",
                        lambda self, d, lvl: calls.append(lvl)
                        or real(self, d, lvl))
    stream = ev.rotate_hoisted_iter(ct, steps, sess.gk)
    assert calls == []                          # nothing runs until asked
    got = list(stream)
    assert calls == [ct.level]
    want = _former_rotations(ev, ct, steps, sess.gk)
    for g, w in zip(got, want, strict=True):
        _same(g, w)
    assert got[0] is ct and got[4] is ct
    for g, w in zip(ev.rotate_hoisted(ct, steps, sess.gk), want,
                    strict=True):
        _same(g, w)


def test_stream_refuses_a_three_part_ciphertext(env):
    sess, _, mb, _ = env
    ct3 = sess.ev.multiply(mb.ct, mb.ct)
    with pytest.raises(ValueError, match="2-part"):
        sess.ev.rotate_hoisted(ct3, [1], sess.gk)
    with pytest.raises(ValueError, match="2-part"):
        next(sess.ev.rotate_hoisted_iter(ct3, [1], sess.gk))


def _former_diag_col(sess, ma, mb):
    ev, a, b = sess.ev, ma.ct, mb.ct
    q = sess.ctx.mont(a.level)["q"]
    rots = _former_rotations(ev, b, list(range(D)), sess.gk)
    prods = [ev.multiply(rots[k], a.with_(data=a.data[k])).data
             for k in range(D)]
    c3 = Ciphertext(data=_tree_mod_add(prods, q), level=a.level,
                    scale=a.scale * b.scale)
    return ev.rescale(ev.relinearize(c3, sess.rk))


def _former_cols_t(sess, mc, mb):
    ev, a, b = sess.ev, mc.ct, mb.ct
    q = sess.ctx.mont(a.level)["q"]
    rots = _former_rotations(ev, b, list(range(D)), sess.gk)
    outs = []
    for i in range(D):
        prod3 = ev.multiply(rots[i], a)
        outs.append(_tree_mod_add([prod3.data[j] for j in range(D)], q))
    c3 = Ciphertext(data=torch.stack(outs), level=a.level,
                    scale=a.scale * b.scale)
    return ev.rescale(ev.relinearize(c3, sess.rk))


@pytest.mark.parametrize("form", ["diag_col", "cols_t"])
def test_streamed_products_equal_the_former_form(env, form):
    sess, ma, mb, mc = env
    if form == "diag_col":
        got, want = ma.matmul(mb), _former_diag_col(sess, ma, mb)
        assert (got.layout, got.rows, got.cols) == ("col", D, D)
    else:
        got, want = mc.matmul(mb.transp()), _former_cols_t(sess, mc, mb)
        assert got.layout == "diag"
    _same(got.ct, want)


@pytest.mark.parametrize("form", ["diag_col", "cols_t"])
def test_the_loop_holds_one_rotation_and_product(env, monkeypatch, form):
    """Each time the generator yields a new rotation, no rotation it
    yielded before is alive; col×colᵀ holds no earlier product when it
    makes one, and diag×col makes none: each step adds into one running
    sum in place (``multiply_acc``, the same tensor every step)."""
    sess, ma, mb, mc = env
    rots, prods, sums = [], [], []
    peak = {"rotations": 0, "products": 0}
    stream, mul = Evaluator.rotate_hoisted_iter, Evaluator.multiply
    mul_acc = Evaluator.multiply_acc

    def alive(refs):
        return sum(1 for r in refs if r() is not None)

    def tracked(self, ct, steps, gk):
        for r in stream(self, ct, steps, gk):
            peak["rotations"] = max(peak["rotations"], alive(rots))
            if r is not ct:
                rots.append(weakref.ref(r.data))
            yield r

    def counted(self, x, y):
        out = mul(self, x, y)
        peak["products"] = max(peak["products"], alive(prods))
        prods.append(weakref.ref(out.data))
        return out

    def accumulated(self, acc, x, y):
        out = mul_acc(self, acc, x, y)
        assert acc is None or out.data is acc.data
        sums.append(out.data.data_ptr())
        return out

    monkeypatch.setattr(Evaluator, "rotate_hoisted_iter", tracked)
    monkeypatch.setattr(Evaluator, "multiply", counted)
    monkeypatch.setattr(Evaluator, "multiply_acc", accumulated)
    if form == "diag_col":
        ma.matmul(mb)
    else:
        mc.matmul(mb.transp())
    assert len(rots) == D - 1
    assert (len(prods), len(sums)) == ((0, D) if form == "diag_col"
                                       else (D, 0))
    assert len(set(sums)) <= 1
    assert peak == {"rotations": 0, "products": 0}


def _host_spans(prof, name):
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events() if e.name == name)


def test_rotation_spans_and_gather_bytes(env):
    sess, ma, mb, _ = env
    cuda_lib.reset_launches()
    ma.matmul(mb)
    assert galois.gather_bytes == {"apply": 0}   # no profiler, no count
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        plain = ma.matmul(mb)
    steps = _host_spans(prof, "hetpu/rot.step")
    gathers = _host_spans(prof, "hetpu/rot.galois")
    accs = _host_spans(prof, "hetpu/mm.accumulate")
    tensors = _host_spans(prof, "hetpu/mul.tensor")
    assert (len(steps), len(gathers), len(accs)) == (D - 1, 2 * (D - 1), D)
    inside = lambda s, spans: any(a <= s[0] and s[1] <= b for a, b in spans)
    assert all(inside(g, steps) for g in gathers)
    assert all(inside(t, accs) and not inside(t, steps) for t in tensors)
    level = mb.ct.level
    plan = sess.ctx.keyswitch_plan(level)
    J, R = plan.num_digits, len(plan.basis_tables.primes)
    planes = D * (level + 1) + D * J * R            # c0 and the digits
    n = sess.ctx.params.poly_degree
    assert galois.gather_bytes["apply"] == (D - 1) * 2 * planes * n * 4
    _same(plain.ct, ma.matmul(mb).ct)
    cuda_lib.reset_launches()
    assert galois.gather_bytes == {"apply": 0}
