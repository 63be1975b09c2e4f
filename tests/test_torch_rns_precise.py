"""The precise (two-float) α of hetpu_torch against hetpu's, as hetpu's BFV
runs it — eagerly, outside ``jax.jit``, each f32 op rounding on its own:

  * ``twofloat.two_prod`` / ``two_sum`` / ``ds_add`` / ``ds_round`` on
    random float32 pairs and on halves;
  * the ``FbcPlan`` fields, the two-float ones included;
  * ``rns._alpha_precise`` and ``fbc_apply(precise=True)`` on random
    columns of BFV's conversions (test_bfv_crt: Q → B, B → Q, Q → G) and on
    the adversarial near-half-integer columns of tests/test_rns.py, where
    both must also equal the exact big-integer conversion;
  * the constants each ``FbcPlan`` packs for kernel ``fbc_precise`` (K9):
    word for word the plan's fields, packed anew by ``dataclasses.replace``, and, read by a numpy model of the
    kernel's arithmetic (its Shoup products, its chunked 64-bit sums and
    its float32 α, op by op), the plain conversion's bits.  The kernel
    itself runs only on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import nt as ref_nt
from hetpu.core import rns as ref_rns
from hetpu.core import twofloat as ref_tf
from hetpu.core.bfv import BfvScheme as RefBfvScheme
from hetpu.core.context import Context as RefContext
from hetpu.core.params import preset as ref_preset
from hetpu_torch.core import cuda_lib, rns, twofloat
from hetpu_torch.core.modular import from_u32, to_u32
from test_rns import _craft_near_half, _digits_to_input, _expected

torch.set_num_threads(1)


def _f32(rng, n, scale):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _eq_f32(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twofloat_equal():
    rng = np.random.default_rng(5)
    a, b = _f32(rng, 4096, 1e4), _f32(rng, 4096, 1e-5)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.0, 1e7 + 0.5],
                      dtype=np.float32)
    tiny = np.array([1e-9, -1e-9, 0.0, 2e-8, -3e-8, 0.0, 1e-12],
                    dtype=np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, want in zip(twofloat.two_prod(ta, tb), ref_tf.two_prod(ja, jb),
                         strict=True):
        _eq_f32(got, want)
    for got, want in zip(twofloat.two_sum(ta, tb), ref_tf.two_sum(ja, jb),
                         strict=True):
        _eq_f32(got, want)
    p, e = twofloat.two_prod(ta, tb)
    rp, re = ref_tf.two_prod(ja, jb)
    for got, want in zip(twofloat.ds_add(ta, tb * 1e-8, p, e),
                         ref_tf.ds_add(ja, jb * np.float32(1e-8), rp, re),
                         strict=True):
        _eq_f32(got, want)
    _eq_f32(twofloat.ds_round(torch.from_numpy(halves), torch.from_numpy(tiny)),
            ref_tf.ds_round(jnp.asarray(halves), jnp.asarray(tiny)))
    _eq_f32(twofloat.ds_round(ta, tb), ref_tf.ds_round(ja, jb))


@pytest.fixture(scope="module")
def bfv_plans():
    """BFV's three conversions at test_bfv_crt's top level, both packages."""
    ref = RefBfvScheme(RefContext(ref_preset("test_bfv_crt")))
    lvl = ref._lvl(ref.ctx.num_data - 1)
    Q = list(ref.ctx.params.moduli)
    out = {}
    for name, src, dst in (("q_to_b", Q, lvl["B_primes"]),
                           ("b_to_q", lvl["B_primes"], Q),
                           ("q_to_g", Q, lvl["G_primes"])):
        out[name] = (src, ref_rns.make_fbc(src, dst),
                     rns.make_fbc(src, dst, "cpu"))
    return out


@pytest.mark.parametrize("name", ["q_to_b", "b_to_q", "q_to_g"])
def test_fbc_plan_fields_equal(bfv_plans, name):
    _, want, got = bfv_plans[name]
    # kernel_consts: K9's table, the port's own (packed from the rest)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)] + ["kernel_consts"]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        if g.dtype == torch.float32:        # p_recip and the two-float split
            np.testing.assert_array_equal(g.numpy(), w.astype(np.float32),
                                          err_msg=f.name)
        else:
            np.testing.assert_array_equal(to_u32(g), w, err_msg=f.name)


@pytest.mark.parametrize("name", ["q_to_b", "b_to_q", "q_to_g"])
def test_alpha_precise_random(bfv_plans, name):
    """Random residues, batched [2, 2, L, N]: α, and the conversion with
    and without the premultiply."""
    src, want_plan, plan = bfv_plans[name]
    rng = np.random.default_rng(len(name))
    q = np.array(src, dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, (2, 2, len(src), 512), dtype=np.uint64)
         % q).astype(np.uint32)
    np.testing.assert_array_equal(
        to_u32(rns._alpha_precise(from_u32(x), plan).to(torch.int32)),
        np.asarray(ref_rns._alpha_precise(jnp.asarray(x), want_plan))
        .astype(np.uint32))
    for premul in (True, False):
        got = rns.fbc_apply(from_u32(x), plan, precise=True, premul=premul)
        want = ref_rns.fbc_apply(jnp.asarray(x), want_plan, precise=True,
                                 premul=premul)
        np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.fixture(scope="module")
def bases():
    src = ref_nt.gen_primes(30, 6, 2 * 64)
    dst = [p for p in ref_nt.gen_primes(29, 8, 2 * 64) if p not in src][:4]
    return src, dst


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_precise_near_half(bases, seed):
    """tests/test_rns.py's adversarial columns: Σ y_i/p_i within ~2^-29 of
    a half-integer.  The port equals hetpu and the exact conversion."""
    src, dst = bases
    plan = rns.make_fbc(src, dst, "cpu")
    want_plan = ref_rns.make_fbc(src, dst)
    cols = _craft_near_half(src, seed=seed, want=16)
    x = np.concatenate([np.asarray(_digits_to_input(y, src, 1))
                        for y in cols], axis=1)
    got = to_u32(rns.fbc_apply(from_u32(x), plan, correct=True,
                               precise=True))
    ref = np.asarray(ref_rns.fbc_apply(jnp.asarray(x), want_plan,
                                       correct=True, precise=True))
    np.testing.assert_array_equal(got, ref)
    for c, y in enumerate(cols):
        want, _ = _expected(y, src, dst)
        np.testing.assert_array_equal(got[:, c], want, err_msg=f"digits={y}")


def test_precise_random_exact(bases):
    """tests/test_rns.py's random digit vectors: exact conversion."""
    src, dst = bases
    plan = rns.make_fbc(src, dst, "cpu")
    rng = random.Random(3)
    cols = [[rng.randrange(p) for p in src] for _ in range(100)]
    x = np.concatenate([np.asarray(_digits_to_input(y, src, 1))
                        for y in cols], axis=1)
    got = to_u32(rns.fbc_apply(from_u32(x), plan, correct=True, precise=True))
    for c, y in enumerate(cols):
        np.testing.assert_array_equal(got[:, c], _expected(y, src, dst)[0])


# ----------------------------------------------------------------------
# K9 fbc_precise's packed constants (rns.pack_consts)
# ----------------------------------------------------------------------

def _k9_words(plan):
    """The plan's K9 words split as the kernel stages them: phat [S, F],
    per target [F, 5], per source [S, 7], the chunk."""
    S, F = plan.p.shape[0], plan.r.shape[0]
    w = to_u32(plan.kernel_consts).astype(np.uint64)
    assert w.shape == (S * F + 5 * F + 7 * S + 1,)
    return (w[:S * F].reshape(S, F), w[S * F:S * F + 5 * F].reshape(F, 5),
            w[S * F + 5 * F:-1].reshape(S, 7), int(w[-1]))


@pytest.mark.parametrize("name", ["q_to_b", "b_to_q", "q_to_g"])
def test_kernel_consts_match_plan_fields(bfv_plans, name):
    """Word for word: (P/p_i) mod r_f; per target r_f, the Shoup pairs of 1
    and of 2^32 mod r_f (the split of a 64-bit sum into its words), P mod
    r_f; per source p_i, (P/p_i)⁻¹ mod p_i and its Shoup companion, the
    float32 bits of the two-float 2^16/p_i and 1/p_i; the chunk."""
    _, _, plan = bfv_plans[name]
    phat, per_f, per_s, chunk = _k9_words(plan)
    col = lambda t: to_u32(t).astype(np.uint64)[:, 0]
    bits = lambda t: t.numpy().view(np.uint32).astype(np.uint64)[:, 0]
    r = col(plan.r)
    np.testing.assert_array_equal(phat, to_u32(plan.phat_mod_r))
    np.testing.assert_array_equal(per_f[:, 0], r)
    np.testing.assert_array_equal(per_f[:, 1], (1 << 32) // r)
    np.testing.assert_array_equal(per_f[:, 2], (1 << 32) % r)
    np.testing.assert_array_equal(per_f[:, 3],
                                  (((1 << 32) % r) << np.uint64(32)) // r)
    np.testing.assert_array_equal(per_f[:, 4], col(plan.ptot_mod_r))
    np.testing.assert_array_equal(per_s[:, 0], col(plan.p))
    np.testing.assert_array_equal(per_s[:, 1], col(plan.inv_punit))
    np.testing.assert_array_equal(per_s[:, 2], col(plan.inv_punit_shoup))
    for k, f in enumerate(("r16_hi", "r16_lo", "r0_hi", "r0_lo")):
        np.testing.assert_array_equal(per_s[:, 3 + k],
                                      bits(getattr(plan, f)), err_msg=f)
    assert chunk == rns.fbc_chunk(col(plan.p), r)


def test_kernel_consts_follow_replace(bfv_plans):
    """A plan rebuilt by ``dataclasses.replace`` with its targets cut (as
    parallel/tp.py cuts a mod-down plan per rank) packs its table anew:
    the table make_fbc gives for the cut targets."""
    src, _, plan = bfv_plans["q_to_b"]
    dst = [int(r) for r in to_u32(plan.r)[:, 0]]
    cut = dataclasses.replace(
        plan, phat_mod_r=plan.phat_mod_r[:, 2:5].contiguous(),
        phat_shoup=plan.phat_shoup[:, 2:5].contiguous(),
        ptot_mod_r=plan.ptot_mod_r[2:5], ptot_shoup=plan.ptot_shoup[2:5],
        r=plan.r[2:5])
    assert torch.equal(cut.kernel_consts,
                       rns.make_fbc(src, dst[2:5], "cpu").kernel_consts)
    assert not torch.equal(cut.kernel_consts[:plan.kernel_consts.numel()],
                           plan.kernel_consts[:cut.kernel_consts.numel()])


@pytest.mark.parametrize("bits", [(31, 31), (31, 30), (30, 31), (30, 30)])
def test_fbc_chunk_at_its_limit(bits):
    """The chunk is the most terms of (p − 1)(r − 1) that a reduced value
    below r leaves room for under 2^64: 4 for 31-bit primes on both
    sides, 8 where one side has 30 bits, 16 where both have."""
    src = ref_nt.gen_primes(bits[0], 16, 2048)
    dst = [q for q in ref_nt.gen_primes(bits[1], 32, 2048)
           if q not in src][:16]
    chunk = rns.fbc_chunk(src, dst)
    p, r = max(src), max(dst)
    term = (p - 1) * (r - 1)
    assert (r - 1) + chunk * term < 1 << 64
    assert (r - 1) + (chunk + 1) * term >= 1 << 64
    assert len(src) * r <= term
    assert chunk == {62: 4, 61: 8, 60: 16}[sum(bits)]


def _k9_model(x: np.ndarray, plan) -> np.ndarray:
    """K9's arithmetic from its packed words alone, in numpy: the Shoup
    premultiply as hetpu::shoup_mul, α op by op in float32 in the kernel's
    order, each target's sum of mad.wide terms in uint64 reduced after
    every ``chunk`` terms as reduce64 reduces it, α·(r − P mod r) as the
    last term.  x: uint32 [S, N]."""
    phat, per_f, per_s, chunk = _k9_words(plan)
    m32 = np.uint64(0xFFFFFFFF)
    sh32 = np.uint64(32)

    def shoup(v, w, ws, q):
        qe = (v * ws) >> sh32
        r = (v * w - qe * q) & m32
        return np.minimum(r, (r - q) & m32)

    def split(a):
        t = a * np.float32(4097.0)
        hi = t - (t - a)
        return hi, a - hi

    def product(a, b, b_lo):
        p = a * b
        ah, al = split(a)
        bh, bl = split(b)
        e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
        return p, e + a * b_lo

    def ds_add(hi, lo, p, e):
        s = hi + p
        v = s - hi
        lo = lo + (((hi - (s - v)) + (p - v)) + e)
        return s, lo

    f32 = lambda c: per_s[:, c:c + 1].astype(np.uint32).view(np.float32)
    x = x.astype(np.uint64)
    y = shoup(x, per_s[:, 1:2], per_s[:, 2:3], per_s[:, 0:1])
    hi = np.zeros((1, x.shape[1]), dtype=np.float32)
    lo = np.zeros_like(hi)
    for i in range(y.shape[0]):
        yt = (y[i:i + 1] >> np.uint64(16)).astype(np.float32)
        yb = (y[i:i + 1] & np.uint64(0xFFFF)).astype(np.float32)
        hi, lo = ds_add(hi, lo, *product(yt, f32(3)[i], f32(4)[i]))
        hi, lo = ds_add(hi, lo, *product(yb, f32(5)[i], f32(6)[i]))
    r = np.rint(hi)
    f = hi - r
    up = (((f - np.float32(0.5)) + lo) >= 0).astype(np.float32)
    dn = (((f + np.float32(0.5)) + lo) < 0).astype(np.float32)
    alpha = ((r + up) - dn).astype(np.uint64)
    out = np.empty((per_f.shape[0], x.shape[1]), dtype=np.uint64)
    for j, (q, one_s, r32, r32s, ptot) in enumerate(per_f):
        def reduce64(s):
            return (shoup(s & m32, np.uint64(1), one_s, q)
                    + shoup(s >> sh32, r32, r32s, q)) % q
        acc, left = np.zeros(x.shape[1], dtype=np.uint64), chunk
        for i in range(y.shape[0]):
            acc = acc + y[i] * phat[i, j]
            left -= 1
            if left == 0:
                acc, left = reduce64(acc), chunk
        out[j] = reduce64(acc + alpha[0] * (q - ptot))
    return out.astype(np.uint32)


@pytest.mark.parametrize("name", ["q_to_b", "b_to_q", "q_to_g"])
def test_kernel_consts_drive_the_conversion(bfv_plans, name):
    """The numpy model of K9 reading only ``kernel_consts`` equals
    fbc_apply(precise=True) on uniform residues with each prime's 0 and
    p − 1 in the first columns."""
    src, _, plan = bfv_plans[name]
    q = np.array(src, dtype=np.uint64).reshape(-1, 1)
    x = (np.random.default_rng(len(name) + 7).integers(
        0, 1 << 62, (len(src), 256), dtype=np.uint64) % q)
    x[:, :2] = np.concatenate([0 * q, q - 1], axis=1)
    x = x.astype(np.uint32)
    want = to_u32(rns.fbc_apply(from_u32(x), plan, precise=True))
    np.testing.assert_array_equal(_k9_model(x, plan), want)


@pytest.mark.parametrize("seed", [1, 2])
def test_kernel_consts_drive_the_near_half_columns(bases, seed):
    """The model of K9 on tests/test_rns.py's near-half-integer α columns
    equals the exact conversion, and the 31-bit primes' chunk of 4 (sums
    at their limit) on all-(p − 1) columns."""
    src, dst = bases
    plan = rns.make_fbc(src, dst, "cpu")
    cols = _craft_near_half(src, seed=seed, want=16)
    x = np.concatenate([np.asarray(_digits_to_input(y, src, 1))
                        for y in cols], axis=1)
    got = _k9_model(x, plan)
    for c, y in enumerate(cols):
        np.testing.assert_array_equal(got[:, c], _expected(y, src, dst)[0])
    src31 = ref_nt.gen_primes(31, 16, 2048)
    plan31 = rns.make_fbc(src31[:12], src31[12:], "cpu")
    assert _k9_words(plan31)[3] == 4
    x = np.broadcast_to(np.array(src31[:12], dtype=np.uint64).reshape(-1, 1)
                        - 1, (12, 8)).astype(np.uint32)
    np.testing.assert_array_equal(
        _k9_model(x, plan31),
        to_u32(rns.fbc_apply(from_u32(x), plan31, precise=True)))


def test_fbc_precise_takes_only_the_card(bfv_plans):
    """A CPU tensor takes the plain body (no launch), and K9's wrapper
    refuses it."""
    src, _, plan = bfv_plans["q_to_b"]
    x = torch.zeros((2, len(src), 16), dtype=torch.int32)
    before = dict(cuda_lib.launches)
    assert torch.equal(rns.fbc_apply(x, plan, precise=True),
                       rns.fbc_apply_plain(x, plan, precise=True))
    assert cuda_lib.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        rns.fbc_precise(x, plan)
