"""The f32 α of the centered fast base conversion, on near-tie columns.

hetpu computes α = round(Σ_i f32(y_i)·f32(1/p_i)) as
``jnp.sum(y.astype(f32) * recip, axis=-2)`` inside ``jax.jit``; XLA
compiles that into one chain of fused multiply-adds.  The columns below
were found once (seeded search, each S-tuple a column of residues) where
that chain and a multiply-then-add chain round α differently; the first
test asserts that they still do, which keeps the others meaningful.  On
them the port's plain α must be the fma chain:

  * ``rns.fbc_apply``, ``fused_ntt.ntt_fwd_fbc_plain`` and
    ``evaluator._fbc_fwd_mont`` equal ``jax.jit`` of hetpu's
    ``rns.fbc_apply``, ``evaluator._fbc_fwd_mont`` and the jnp twin of
    ``mxu_ntt.ntt_fwd_fbc``;
  * the centered plan equals ``jax.jit(MxuFbcPlan.apply)`` (and the
    centered ``_fbc_fwd_mont`` hetpu's with ``HETPU_MXU_FBC=1``).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hetpu.core import evaluator as ref_ev
from hetpu.core import mxu_fbc, mxu_ntt
from hetpu.core import rns as ref_rns
from hetpu.core.context import Context as RefContext
from hetpu.core.params import ckks_params
from hetpu_torch.core import centered_fbc, evaluator, fused_ntt, rns
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.params import preset

torch.set_num_threads(1)

# test_dnum, fused tail at the top level: sources q_7 + the 3 specials
TIES_DNUM = [[508039856, 1099080352, 1621637186, 1631625018],
             [37419502, 309566830, 1767178876, 1069488476],
             [454505166, 586600971, 1777398114, 2095414402],
             [92054122, 59180148, 1858753445, 1119026592]]
# the same sources, ties of the CENTERED values (y_i > q_i/2 → y_i − q_i)
TIES_DNUM_CENTERED = [[362438493, 1635477856, 1308414874, 1699663812],
                      [635511566, 1792818991, 214954608, 2089613811],
                      [832047190, 1506075342, 338069672, 1860156527],
                      [267531152, 2002721513, 383764152, 299512774]]
# N=4096 (four-step tables in hetpu), levels=5, 2 specials: sources of
# the fused tail at level 5
TIES_4096 = [[192642151, 508515651, 179833393],
             [860224061, 1866548870, 1781166677],
             [666931458, 1028692039, 858318483],
             [420010767, 1906473318, 474437857]]

P4096 = ckks_params(1 << 12, levels=5, scale_bits=30, num_special=2,
                    first_prime_bits=31, special_prime_bits=31, sec_level=0)


def _cols(ties, n=None):
    """[S, len(ties)] u32, or tiled to [S, n]."""
    y = np.array(ties, dtype=np.uint32).T
    return y if n is None else np.tile(y, (1, n // y.shape[1]))


def _center(y, primes):
    q = np.array(primes, dtype=np.int64).reshape(-1, 1)
    v = y.astype(np.int64)
    return np.where(v > q // 2, v - q, v)


def _alpha_mul_add(v, primes):
    """α with the multiply and the add rounded separately."""
    recip = (1.0 / np.array(primes, dtype=np.float64)).astype(np.float32)
    s = np.zeros(v.shape[-1], np.float32)
    for i in range(v.shape[0]):
        s = (s + v[i].astype(np.int32).astype(np.float32) * recip[i]
             ).astype(np.float32)
    return np.rint(s)


def _alpha_jit(v, primes):
    """α as hetpu's jitted jnp.sum computes it."""
    recip = (1.0 / np.array(primes, dtype=np.float64)
             ).astype(np.float32).reshape(-1, 1)
    f = jax.jit(lambda v: jnp.round(jnp.sum(v.astype(jnp.float32) * recip,
                                            axis=-2)))
    return np.asarray(f(jnp.asarray(v.astype(np.int32))))


@pytest.fixture(scope="module")
def dnum():
    ctx = Context(preset("test_dnum"), "cpu")
    lvl = ctx.num_data - 1
    rctx = RefContext(ctx.params)
    return (ctx.moddown_rescale_plan(lvl), rctx.moddown_rescale_plan(lvl),
            ctx.params.moduli[lvl:lvl + 1] + ctx.params.special_moduli)


@pytest.mark.parametrize("case", ["dnum", "dnum_centered", "n4096"])
def test_columns_are_ties(dnum, case):
    """The fma chain (hetpu's jitted α) and a multiply-then-add chain
    round α differently on every listed column."""
    if case == "n4096":
        primes = P4096.moduli[5:6] + P4096.special_moduli
        v = _cols(TIES_4096).astype(np.int64)
    else:
        primes = dnum[2]
        ties = TIES_DNUM if case == "dnum" else TIES_DNUM_CENTERED
        v = _cols(ties).astype(np.int64)
        if case == "dnum_centered":
            v = _center(v, primes)
    want = _alpha_jit(v, primes)
    assert (want != _alpha_mul_add(v, primes)).all()
    got = rns.alpha_f32(torch.from_numpy(v.astype(np.int32)),
                        torch.from_numpy((1.0 / np.array(primes, np.float64))
                                         .astype(np.float32).reshape(-1, 1)))
    np.testing.assert_array_equal(got.numpy()[0], want)


def test_fbc_apply(dnum):
    plan, rplan, _ = dnum
    y = _cols(TIES_DNUM)
    f = jax.jit(lambda y: ref_rns.fbc_apply(y, rplan.fbc, correct=True,
                                            premul=False))
    want = np.asarray(f(jnp.asarray(y)))
    got = rns.fbc_apply(from_u32(y), plan.fbc, correct=True, premul=False)
    np.testing.assert_array_equal(to_u32(got), want)


def test_fbc_fwd_mont(dnum):
    plan, rplan, _ = dnum
    y = _cols(TIES_DNUM, 1024)[None]
    f = jax.jit(lambda u: ref_ev._fbc_fwd_mont(u, rplan.fbc, rplan.dst_tables))
    want = np.asarray(f(jnp.asarray(y)))
    got = evaluator._fbc_fwd_mont(from_u32(y), plan.fbc, plan.dst_tables)
    np.testing.assert_array_equal(to_u32(got), want)


def test_ntt_fwd_fbc_vs_mxu_twin():
    rctx, ctx = RefContext(P4096), Context(P4096, "cpu")
    rplan, plan = rctx.moddown_rescale_plan(5), ctx.moddown_rescale_plan(5)
    y = _cols(TIES_4096, 4096)[None]
    old = mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL
    mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL = True, "jnp"
    try:
        want = np.asarray(jax.jit(lambda u: mxu_ntt.ntt_fwd_fbc(
            u, rplan.fbc, rplan.dst_tables, to_mont=True))(jnp.asarray(y)))
    finally:
        mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL = old
    got = fused_ntt.ntt_fwd_fbc_plain(from_u32(y), plan.fbc, plan.dst_tables)
    np.testing.assert_array_equal(to_u32(got), want)


def test_centered_plan_alpha(dnum):
    plan, rplan, _ = dnum
    y = _cols(TIES_DNUM_CENTERED)
    want = np.asarray(jax.jit(mxu_fbc.fbc_plan(rplan.fbc).apply)(
        jnp.asarray(y)))
    got = centered_fbc.fbc_plan(plan.fbc).apply(from_u32(y))
    np.testing.assert_array_equal(to_u32(got), want)


def test_centered_fbc_fwd_mont(dnum, monkeypatch):
    plan, rplan, _ = dnum
    y = _cols(TIES_DNUM_CENTERED, 1024)[None]
    monkeypatch.setenv("HETPU_MXU_FBC", "1")
    want = np.asarray(jax.jit(lambda u: ref_ev._fbc_fwd_mont(
        u, rplan.fbc, rplan.dst_tables))(jnp.asarray(y)))
    got = evaluator._fbc_fwd_mont(from_u32(y), plan.fbc, plan.dst_tables,
                                  centered_fbc.fbc_plan(plan.fbc))
    np.testing.assert_array_equal(to_u32(got), want)
