"""The f32 α of the centered fast base conversion, on near-tie columns.

hetpu computes α = round(Σ_i f32(y_i)·f32(1/p_i)) as
``jnp.sum(y.astype(f32) * recip, axis=-2)`` inside ``jax.jit``; XLA
compiles that into one chain of fused multiply-adds.  The columns of
``tests/torch_ties.py`` were found once (seeded search, each S-tuple a
column of residues) where that chain and a multiply-then-add chain round
α differently; the first test asserts that they still do, which keeps
the others (and the card tests that share the tables) meaningful.  On
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
from torch_ties import (TIES_4096, TIES_4096_CENTERED, TIES_DNUM,
                        TIES_DNUM_CENTERED, TIES_DNUM_MODDOWN,
                        TIES_N14_TAIL_CENTERED)

torch.set_num_threads(1)

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


@pytest.mark.parametrize("case", ["dnum", "dnum_centered", "n4096",
                                  "n4096_centered", "n14_centered",
                                  "dnum_moddown"])
def test_columns_are_ties(dnum, case):
    """The fma chain (hetpu's jitted α) and a multiply-then-add chain
    round α differently on every listed column."""
    if case == "dnum_moddown":
        primes = preset("test_dnum").special_moduli
        v = _cols(TIES_DNUM_MODDOWN).astype(np.int64)
    elif case == "n14_centered":
        p = preset("bench_n14")
        primes = p.moduli[8:9] + p.special_moduli
        v = _center(_cols(TIES_N14_TAIL_CENTERED).astype(np.int64), primes)
    elif case.startswith("n4096"):
        primes = P4096.moduli[5:6] + P4096.special_moduli
        v = _cols(TIES_4096 if case == "n4096"
                  else TIES_4096_CENTERED).astype(np.int64)
        if case == "n4096_centered":
            v = _center(v, primes)
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
