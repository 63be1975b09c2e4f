"""hetpu_torch.core.centered_fbc (plain path on the CPU) against hetpu's
mxu_fbc on its jnp path (``jax.jit(plan.apply)``, as tests/test_mxu_fbc.py
runs it on the CPU):

  * the plan constants equal ``MxuFbcPlan``'s where they are the same
    numbers (source primes and halves, f32 reciprocals, destination primes);
  * ``apply`` is bit-equal for the digit lift of every digit, the key-switch
    mod-down plan, the fused-tail plan and the tail plan with a folded
    ``extra``, at test_dnum and at bench_n14 level 8 (N = 1024 columns);
  * the bigint properties of tests/test_mxu_fbc.py: the lift is the exact
    centered sum, and the α plan reproduces small centered values.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hetpu.core import mxu_fbc
from hetpu.core.context import Context as RefContext
from hetpu_torch.core import centered_fbc
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import from_u32, shoup_mul, to_u32
from hetpu_torch.core.params import preset

torch.set_num_threads(1)

LEVEL = {"test_dnum": 7, "bench_n14": 8}


@pytest.fixture(scope="module", params=["test_dnum", "bench_n14"])
def ctxs(request):
    name = request.param
    return (name, Context(preset(name), "cpu"), RefContext(preset(name)))


def _plans(kind, ctx, rctx, lvl):
    """[(port plan, hetpu plan)] of one call site."""
    if kind == "lift":
        ks, rks = ctx.keyswitch_plan(lvl), rctx.keyswitch_plan(lvl)
        return [(centered_fbc.lift_plan(ks, di), mxu_fbc.lift_plan(rks, di))
                for di in range(ks.num_digits)]
    if kind == "moddown":
        fbc, rfbc = (ctx.keyswitch_plan(lvl).moddown.fbc,
                     rctx.keyswitch_plan(lvl).moddown.fbc)
        return [(ctx.centered_fbc_plan(fbc), mxu_fbc.fbc_plan(rfbc))]
    fbc, rfbc = (ctx.moddown_rescale_plan(lvl).fbc,
                 rctx.moddown_rescale_plan(lvl).fbc)
    if kind == "tail":
        return [(ctx.centered_fbc_plan(fbc), mxu_fbc.fbc_plan(rfbc))]
    extra = np.arange(3, 3 + rfbc.r.shape[0], dtype=np.uint32)
    return [(centered_fbc.fbc_plan(fbc, extra=extra),
             mxu_fbc.fbc_plan(rfbc, extra=extra))]


def _residues(rng, lead, primes, n):
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    return (rng.integers(0, 1 << 62, (*lead, len(primes), n),
                         dtype=np.uint64) % q).astype(np.uint32)


@pytest.mark.parametrize("kind", ["lift", "moddown", "tail", "extra"])
def test_apply_equals_mxu_fbc(ctxs, kind):
    name, ctx, rctx = ctxs
    rng = np.random.default_rng(len(kind))
    for plan, rplan in _plans(kind, ctx, rctx, LEVEL[name]):
        assert (plan.S, plan.F, plan.has_alpha) == (rplan.S, rplan.F,
                                                   rplan.has_alpha)
        np.testing.assert_array_equal(to_u32(plan.q_src), rplan.q_col)
        np.testing.assert_array_equal(to_u32(plan.q_half),
                                      rplan.q_half.astype(np.uint32))
        np.testing.assert_array_equal(plan.recip.numpy(), rplan.recip)
        np.testing.assert_array_equal(to_u32(plan.q_dst),
                                      rplan.dst_q[: plan.F])
        y = _residues(rng, (2,), rplan.q_col[:, 0], 1024)
        want = np.asarray(jax.jit(rplan.apply)(jnp.asarray(y)))
        got = plan.apply(from_u32(y))
        assert got.shape == (2, plan.F, 1024)
        np.testing.assert_array_equal(to_u32(got), want)


@pytest.fixture(scope="module")
def dnum():
    return Context(preset("test_dnum"), "cpu")


def test_lift_is_exact_centered_sum(dnum, rng):
    """out_r = (Σ_i center(y_i)·dhat_i) mod r, computed in bigint."""
    lvl = dnum.num_data - 1
    ks = dnum.keyswitch_plan(lvl)
    q = to_u32(ks.q)[:, 0]
    dhat = to_u32(ks.dhat)
    for di, (lo, hi) in enumerate(ks.digit_bounds):
        src = [int(p) for p in q[lo:hi]]
        y = np.stack([rng.integers(0, p, 128, dtype=np.uint64)
                      .astype(np.uint32) for p in src])
        got = to_u32(centered_fbc.lift_plan(ks, di).apply(from_u32(y)))
        cent = [np.where(y[i] > src[i] // 2, y[i].astype(np.int64) - src[i],
                         y[i].astype(np.int64)) for i in range(len(src))]
        for fj, f in enumerate(ks.foreign_idx[di]):
            want = sum(cent[i].astype(object) * int(dhat[lo + i, f])
                       for i in range(len(src)))
            np.testing.assert_array_equal(got[fj],
                                          (want % int(q[f])).astype(np.uint32))


def test_alpha_plan_reproduces_small_values(dnum, rng):
    """The α plan maps premultiplied residues of |x| < 2^40 to x's
    residues on the destination basis, exactly."""
    fbc = dnum.keyswitch_plan(dnum.num_data - 1).moddown.fbc
    vals = rng.integers(-(1 << 40), 1 << 40, (1024,))
    y = np.stack([(vals % int(p)).astype(np.uint32) for p in to_u32(fbc.p)[:, 0]])
    yp = shoup_mul(from_u32(y), fbc.inv_punit, fbc.inv_punit_shoup, fbc.p)
    got = to_u32(dnum.centered_fbc_plan(fbc).apply(yp))
    want = np.stack([(vals % int(r)).astype(np.uint32)
                     for r in to_u32(fbc.r)[:, 0]])
    np.testing.assert_array_equal(got, want)


def test_refuses_bad_input(dnum):
    plan = dnum.centered_fbc_plan(
        dnum.keyswitch_plan(dnum.num_data - 1).moddown.fbc)
    y = torch.zeros((2, plan.S, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous"):
        plan.apply(y.transpose(0, 1))
    with pytest.raises(TypeError):
        plan.apply(y.to(torch.int64))
    with pytest.raises(ValueError):
        plan.apply(y[:, 1:])
