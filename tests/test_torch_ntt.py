"""hetpu_torch NTTs against the golden vectors and against hetpu.

* the plain butterflies (core/ntt.py), every epilogue, exact against
  golden_tiny / golden_n14 and against hetpu's flat ntt.py;
* the fused entry points (core/fused_ntt.py: ntt_inv strip+extra,
  ntt_fwd to_mont, ntt_fwd_lifted, ntt_fwd_fbc) exact against the jnp twins
  of hetpu's mxu_ntt at N=4096 (four-step tables), with the plans of a
  hetpu Context on a small parameter set — including a short last digit,
  whose padded lift terms read a clamped source plane.
On CPU tensors every call takes the plain path (the CUDA kernels are
checked against these same plain versions on the card, chip_smoke.py)."""

import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import mxu_ntt
from hetpu.core import ntt as ref_ntt
from hetpu.core.context import Context as RefContext
from hetpu.core.params import ckks_params, preset
from hetpu_torch.core import fused_ntt
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.ntt import (build_tables, ntt_fwd, ntt_fwd_mont,
                                  ntt_inv)

torch.set_num_threads(1)

GOLD = pathlib.Path(__file__).parent / "golden"


@pytest.mark.parametrize("name,tag", [("golden_tiny", "ntt_tiny"),
                                      ("golden_n14", "ntt_n14")])
def test_plain_ntt_golden(name, tag):
    z = np.load(GOLD / f"{name}.npz")
    primes = tuple(int(p) for p in z[f"{tag}_primes"])
    t = build_tables(z[f"{tag}_x"].shape[-1], primes)
    x = from_u32(z[f"{tag}_x"])
    np.testing.assert_array_equal(to_u32(ntt_fwd(x, t)), z[f"{tag}_fwd"])
    np.testing.assert_array_equal(to_u32(ntt_inv(x, t)), z[f"{tag}_inv"])


@pytest.fixture(scope="module")
def dnum_basis():
    p = preset("test_dnum")
    primes = p.moduli + p.special_moduli
    rt = ref_ntt.build_tables(p.poly_degree, primes)
    t = build_tables(p.poly_degree, primes)
    rng = np.random.default_rng(11)
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, (2, len(primes), p.poly_degree),
                      dtype=np.uint64) % q).astype(np.uint32)
    extra = (rng.integers(0, 1 << 62, (len(primes), 1), dtype=np.uint64)
             % q).astype(np.uint32)
    return rt, t, x, extra


@pytest.mark.parametrize("case", ["fwd", "fwd_mont", "inv", "inv_strip",
                                  "inv_strip_extra"])
def test_plain_ntt_vs_hetpu_flat(dnum_basis, case):
    rt, t, x, extra = dnum_basis
    xj, xt = jnp.asarray(x), from_u32(x)
    if case == "fwd":
        want, got = ref_ntt.ntt_fwd(xj, rt), ntt_fwd(xt, t)
    elif case == "fwd_mont":
        want, got = ref_ntt.ntt_fwd_mont(xj, rt), ntt_fwd_mont(xt, t)
    elif case == "inv":
        want, got = ref_ntt.ntt_inv(xj, rt), ntt_inv(xt, t)
    elif case == "inv_strip":
        want = ref_ntt.ntt_inv(xj, rt, strip_mont=True)
        got = ntt_inv(xt, t, strip_mont=True)
    else:
        want = ref_ntt.ntt_inv(xj, rt, strip_mont=True, extra=extra)
        got = ntt_inv(xt, t, strip_mont=True, extra=from_u32(extra))
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


def test_plain_roundtrip(dnum_basis):
    _, t, x, _ = dnum_basis
    xt = from_u32(x)
    assert torch.equal(ntt_inv(ntt_fwd(xt, t), t), xt)
    with pytest.raises(ValueError):
        ntt_inv(xt, t, extra=t.r)            # extra needs strip_mont


# ----------------------------------------------------------------------
# fused entry points vs hetpu mxu_ntt's jnp twins (four-step, N=4096)
# ----------------------------------------------------------------------

_PARAMS = dict(levels=5, scale_bits=30, num_special=2, first_prime_bits=31,
               special_prime_bits=31, sec_level=0)


@pytest.fixture(scope="module")
def ctx4096():
    params = ckks_params(1 << 12, **_PARAMS)
    rctx = RefContext(params)
    assert hasattr(rctx.tables_full, "sub1")          # four-step tables
    return rctx, Context(params)


@pytest.fixture
def mxu_jnp():
    """Run hetpu's mxu_ntt entry points on their jnp twins (as
    tests/test_mxu_ntt.py does on the CPU)."""
    old = mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL
    mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL = True, "jnp"
    try:
        yield mxu_ntt
    finally:
        mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL = old


def _rand(seed, lead, primes):
    rng = np.random.default_rng(seed)
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    return (rng.integers(0, 1 << 62, (*lead, len(primes), 4096),
                         dtype=np.uint64) % q).astype(np.uint32)


def test_fused_inv_strip_extra(ctx4096, mxu_jnp):
    rctx, ctx = ctx4096
    lvl = rctx.num_data - 1
    rplan, plan = rctx.keyswitch_plan(lvl), ctx.keyswitch_plan(lvl)
    x = _rand(21, (2,), rctx.params.moduli)
    want = mxu_jnp.ntt_inv(jnp.asarray(x), rctx.tables(lvl), strip_mont=True,
                           extra=rplan.dig_inv)
    got = fused_ntt.ntt_inv(from_u32(x), ctx.tables(lvl), strip_mont=True,
                            extra=plan.dig_inv)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


def test_fused_fwd_to_mont(ctx4096, mxu_jnp):
    rctx, ctx = ctx4096
    x = _rand(22, (2,), rctx.all_primes)
    want = mxu_jnp.ntt_fwd(jnp.asarray(x), rctx.tables_full, to_mont=True)
    got = fused_ntt.ntt_fwd(from_u32(x), ctx.tables_full, to_mont=True)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.mark.parametrize("level_from_top", [0, 1])
def test_fused_lifted(ctx4096, mxu_jnp, level_from_top):
    """Top level: three full digits; one level down: the last digit is
    short (1 prime of α=2), so its padded term's source index passes the
    last plane and is clamped — lift weight 0 there."""
    rctx, ctx = ctx4096
    lvl = rctx.num_data - 1 - level_from_top
    rplan, plan = rctx.keyswitch_plan(lvl), ctx.keyswitch_plan(lvl)
    F, A = rplan.lift_w.shape
    overhang = rplan.lift_dig.astype(np.int64) * A + A - 1 > lvl
    assert overhang.any() == (level_from_top == 1)
    assert (rplan.lift_w[overhang, A - 1] == 0).all()
    y = _rand(23 + level_from_top, (2,), rctx.params.moduli[: lvl + 1])
    want = mxu_jnp.ntt_fwd_lifted(jnp.asarray(y), rplan.lift_w, rplan.lift_ws,
                                  rplan.lift_dig, rplan.foreign_cat_tables)
    got = fused_ntt.ntt_fwd_lifted(from_u32(y), plan.lift_w, plan.lift_ws,
                                   plan.lift_dig, plan.foreign_cat_tables)
    assert tuple(got.shape) == (2, F, 4096)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


def test_fused_fbc(ctx4096, mxu_jnp):
    rctx, ctx = ctx4096
    lvl = rctx.num_data - 1
    rplan, plan = rctx.moddown_rescale_plan(lvl), ctx.moddown_rescale_plan(lvl)
    u = _rand(25, (2, 2), rplan.src_tables.primes)
    want = mxu_jnp.ntt_fwd_fbc(jnp.asarray(u), rplan.fbc, rplan.dst_tables,
                               to_mont=True)
    got = fused_ntt.ntt_fwd_fbc(from_u32(u), plan.fbc, plan.dst_tables,
                                to_mont=True)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))
