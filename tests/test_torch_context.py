"""hetpu_torch's host layer equals hetpu's: parameter presets, seeded
draws, flat NTT tables, and every array of the KeySwitchPlan and
ModDownRescalePlan at every level of test_dnum plus bench_n14's top level
(the main path's level)."""

import dataclasses

import numpy as np
import pytest
import torch

from hetpu.core import random as ref_rnd
from hetpu.core.context import Context as RefContext
from hetpu.core.ntt import build_tables as ref_build_tables
from hetpu.core.params import _PRESETS, preset as ref_preset
from hetpu_torch.core import ntt_passes
from hetpu_torch.core import random as rnd
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import to_u32
from hetpu_torch.core.ntt import NttTables, build_tables
from hetpu_torch.core.params import preset

torch.set_num_threads(1)

# test_hi's prime-pair search takes ~50 s in either package; the paired-prime
# code (ckks_params with scale_bits > 31) is covered by ckks_hi.
PRESETS = sorted(set(_PRESETS) - {"test_hi"})


@pytest.mark.parametrize("name", PRESETS)
def test_presets_equal(name):
    assert dataclasses.asdict(preset(name)) == dataclasses.asdict(
        ref_preset(name))


def test_seeded_draws_equal():
    seed = bytes(range(32))
    q = np.array(ref_preset("test_dnum").moduli, np.uint32).reshape(-1, 1)
    for dom in (1, 2, 101):
        np.testing.assert_array_equal(rnd.ternary(seed, dom, 1024),
                                      ref_rnd.ternary(seed, dom, 1024))
        np.testing.assert_array_equal(rnd.gaussian(seed, dom, 1024),
                                      ref_rnd.gaussian(seed, dom, 1024))
        np.testing.assert_array_equal(rnd.uniform_rns(seed, dom, q, 1024),
                                      ref_rnd.uniform_rns(seed, dom, q, 1024))


def _assert_tables_equal(got: NttTables, want, *, arrays: bool):
    """Field by field; the kernels' per-pass tables (which the reference
    does not have) against the reference's flat tables reordered."""
    assert got.n == want.n and got.primes == want.primes
    if arrays:
        logn = got.n.bit_length() - 1
        index = {"fwd": ntt_passes.fwd_table_index(logn),
                 "inv": ntt_passes.inv_table_index(logn)}
        for f in dataclasses.fields(got):
            if f.name in ("n", "primes"):
                continue
            d, _, rest = f.name.partition("_pass_")
            want_a = (np.asarray(getattr(want, f"{d}_{rest}"))[:, index[d]]
                      if rest else getattr(want, f.name))
            np.testing.assert_array_equal(
                to_u32(getattr(got, f.name)), want_a, err_msg=f.name)


@pytest.mark.parametrize("name", ["test_dnum", "bench_n14"])
def test_flat_tables_equal(name):
    p = preset(name)
    primes = p.moduli + p.special_moduli
    _assert_tables_equal(build_tables(p.poly_degree, primes, "cpu"),
                         ref_build_tables(p.poly_degree, primes), arrays=True)


def _digit_rows(plan) -> dict:
    """The port's own key-switch fields, from hetpu's plan: where each
    digit limb lies in a row of digits [J, R] (limb j·R + r), the lifted
    rows (``ext_row``, by ``foreign_idx``) and the own primes
    (``own_row``, by ``digit_bounds``)."""
    R = np.asarray(plan.q).shape[0]
    return {"ext_row": np.concatenate([j * R + np.asarray(f) for j, f in
                                       enumerate(plan.foreign_idx)]),
            "own_row": np.concatenate([j * R + np.arange(lo, hi) for
                                       j, (lo, hi) in
                                       enumerate(plan.digit_bounds)])}


def _assert_plan_equal(got, want, path=""):
    """Field-by-field: tensors vs numpy arrays, tables by primes (and by
    array where the reference's tables are flat too), plans recursively;
    the port's digit rows against :func:`_digit_rows`."""
    for f in dataclasses.fields(got):
        where = f"{path}{f.name}"
        if f.name == "kernel_consts":      # FbcPlan's K9 table, port only
            continue
        if f.name in ("ext_row", "own_row"):
            g = getattr(got, f.name)
            assert g.rows.dtype == torch.int32, where
            assert g.limbs == got.num_digits * len(got.basis_tables.primes)
            np.testing.assert_array_equal(g.rows.numpy(),
                                          _digit_rows(want)[f.name],
                                          err_msg=where)
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, NttTables):
            _assert_tables_equal(g, w, arrays=not hasattr(w, "sub1"))
        elif isinstance(g, torch.Tensor):
            if g.dtype == torch.float32:
                np.testing.assert_array_equal(
                    g.numpy(), np.asarray(w).astype(np.float32), err_msg=where)
            else:
                np.testing.assert_array_equal(
                    to_u32(g), np.asarray(w).astype(np.uint32), err_msg=where)
        elif dataclasses.is_dataclass(g):
            _assert_plan_equal(g, w, where + ".")
        elif f.name == "foreign_tables":
            assert len(g) == len(w), where
            for a, b in zip(g, w):
                _assert_tables_equal(a, b, arrays=not hasattr(b, "sub1"))
        elif f.name == "foreign_idx":
            assert len(g) == len(w)
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert g == w, where


@pytest.fixture(scope="module")
def contexts():
    return {name: (Context(preset(name), "cpu"), RefContext(ref_preset(name)))
            for name in ("test_dnum", "bench_n14")}


CASES = [("test_dnum", lvl) for lvl in range(8)] + [("bench_n14", 8)]


@pytest.mark.parametrize("name,level", CASES)
def test_keyswitch_plan_equal(contexts, name, level):
    ctx, rctx = contexts[name]
    _assert_plan_equal(ctx.keyswitch_plan(level), rctx.keyswitch_plan(level))


@pytest.mark.parametrize("name,level", [c for c in CASES if c[1] >= 1])
def test_moddown_rescale_plan_equal(contexts, name, level):
    ctx, rctx = contexts[name]
    _assert_plan_equal(ctx.moddown_rescale_plan(level),
                       rctx.moddown_rescale_plan(level))


@pytest.mark.parametrize("name,level", [("test_dnum", 7), ("bench_n14", 8)])
def test_foreign_tables_equal(contexts, name, level):
    """KeySwitchPlan.foreign_tables, one NTT table a digit over the key
    basis minus the digit's own primes: hetpu's primes, and its flat
    tables' twiddles and Shoup companions as u32 (at bench_n14 hetpu keeps
    four-step tables, so its flat build of the same primes)."""
    ctx, rctx = contexts[name]
    ks, rks = ctx.keyswitch_plan(level), rctx.keyswitch_plan(level)
    assert len(ks.foreign_tables) == len(rks.foreign_tables) == ks.num_digits
    R = len(ks.basis_tables.primes)
    for di, (t, rt) in enumerate(zip(ks.foreign_tables, rks.foreign_tables)):
        lo, hi = ks.digit_bounds[di]
        assert len(t.primes) == R - (hi - lo)
        assert t.primes == rt.primes == tuple(
            ks.basis_tables.primes[int(f)] for f in ks.foreign_idx[di])
        _assert_tables_equal(t, ref_build_tables(t.n, t.primes), arrays=True)
        if not hasattr(rt, "sub1"):
            _assert_tables_equal(t, rt, arrays=True)


def test_bench_n14_shapes(contexts):
    """The main path's shapes at bench_n14 level 8: J=2 digits (0-5, 5-9),
    a [19, 5] lift with 10 zero pads, a 6 → 8 prime FBC, and Shoup
    companions ≥ 2^31 kept through the int32 storage."""
    ctx, _ = contexts["bench_n14"]
    ks = ctx.keyswitch_plan(8)
    assert ks.digit_bounds == ((0, 5), (5, 9))
    assert tuple(ks.lift_w.shape) == (19, 5)
    assert int((ks.lift_w == 0).sum()) == 10
    assert len(ks.basis_tables.primes) == 14
    mdr = ctx.moddown_rescale_plan(8)
    assert tuple(mdr.fbc.phat_mod_r.shape) == (6, 8)
    assert (to_u32(ks.lift_ws) >= 1 << 31).any()


def test_mont_and_crt_helpers(contexts):
    ctx, rctx = contexts["test_dnum"]
    for lvl in (0, 7):
        for k, v in rctx.mont(lvl).items():
            np.testing.assert_array_equal(to_u32(ctx.mont(lvl)[k]), v)
    rng = np.random.default_rng(3)
    coeffs = rng.integers(-(1 << 40), 1 << 40, 1024)
    res = ctx.to_rns(coeffs, 7)
    np.testing.assert_array_equal(res, rctx.to_rns(coeffs, 7))
    assert (ctx.crt_lift_small(res, 7, 42) == coeffs).all()
    assert (ctx.crt_lift(res, 7) == coeffs).all()
