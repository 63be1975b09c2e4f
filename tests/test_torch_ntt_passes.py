"""The pass schedule of the ``ntt`` kernel and of the fused kernels
``ntt_fwd_fbc``, ``ntt_fwd_lifted`` and ``ntt_fwd_centered``
(hetpu_torch/core/ntt_passes.py), on the CPU.

The kernels cannot run here; their plain twins walk the reordered
twiddle tables pass by pass and cluster rank by rank exactly as the
kernels index them.  They are held bit for bit against the flat
transforms of core/ntt.py at every logn 10..15 the kernels take (and
against hetpu's flat NTT at logn 10 and 15), for every epilogue, split
over the cluster the kernels launch there (2, 4, 8 CTAs a plane); the K3
twin against ``ntt_fwd_fbc_plain`` and hetpu's jitted ``_fbc_fwd_mont`` on
the near-tie α columns at N = 2^10 and 2^12 (clusters of 2 and 8).  The
fused kernels' pass-0 loader (the lift, the centered lift, the centered
conversion) is held at N = 2^10 and 2^12 against the plain entry points
and hetpu: K2 against the jnp twin of ``mxu_ntt.ntt_fwd_lifted``
(N = 2^12: it needs four-step tables), the centered forms against hetpu's
centered path (``mxu_fbc`` plans applied under ``jax.jit``, then hetpu's
NTT), the centered α also on near-tie columns.  The shared-memory swizzle
is checked to give every warp of every pass, for every cluster size, 32
distinct banks."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hetpu.core import evaluator as ref_ev
from hetpu.core import mxu_fbc, mxu_ntt
from hetpu.core import ntt as ref_ntt
from hetpu.core.context import Context as RefContext
from hetpu_torch.core import centered_fbc, fused_ntt, ntt_passes
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.nt import gen_primes
from hetpu_torch.core.ntt import build_tables, ntt_fwd_plain, ntt_inv_plain
from hetpu_torch.core.params import ckks_params, preset
from torch_ties import (TIES_4096, TIES_4096_CENTERED, TIES_DNUM,
                        TIES_DNUM_CENTERED)

torch.set_num_threads(1)

E = ntt_passes.E


@pytest.fixture(scope="module", params=range(10, 16))
def basis(request):
    logn = request.param
    n = 1 << logn
    primes = gen_primes(31, 2, 2 * n)
    rng = np.random.default_rng(logn)
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, (2, 2, n), dtype=np.uint64) % q
         ).astype(np.uint32)
    extra = (rng.integers(0, 1 << 62, (2, 1), dtype=np.uint64) % q
             ).astype(np.uint32)
    return (build_tables(n, primes, "cpu"), ref_ntt.build_tables(n, primes),
            x, extra)


EPILOGUES = ["fwd", "fwd_mont", "inv", "inv_strip", "inv_strip_extra"]


@pytest.mark.parametrize("epi", EPILOGUES)
def test_pass_twins_equal_flat_and_hetpu(basis, epi):
    t, rt, x, extra = basis
    logn = t.n.bit_length() - 1
    cluster = ntt_passes.cluster_size(logn)
    xt, xj = from_u32(x), jnp.asarray(x)
    if epi.startswith("fwd"):
        mont = epi == "fwd_mont"
        got = ntt_passes.ntt_fwd_passes_plain(xt, t, cluster=cluster,
                                              to_mont=mont)
        flat = ntt_fwd_plain(xt, t, to_mont=mont)
        ref = lambda: (ref_ntt.ntt_fwd_mont if mont else ref_ntt.ntt_fwd)(
            xj, rt)
    else:
        strip = epi != "inv"
        ex = extra if epi == "inv_strip_extra" else None
        got = ntt_passes.ntt_inv_passes_plain(
            xt, t, cluster=cluster, strip_mont=strip,
            extra=None if ex is None else from_u32(ex))
        flat = ntt_inv_plain(xt, t, strip_mont=strip,
                             extra=None if ex is None else from_u32(ex))
        ref = lambda: ref_ntt.ntt_inv(xj, rt, strip_mont=strip, extra=ex)
    assert torch.equal(got, flat)
    if logn in (10, 15):
        np.testing.assert_array_equal(to_u32(got), np.asarray(ref()))


@pytest.mark.parametrize("logn", range(10, 16))
def test_pass_tables_reorder_the_flat_tables(logn):
    """Each pass table is the flat table gathered by its index map, and
    the maps reach every flat twiddle 1..N-1 (each stage reads all of its
    m twiddles at m..2m-1)."""
    n = 1 << logn
    t = build_tables(n, gen_primes(31, 1, 2 * n), "cpu")
    assert t.fwd_pass_w.shape == (1, ntt_passes.table_size(logn))
    for d, fn in (("fwd", ntt_passes.fwd_table_index),
                  ("inv", ntt_passes.inv_table_index)):
        ix = torch.from_numpy(fn(logn))
        for k in ("w", "w_shoup"):
            assert torch.equal(getattr(t, f"{d}_pass_{k}"),
                               getattr(t, f"{d}_{k}")[:, ix])
        assert set(ix.tolist()) - {0} == set(range(1, n))


@pytest.mark.parametrize("logn", range(10, 16))
def test_swizzle_keeps_warps_conflict_free(logn):
    """Every shared-memory access of every pass (and the cross-CTA ones,
    by local index in the owner) puts a warp's 32 threads on 32 distinct
    banks, for every cluster size and every j."""
    n = 1 << logn
    P, odd = ntt_passes.passes(logn), ntt_passes.odd_stages(logn)
    jj = np.arange(E)
    for C in (c for c in ntt_passes.CLUSTERS if n // c >= ntt_passes.MIN_CTA):
        m = n // C
        vt = np.arange(m // E)[:, None]
        v = np.arange(n // E)[:, None]         # all ranks: stride N/8
        local = [vt * E + jj, v + jj * (n // E)]
        for p in range(1, P - 1):
            lt = logn - ntt_passes.LOG_E * p - ntt_passes.LOG_E
            local.append(((vt >> lt) << (lt + 3)) + (vt & ((1 << lt) - 1))
                         + (jj << lt))
            lh0 = odd + ntt_passes.LOG_E * (p - 1)
            local.append(((vt >> lh0) << (lh0 + 3)) + (vt & ((1 << lh0) - 1))
                         + (jj << lh0))
        for li in local:
            bank = ntt_passes.swizzle(li % m) % 32
            warps = bank.reshape(-1, 32, E)
            for w in warps:
                assert all(len(set(w[:, j])) == 32 for j in range(E))
        assert sorted(ntt_passes.swizzle(np.arange(m))) == list(range(m))


def test_cluster_choice():
    """The kernels' C (``cluster_ctas`` in csrc/ntt_passes.cuh, the same
    rule): 2, 4, 8 CTAs a plane at logn 10, 11, ≥ 12, so 64 to 512
    threads a CTA; the twins refuse CTAs of fewer than MIN_CTA residues."""
    chosen = [ntt_passes.cluster_size(logn) for logn in range(10, 16)]
    assert chosen == [2, 4, 8, 8, 8, 8]
    threads = [(1 << logn) // c // E for logn, c in zip(range(10, 16), chosen)]
    assert threads == [64, 64, 64, 128, 256, 512]
    t = build_tables(1024, gen_primes(31, 1, 2048), "cpu")
    with pytest.raises(ValueError):
        ntt_passes.ntt_fwd_passes_plain(
            torch.zeros((1, 1, 1024), dtype=torch.int32), t, cluster=8)


P4096 = ckks_params(1 << 12, levels=5, scale_bits=30, num_special=2,
                    first_prime_bits=31, special_prime_bits=31, sec_level=0)


@pytest.fixture(scope="module", params=["dnum", "n4096"])
def tail_ties(request):
    """(plan, hetpu's plan, near-tie columns [S, 4]) of a fused tail."""
    params, ties = ((preset("test_dnum"), TIES_DNUM)
                    if request.param == "dnum" else (P4096, TIES_4096))
    ctx = Context(params, "cpu")
    lvl = ctx.num_data - 1
    rplan = RefContext(params).moddown_rescale_plan(lvl)
    return (ctx.moddown_rescale_plan(lvl), rplan,
            np.array(ties, dtype=np.uint32).T)


@pytest.mark.parametrize("cluster", ntt_passes.CLUSTERS)
def test_pass0_columns_split_over_the_cluster(cluster):
    """Pass 0 of the forward transform (K3: the conversion) gives thread
    v = rank·M/8 + vt the columns v + j·N/8: each rank converts M = N/C of
    them, and over the ranks every column once."""
    n = 1 << 12
    m = n // cluster
    owners = np.zeros(n, dtype=int)
    for c in range(cluster):
        v = c * (m // E) + np.arange(m // E)
        idx = (v[:, None] + np.arange(E) * (n // E)).reshape(-1)
        assert len(idx) == m
        owners[idx] += 1
    assert (owners == 1).all()


def test_fbc_pass_twin_on_near_ties(tail_ties):
    """[1, 2, S, N] of the tiled near-tie columns through the K3 twin, at
    the cluster the kernel launches at that N, equals ntt_fwd_fbc_plain
    and hetpu's jitted _fbc_fwd_mont."""
    plan, rplan, ties = tail_ties
    n = plan.dst_tables.n
    cols = np.tile(ties, (1, n // ties.shape[1]))
    y = np.stack([cols, np.roll(cols, 1, axis=1)])[None]
    u = from_u32(y)
    got = ntt_passes.ntt_fwd_fbc_passes_plain(
        u, plan.fbc, plan.dst_tables,
        cluster=ntt_passes.cluster_size(n.bit_length() - 1))
    assert torch.equal(got, fused_ntt.ntt_fwd_fbc_plain(u, plan.fbc,
                                                        plan.dst_tables))
    want = jax.jit(lambda v: ref_ev._fbc_fwd_mont(v, rplan.fbc,
                                                  rplan.dst_tables))
    np.testing.assert_array_equal(to_u32(got), np.asarray(want(jnp.asarray(y))))


# ----------------------------------------------------------------------
# the fused kernels' pass-0 loader: K2's lift, the centered lift and the
# centered conversion of ``ntt_fwd_centered``
# ----------------------------------------------------------------------

@pytest.fixture(scope="module", params=[10, 12])
def lift_ctx(request):
    """(port context, hetpu context, logn): levels=5, 2 specials, so
    α = 2 and the level below the top has a short last digit."""
    logn = request.param
    params = ckks_params(1 << logn, levels=5, scale_bits=30, num_special=2,
                         first_prime_bits=31, special_prime_bits=31,
                         sec_level=0)
    return Context(params, "cpu"), RefContext(params), logn


@pytest.fixture
def mxu_jnp():
    """hetpu's mxu_ntt entry points on their jnp twins."""
    old = mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL
    mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL = True, "jnp"
    try:
        yield mxu_ntt
    finally:
        mxu_ntt._FORCE, mxu_ntt._FORCE_IMPL = old


def _rand(seed, lead, primes, n):
    rng = np.random.default_rng(seed)
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    return (rng.integers(0, 1 << 62, (*lead, len(primes), n),
                         dtype=np.uint64) % q).astype(np.uint32)


@pytest.mark.parametrize("to_mont", [False, True])
@pytest.mark.parametrize("from_top", [0, 1])
def test_lifted_pass_twin(lift_ctx, mxu_jnp, from_top, to_mont):
    """K2's schedule equals ntt_fwd_lifted_plain; one level below the top
    the last digit is short and its padded terms read a clamped plane;
    at N = 2^12 also hetpu's mxu_ntt.ntt_fwd_lifted."""
    ctx, rctx, logn = lift_ctx
    lvl = ctx.num_data - 1 - from_top
    ks = ctx.keyswitch_plan(lvl)
    ft = ks.foreign_cat_tables
    y = _rand(40 + from_top, (2,), ctx.params.moduli[: lvl + 1], 1 << logn)
    yt = from_u32(y)
    got = ntt_passes.ntt_fwd_lifted_passes_plain(
        yt, ks.lift_w, ks.lift_dig, ft,
        cluster=ntt_passes.cluster_size(logn), to_mont=to_mont)
    assert torch.equal(got, fused_ntt.ntt_fwd_lifted_plain(
        yt, ks.lift_w, ks.lift_ws, ks.lift_dig, ft, to_mont=to_mont))
    if logn == 12:
        rks = rctx.keyswitch_plan(lvl)
        want = mxu_jnp.ntt_fwd_lifted(jnp.asarray(y), rks.lift_w,
                                      rks.lift_ws, rks.lift_dig,
                                      rks.foreign_cat_tables, to_mont=to_mont)
        np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.mark.parametrize("from_top", [0, 1])
def test_centered_lift_pass_twin(lift_ctx, from_top):
    """The centered lift of every digit as one loader (K2's weights,
    centered on the level's primes) equals the per-digit centered plans
    then the flat NTT, the CPU entry point, and hetpu's centered lift
    (mxu_fbc.lift_plan(...).apply per digit, concatenated, ntt_fwd)."""
    ctx, rctx, logn = lift_ctx
    lvl = ctx.num_data - 1 - from_top
    ks = ctx.keyswitch_plan(lvl)
    ft = ks.foreign_cat_tables
    y = _rand(50 + from_top, (2,), ctx.params.moduli[: lvl + 1], 1 << logn)
    yt = from_u32(y)
    lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.q[: lvl + 1], ft)
    got = ntt_passes.ntt_fwd_centered_passes_plain(
        yt, ks.lift_w, ft, cluster=ntt_passes.cluster_size(logn),
        q_src=ks.q[: lvl + 1], dig=ks.lift_dig)
    plain = fused_ntt.ntt_fwd_centered_lift_plain(yt, *lift)
    assert torch.equal(got, plain)
    assert torch.equal(fused_ntt.ntt_fwd_centered_lift(yt, *lift), plain)
    per_digit = [centered_fbc.lift_plan(ks, di).apply_plain(yt[..., lo:hi, :])
                 for di, (lo, hi) in enumerate(ks.digit_bounds)]
    assert torch.equal(got, ntt_fwd_plain(torch.cat(per_digit, dim=-2), ft))
    rks = rctx.keyswitch_plan(lvl)
    yj = jnp.asarray(y)
    accs = [jax.jit(mxu_fbc.lift_plan(rks, di).apply)(yj[..., lo:hi, :])
            for di, (lo, hi) in enumerate(rks.digit_bounds)]
    want = ref_ntt.ntt_fwd(jnp.concatenate(accs, axis=-2),
                           rks.foreign_cat_tables)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


def _centered_fbc_args(plan):
    return dict(q_src=plan.q_src, recip=plan.recip, p_mod=plan.p_mod)


@pytest.mark.parametrize("kind", ["moddown", "tail"])
def test_centered_fbc_pass_twin(lift_ctx, kind):
    """The centered conversion with its signed α as the loader equals the
    plan's apply_plain then the NTT ×R, the CPU entry point, and hetpu's
    mxu_fbc.fbc_plan(...).apply jitted then ntt_fwd_mont."""
    ctx, rctx, logn = lift_ctx
    lvl = ctx.num_data - 1
    if kind == "moddown":
        md, rmd = ctx.keyswitch_plan(lvl).moddown, rctx.keyswitch_plan(
            lvl).moddown
    else:
        md, rmd = (ctx.moddown_rescale_plan(lvl),
                   rctx.moddown_rescale_plan(lvl))
    plan = ctx.centered_fbc_plan(md.fbc)
    u = _rand(60 + len(kind), (2, 2), md.src_tables.primes, 1 << logn)
    ut = from_u32(u)
    got = ntt_passes.ntt_fwd_centered_passes_plain(
        ut, plan.c.T, md.dst_tables, cluster=ntt_passes.cluster_size(logn),
        to_mont=True, **_centered_fbc_args(plan))
    plain = fused_ntt.ntt_fwd_centered_fbc_plain(ut, plan, md.dst_tables)
    assert torch.equal(got, plain)
    assert torch.equal(fused_ntt.ntt_fwd_centered_fbc(ut, plan,
                                                      md.dst_tables), plain)
    conv = jax.jit(mxu_fbc.fbc_plan(rmd.fbc).apply)(jnp.asarray(u))
    want = ref_ntt.ntt_fwd_mont(conv, rmd.dst_tables)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.fixture(scope="module", params=["dnum", "n4096"])
def centered_tail_ties(request):
    """(plan, hetpu's plan, centered near-tie columns [S, 4]) of a fused
    tail."""
    params, ties = ((preset("test_dnum"), TIES_DNUM_CENTERED)
                    if request.param == "dnum"
                    else (P4096, TIES_4096_CENTERED))
    ctx = Context(params, "cpu")
    lvl = ctx.num_data - 1
    rplan = RefContext(params).moddown_rescale_plan(lvl)
    return (ctx, ctx.moddown_rescale_plan(lvl), rplan,
            np.array(ties, dtype=np.uint32).T)


def test_centered_fbc_pass_twin_on_near_ties(centered_tail_ties,
                                             monkeypatch):
    """[1, 2, S, N] of the tiled centered near-tie columns through the
    centered conversion's twin, at the kernel's cluster (2 at N = 2^10, 8
    at 2^12), equals ntt_fwd_centered_fbc_plain and hetpu's jitted
    _fbc_fwd_mont with HETPU_MXU_FBC=1."""
    ctx, md, rmd, ties = centered_tail_ties
    n = md.dst_tables.n
    cols = np.tile(ties, (1, n // ties.shape[1]))
    y = np.stack([cols, np.roll(cols, 1, axis=1)])[None]
    u = from_u32(y)
    plan = ctx.centered_fbc_plan(md.fbc)
    got = ntt_passes.ntt_fwd_centered_passes_plain(
        u, plan.c.T, md.dst_tables,
        cluster=ntt_passes.cluster_size(n.bit_length() - 1), to_mont=True,
        **_centered_fbc_args(plan))
    assert torch.equal(got, fused_ntt.ntt_fwd_centered_fbc_plain(
        u, plan, md.dst_tables))
    monkeypatch.setenv("HETPU_MXU_FBC", "1")
    want = jax.jit(lambda v: ref_ev._fbc_fwd_mont(v, rmd.fbc,
                                                  rmd.dst_tables))
    np.testing.assert_array_equal(to_u32(got), np.asarray(want(jnp.asarray(y))))


@pytest.mark.parametrize("from_top", [0, 1])
def test_lift_w_is_the_centered_lift_c(lift_ctx, from_top):
    """K2's weights are the transposed C of the digits' centered lift
    plans (and their Shoup companions), zero on a short digit's padded
    terms: so ntt_fwd_centered reads lift_w / lift_ws for the centered
    lift."""
    ctx, _, _ = lift_ctx
    lvl = ctx.num_data - 1 - from_top
    ks = ctx.keyswitch_plan(lvl)
    for di, (lo, hi) in enumerate(ks.digit_bounds):
        plan = centered_fbc.lift_plan(ks, di)
        rows = ks.lift_dig == di
        for w, c in ((ks.lift_w, plan.c), (ks.lift_ws, plan.c_shoup)):
            assert torch.equal(w[rows, : hi - lo], c.T)
            assert (w[rows, hi - lo:] == 0).all()


def test_centered_entry_points_refuse_bad_input():
    ctx = Context(preset("test_dnum"), "cpu")
    lvl = ctx.num_data - 1
    md = ctx.moddown_rescale_plan(lvl)
    u = torch.zeros((2, len(md.src_tables.primes), 1024), dtype=torch.int32)
    extra = centered_fbc.fbc_plan(md.fbc, extra=np.arange(
        2, 2 + len(md.dst_tables.primes)))
    with pytest.raises(ValueError, match="extra"):
        fused_ntt.ntt_fwd_centered_fbc(u, extra, md.dst_tables)
    plan = ctx.centered_fbc_plan(md.fbc)
    with pytest.raises(ValueError):
        fused_ntt.ntt_fwd_centered_fbc(u[:, 1:].contiguous(), plan,
                                       md.dst_tables)
    ks = ctx.keyswitch_plan(lvl)
    with pytest.raises(ValueError):
        fused_ntt.ntt_fwd_centered_lift(
            torch.zeros((2, lvl, 1024), dtype=torch.int32), ks.lift_w,
            ks.lift_ws, ks.lift_dig, ks.q[: lvl + 1], ks.foreign_cat_tables)
