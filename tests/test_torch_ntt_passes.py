"""The pass schedule of the ``ntt`` and ``ntt_fwd_fbc`` kernels
(hetpu_torch/core/ntt_passes.py), on the CPU.

The kernels cannot run here; their plain twins walk the reordered
twiddle tables pass by pass and cluster rank by rank exactly as the
kernels index them.  They are held bit for bit against the flat
transforms of core/ntt.py at every logn 10..15 the kernels take (and
against hetpu's flat NTT at logn 10 and 15), for every epilogue, split
over the cluster the kernels launch there (2, 4, 8 CTAs a plane); the K3
twin against ``ntt_fwd_fbc_plain`` and hetpu's jitted ``_fbc_fwd_mont`` on
the near-tie α columns at N = 2^10 and 2^12 (clusters of 2 and 8).  The
shared-memory swizzle is checked to give every warp of every pass, for
every cluster size, 32 distinct banks."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from hetpu.core import evaluator as ref_ev
from hetpu.core import ntt as ref_ntt
from hetpu.core.context import Context as RefContext
from hetpu_torch.core import fused_ntt, ntt_passes
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.nt import gen_primes
from hetpu_torch.core.ntt import build_tables, ntt_fwd_plain, ntt_inv_plain
from hetpu_torch.core.params import ckks_params, preset

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


# test_dnum fused-tail sources (q_7 + 3 specials): near-tie α columns
# (tests/test_torch_alpha.py checks that they are ties)
TIES_DNUM = [[508039856, 1099080352, 1621637186, 1631625018],
             [37419502, 309566830, 1767178876, 1069488476],
             [454505166, 586600971, 1777398114, 2095414402],
             [92054122, 59180148, 1858753445, 1119026592]]


# N=4096, levels=5, 2 specials: sources of the fused tail at level 5
# (tests/test_torch_alpha.py checks that they are ties)
TIES_4096 = [[192642151, 508515651, 179833393],
             [860224061, 1866548870, 1781166677],
             [666931458, 1028692039, 858318483],
             [420010767, 1906473318, 474437857]]
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
