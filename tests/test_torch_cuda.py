"""hetpu_torch's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; each test skips where no CUDA device is present).

Imports neither JAX nor hetpu, so it also runs on a GPU host without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets up JAX for the reference tests.)
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from hetpu_torch.bfv import BfvSession
from hetpu_torch.core import (centered_fbc, cuda_lib, fused_ntt, ip_kernel,
                              serial)
from hetpu_torch.core.bfv import BfvScheme
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import from_u32, shoup_companion, to_u32
from hetpu_torch.core.nt import gen_primes
from hetpu_torch.core.ntt import (build_tables, ntt_fwd, ntt_fwd_plain,
                                  ntt_inv, ntt_inv_plain)
from hetpu_torch.core.params import ckks_params, preset
from hetpu_torch.fft import bfft
from hetpu_torch.linalg import BatchedMatrix, Matrix
from hetpu_torch.offload import (pipeline, recv_request, send_reply,
                                 send_request)
from hetpu_torch.offload.client import Client
from hetpu_torch.offload.server import handle
from hetpu_torch.probes import copy as copy_probe
from hetpu_torch.probes import dot, kernel_parts, overhead2
from hetpu_torch.session import Session
from torch_ties import (TIES_DNUM, TIES_DNUM_CENTERED,
                        TIES_N14_TAIL_CENTERED)
import torch_parallel_ranks as ranks
import torch_demo_cases
import torch_profile_cases

pytestmark = pytest.mark.cuda

GOLD = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _res(rng, shape, primes, dev):
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    return from_u32(rng.integers(0, 1 << 62, shape, dtype=np.uint64) % q, dev)


@pytest.mark.parametrize("logn", range(10, 16))
@pytest.mark.parametrize("epi", ["fwd", "fwd_mont", "inv", "inv_strip",
                                 "inv_strip_extra"])
def test_ntt_kernel(dev, logn, epi):
    """Every N the kernel takes, so every cluster size it launches (2 CTAs
    a plane at logn 10, 4 at 11, 8 from 12)."""
    n = 1 << logn
    primes = gen_primes(31, 3, 2 * n)
    t = build_tables(n, primes, dev)
    rng = np.random.default_rng(logn)
    x = _res(rng, (2, 3, n), primes, dev)
    extra = _res(rng, (3, 1), primes, dev)
    if epi.startswith("fwd"):
        kw = dict(to_mont=epi == "fwd_mont")
        got, want = ntt_fwd(x, t, **kw), ntt_fwd_plain(x, t, **kw)
    else:
        kw = dict(strip_mont=epi != "inv",
                  extra=extra if epi == "inv_strip_extra" else None)
        got, want = ntt_inv(x, t, **kw), ntt_inv_plain(x, t, **kw)
    assert torch.equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("lead", [(1, 1), (8, 2, 1), (8, 9), (8, 2, 5),
                                  (32, 9)])
def test_ntt_kernel_planes(dev, lead, inverse):
    """1, 16, 72, 80 and 288 planes of N=2^14 (the path's counts, and the
    probes'): launches of 8 to 2304 CTAs in clusters of 8."""
    n, L = 1 << 14, lead[-1]
    primes = gen_primes(31, L, 2 * n)
    t = build_tables(n, primes, dev)
    x = _res(np.random.default_rng(sum(lead)), (*lead, n), primes, dev)
    if inverse:
        assert torch.equal(ntt_inv(x, t, strip_mont=True),
                           ntt_inv_plain(x, t, strip_mont=True))
    else:
        assert torch.equal(ntt_fwd(x, t, to_mont=True),
                           ntt_fwd_plain(x, t, to_mont=True))


def test_ntt_golden_n14(dev):
    z = np.load(GOLD / "golden_n14.npz")
    t = build_tables(16384, tuple(int(p) for p in z["ntt_n14_primes"]), dev)
    x = from_u32(z["ntt_n14_x"], dev)
    np.testing.assert_array_equal(to_u32(ntt_fwd(x, t)), z["ntt_n14_fwd"])
    np.testing.assert_array_equal(to_u32(ntt_inv(x, t)), z["ntt_n14_inv"])


@pytest.fixture(scope="module")
def ctx(dev):
    return Context(ckks_params(1 << 12, levels=5, scale_bits=30,
                               num_special=2, first_prime_bits=31,
                               special_prime_bits=31, sec_level=0), dev)


@pytest.mark.parametrize("level", [5, 4])
def test_lifted_kernel(dev, ctx, level):
    """Level 4 has a short last digit: a clamped source plane."""
    ks = ctx.keyswitch_plan(level)
    y = _res(np.random.default_rng(level), (3, level + 1, 4096),
             ctx.params.moduli[: level + 1], dev)
    args = (y, ks.lift_w, ks.lift_ws, ks.lift_dig, ks.foreign_cat_tables)
    for to_mont in (False, True):
        assert torch.equal(fused_ntt.ntt_fwd_lifted(*args, to_mont=to_mont),
                           fused_ntt.ntt_fwd_lifted_plain(*args,
                                                          to_mont=to_mont))


_CTX = {}


def _small_ctx(dev, logn):
    """levels=5, 2 specials (α = 2, 3 digits at the top, a short last
    digit one level down) at N = 2^logn, one per logn."""
    if logn not in _CTX:
        _CTX[logn] = Context(ckks_params(1 << logn, levels=5, scale_bits=30,
                                         num_special=2, first_prime_bits=31,
                                         special_prime_bits=31, sec_level=0),
                             dev)
    return _CTX[logn]


@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("level", [5, 4])
@pytest.mark.parametrize("logn", range(10, 16))
def test_lifted_kernel_every_cluster(dev, logn, level, rows):
    """K2 at every N it takes, so every cluster size (2, 4, 8 CTAs a
    plane), with 1, 8 and 16 rows, full and short last digits, both
    epilogues."""
    ctx = _small_ctx(dev, logn)
    ks = ctx.keyswitch_plan(level)
    y = _res(np.random.default_rng(logn * rows + level), (rows, level + 1,
                                                          1 << logn),
             ctx.params.moduli[: level + 1], dev)
    args = (y, ks.lift_w, ks.lift_ws, ks.lift_dig, ks.foreign_cat_tables)
    for to_mont in (False, True):
        before = cuda_lib.launches["ntt_fwd_lifted"]
        got = fused_ntt.ntt_fwd_lifted(*args, to_mont=to_mont)
        assert cuda_lib.launches["ntt_fwd_lifted"] == before + 1
        assert torch.equal(got, fused_ntt.ntt_fwd_lifted_plain(
            *args, to_mont=to_mont))


@pytest.mark.parametrize("kind", ["lift", "lift_short", "moddown", "tail"])
@pytest.mark.parametrize("logn", [10, 11, 12])
def test_centered_kernel_every_cluster(dev, logn, kind):
    """ntt_fwd_centered at an N of each cluster size it launches: the
    centered lift of every digit in one launch (full and short last
    digit), and the centered mod-down and tail conversions with α."""
    ctx = _small_ctx(dev, logn)
    n = 1 << logn
    rng = np.random.default_rng(logn + len(kind))
    before = cuda_lib.launches["ntt_fwd_centered"]
    if kind.startswith("lift"):
        level = 4 if kind == "lift_short" else 5
        ks = ctx.keyswitch_plan(level)
        y = _res(rng, (3, level + 1, n), ctx.params.moduli[: level + 1], dev)
        lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.q[: level + 1],
                ks.foreign_cat_tables)
        got = fused_ntt.ntt_fwd_centered_lift(y, *lift)
        want = fused_ntt.ntt_fwd_centered_lift_plain(y, *lift)
    else:
        md = (ctx.keyswitch_plan(5).moddown if kind == "moddown"
              else ctx.moddown_rescale_plan(5))
        plan = ctx.centered_fbc_plan(md.fbc)
        u = _res(rng, (2, 2, plan.S, n), md.src_tables.primes, dev)
        got = fused_ntt.ntt_fwd_centered_fbc(u, plan, md.dst_tables)
        want = fused_ntt.ntt_fwd_centered_fbc_plain(u, plan, md.dst_tables)
    assert cuda_lib.launches["ntt_fwd_centered"] == before + 1
    assert torch.equal(got, want)


def test_fbc_kernel(dev, ctx):
    mdr = ctx.moddown_rescale_plan(5)
    u = _res(np.random.default_rng(3), (2, 2, len(mdr.src_tables.primes),
                                        4096), mdr.src_tables.primes, dev)
    for to_mont in (False, True):
        assert torch.equal(
            fused_ntt.ntt_fwd_fbc(u, mdr.fbc, mdr.dst_tables, to_mont=to_mont),
            fused_ntt.ntt_fwd_fbc_plain(u, mdr.fbc, mdr.dst_tables,
                                        to_mont=to_mont))


@pytest.mark.parametrize("logn", [10, 11, 12])
def test_fbc_kernel_every_cluster(dev, logn):
    """K3 at an N of each cluster size it launches: 2, 4, 8 CTAs a
    plane."""
    n = 1 << logn
    mdr = Context(ckks_params(n, levels=3, scale_bits=30, num_special=2,
                              first_prime_bits=31, special_prime_bits=31,
                              sec_level=0), dev).moddown_rescale_plan(3)
    src = mdr.src_tables.primes
    u = _res(np.random.default_rng(logn), (2, 2, len(src), n), src, dev)
    assert torch.equal(fused_ntt.ntt_fwd_fbc(u, mdr.fbc, mdr.dst_tables),
                       fused_ntt.ntt_fwd_fbc_plain(u, mdr.fbc,
                                                   mdr.dst_tables))


@pytest.mark.parametrize("kind", ["tail", "moddown"])
def test_fbc_kernel_bench_n14(dev, n14, kind):
    """K3 at the bench_n14 B=8 shapes: the tail [8,2,6,N]→[8,2,8,N] and
    the mod-down [8,2,5,N]→[8,2,9,N]."""
    plan = (n14.moddown_rescale_plan(8) if kind == "tail"
            else n14.keyswitch_plan(8).moddown)
    src = plan.src_tables.primes
    u = _res(np.random.default_rng(len(kind)), (8, 2, len(src), 16384), src,
             dev)
    assert torch.equal(fused_ntt.ntt_fwd_fbc(u, plan.fbc, plan.dst_tables),
                       fused_ntt.ntt_fwd_fbc_plain(u, plan.fbc,
                                                   plan.dst_tables))


@pytest.mark.parametrize("lead", [(), (5,)])
def test_inner_product_kernel(dev, ctx, lead):
    ks = ctx.keyswitch_plan(5)
    primes = ks.basis_tables.primes
    rng = np.random.default_rng(4)
    ext = _res(rng, (*lead, ks.num_digits, len(primes), 4096), primes, dev)
    k = _res(rng, (ks.num_digits, 2, len(primes), 4096), primes, dev)
    k_sh = shoup_companion(k, ks.q)
    assert torch.equal(ip_kernel.inner_product(ext, k, k_sh, ks.q),
                       ip_kernel.inner_product_plain(ext, k, k_sh, ks.q))


# K4 at every path shape of PERF.md row 4 (B, J, R, N) and at edge batches
# and digit counts (ragged batch tiles, J = 1 .. 27)
IP_PATH_SHAPES = [(8, 2, 14, 1 << 14), (8, 4, 9, 1 << 14),
                  (1, 7, 29, 1 << 15), (1, 4, 20, 1 << 15),
                  (64, 4, 14, 1 << 14), (1, 27, 28, 1 << 15),
                  (64, 3, 8, 1 << 13), (4, 4, 9, 1 << 14)]
IP_EDGES = [(B, J, 9, 1 << 13) for B in (1, 3, 8, 64) for J in (1, 2, 7, 27)]


@pytest.mark.parametrize("B,J,R,N", IP_PATH_SHAPES + IP_EDGES)
def test_inner_product_shapes(dev, B, J, R, N):
    primes = gen_primes(30, R, 2 * N)
    rng = np.random.default_rng(B * 100 + J)
    ext = _res(rng, (B, J, R, N), primes, dev)
    k = _res(rng, (J, 2, R, N), primes, dev)
    q = from_u32(np.array(primes, dtype=np.uint64).reshape(R, 1), dev)
    k_sh = shoup_companion(k, q)
    assert torch.equal(ip_kernel.inner_product(ext, k, k_sh, q),
                       ip_kernel.inner_product_plain(ext, k, k_sh, q))


def test_inner_product_refuses_unaligned(dev):
    q = torch.full((1, 1), 12289, dtype=torch.int32, device=dev)
    k = torch.zeros((1, 2, 1, 64), dtype=torch.int32, device=dev)
    ext = torch.zeros(65, dtype=torch.int32, device=dev)[1:].view(1, 1, 64)
    with pytest.raises(ValueError, match="aligned"):
        ip_kernel.inner_product(ext, k, k, q)
    with pytest.raises(ValueError, match="multiple of 4"):
        ip_kernel.inner_product(torch.zeros((1, 1, 6), dtype=torch.int32,
                                            device=dev),
                                k[..., :6].contiguous(),
                                k[..., :6].contiguous(), q)


def test_wrappers_refuse_bad_input(dev, ctx):
    t = ctx.tables(5)
    x = torch.zeros((2, 6, 4096), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ntt_fwd(x.transpose(0, 1), t)
    with pytest.raises(TypeError):
        ntt_fwd(x.to(torch.int64), t)
    with pytest.raises(ValueError):
        ntt_fwd(x[..., :2048].contiguous(), t)


def test_slice_golden_and_counters(dev):
    z = np.load(GOLD / "golden_pins.npz")
    cuda_lib.reset_launches()
    sess = Session.create("test_dnum", seed=b"\x33" * 32, galois_steps=[1],
                          device=dev)
    proto = sess.encrypt(0.0)
    a = proto.with_(data=from_u32(z["fused_a"], dev))
    b = proto.with_(data=from_u32(z["fused_b"], dev))
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    np.testing.assert_array_equal(to_u32(out.data), z["fused_out"])
    counts = cuda_lib.launches
    assert all(counts[k] > 0 for k in ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                                       "inner_product")), counts
    # default FBC path
    assert counts["centered_fbc"] == counts["ntt_fwd_centered"] == 0, counts


def test_bench_n14_b1_equals_cpu(dev):
    sess = Session.create("bench_n14", seed=b"\x21" * 32, galois_steps=[1],
                          device=dev)
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-1, 1, (2, sess.slots))
    a, b = sess.encrypt(x), sess.encrypt(y)
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    assert np.abs(sess.decrypt(out).real - x * y).max() < 2e-3
    ref = Evaluator(Context(preset("bench_n14"), "cpu")).multiply_relin_rescale(
        a.to("cpu"), b.to("cpu"), sess.rk.to("cpu"))
    assert torch.equal(out.data.cpu(), ref.data)


# ----------------------------------------------------------------------
# centered_fbc (K5) and its path form ntt_fwd_centered, the α near-ties
# (K3, K5), rotation and inference
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def n14(dev):
    return Context(preset("bench_n14"), dev)


@pytest.mark.parametrize("kind", ["lift0", "lift1", "moddown", "tail",
                                  "tail_extra"])
def test_centered_fbc_kernel(dev, n14, kind):
    """The bench_n14 B=8 shapes at level 8: lift [8,5,N]→[8,9,N] and
    [8,4,N]→[8,10,N], mod-down [8,2,5,N]→[8,2,9,N], tail
    [8,2,6,N]→[8,2,8,N]."""
    lvl = 8
    if kind.startswith("lift"):
        plan = centered_fbc.lift_plan(n14.keyswitch_plan(lvl), int(kind[-1]))
        lead = (8,)
    elif kind == "moddown":
        plan = n14.centered_fbc_plan(n14.keyswitch_plan(lvl).moddown.fbc)
        lead = (8, 2)
    else:
        fbc = n14.moddown_rescale_plan(lvl).fbc
        plan = (n14.centered_fbc_plan(fbc) if kind == "tail" else
                centered_fbc.fbc_plan(fbc, extra=np.arange(5, 5 + 8)))
        lead = (8, 2)
    y = _res(np.random.default_rng(len(kind)), (*lead, plan.S, 16384),
             to_u32(plan.q_src)[:, 0], dev)
    before = cuda_lib.launches["centered_fbc"]
    got = plan.apply(y)
    assert cuda_lib.launches["centered_fbc"] == before + 1
    assert got.shape == (*lead, plan.F, 16384)
    assert torch.equal(got, plan.apply_plain(y))


K5_EDGE_PRIMES = gen_primes(31, 16 + 25, 2048)


@pytest.mark.parametrize("S", [1, 6, 16])
@pytest.mark.parametrize("F", [1, 8, 25])
@pytest.mark.parametrize("terms", ["plain", "alpha", "alpha_extra", "extra"])
def test_centered_fbc_edges(dev, S, F, terms):
    """K5 exact at the edges of its tile walk and of its 64-bit sums: S 1,
    6 and 16 source primes (the 16 reduce the sum twice, after 7 and 14
    terms), F 1, 8 and 25 targets, 1, 3 and 16 rows of N = 1024, with and
    without α and ``extra``, on 31-bit primes (centered values and
    constants near 2^30); uniform residues plus each source's 0, q − 1,
    ⌊q/2⌋ and ⌊q/2⌋ + 1 in the first columns."""
    rng = np.random.default_rng(S * 100 + F)
    src, dst = K5_EDGE_PRIMES[:S], K5_EDGE_PRIMES[16:16 + F]
    C = rng.integers(0, 1 << 31, (S, F), dtype=np.uint64)
    alpha = (rng.integers(0, 1 << 31, F, dtype=np.uint64)
             if "alpha" in terms else None)
    extra = (rng.integers(1, 1 << 31, F, dtype=np.uint64)
             if "extra" in terms else None)
    plan = centered_fbc.CenteredFbcPlan(src, dst, C, alpha, extra,
                                        device=dev)
    q = np.array(src, dtype=np.uint64).reshape(-1, 1)
    for rows in (1, 3, 16):
        y = rng.integers(0, 1 << 62, (rows, S, 1024), dtype=np.uint64) % q
        y[..., :4] = np.concatenate([0 * q, q - 1, q // 2, q // 2 + 1],
                                    axis=1)
        y = from_u32(y, dev)
        assert torch.equal(plan.apply(y), plan.apply_plain(y))


@pytest.mark.parametrize("ties", ["n14_tail", "dnum"])
def test_centered_fbc_near_ties(dev, n14, ties):
    """K5 on centered near-tie α columns (``tests/torch_ties.py``): the
    bench_n14 tail at level 8, and test_dnum's fused tail at its top level,
    each tiled over [8, 2, S, N]."""
    if ties == "n14_tail":
        ctx, cols = n14, TIES_N14_TAIL_CENTERED
        plan = ctx.centered_fbc_plan(ctx.moddown_rescale_plan(8).fbc)
    else:
        ctx, cols = Context(preset("test_dnum"), dev), TIES_DNUM_CENTERED
        plan = ctx.centered_fbc_plan(
            ctx.moddown_rescale_plan(ctx.num_data - 1).fbc)
    n = ctx.params.poly_degree
    cols = np.array(cols, dtype=np.uint64).T                  # [S, count]
    assert cols.shape[0] == plan.S
    y = from_u32(np.tile(cols, (8, 2, 1, n // cols.shape[1] + 1))[..., :n],
                 dev)
    assert torch.equal(plan.apply(y), plan.apply_plain(y))


@pytest.mark.parametrize("kind", ["lift", "moddown", "tail", "tail_ties"])
def test_centered_ntt_kernel_bench_n14(dev, n14, kind):
    """ntt_fwd_centered at the bench_n14 B=8 shapes at level 8: the lift
    of both digits [8,9,N]→[8,19,N], mod-down [8,2,5,N]→[8,2,9,N], tail
    [8,2,6,N]→[8,2,8,N], and the tail on centered near-tie α columns."""
    lvl, n = 8, 16384
    if kind == "lift":
        ks = n14.keyswitch_plan(lvl)
        y = _res(np.random.default_rng(7), (8, lvl + 1, n),
                 n14.params.moduli[: lvl + 1], dev)
        lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.q[: lvl + 1],
                ks.foreign_cat_tables)
        got = fused_ntt.ntt_fwd_centered_lift(y, *lift)
        assert got.shape == (8, 19, n)
        assert torch.equal(got, fused_ntt.ntt_fwd_centered_lift_plain(
            y, *lift))
        return
    md = (n14.keyswitch_plan(lvl).moddown if kind == "moddown"
          else n14.moddown_rescale_plan(lvl))
    plan = n14.centered_fbc_plan(md.fbc)
    if kind == "tail_ties":
        cols = np.array(TIES_N14_TAIL_CENTERED, dtype=np.uint32).T
        u = from_u32(np.tile(cols, (8, 2, 1, n // cols.shape[1])), dev)
    else:
        u = _res(np.random.default_rng(len(kind)), (8, 2, plan.S, n),
                 md.src_tables.primes, dev)
    got = fused_ntt.ntt_fwd_centered_fbc(u, plan, md.dst_tables)
    assert got.shape == (8, 2, plan.F, n)
    assert torch.equal(got, fused_ntt.ntt_fwd_centered_fbc_plain(
        u, plan, md.dst_tables))


def test_alpha_ties_on_the_card(dev):
    """K3 and K5 round α on the near-tie columns as their plain versions
    (the fma chain of hetpu's jitted α)."""
    ctx = Context(preset("test_dnum"), dev)
    mdr = ctx.moddown_rescale_plan(ctx.num_data - 1)
    cols = lambda t: np.tile(np.array(t, dtype=np.uint32).T, (1, 256))[None]
    u = from_u32(cols(TIES_DNUM), dev)
    assert torch.equal(fused_ntt.ntt_fwd_fbc(u, mdr.fbc, mdr.dst_tables),
                       fused_ntt.ntt_fwd_fbc_plain(u, mdr.fbc,
                                                   mdr.dst_tables))
    plan = ctx.centered_fbc_plan(mdr.fbc)
    y = from_u32(cols(TIES_DNUM_CENTERED), dev)
    assert torch.equal(plan.apply(y), plan.apply_plain(y))
    assert torch.equal(
        fused_ntt.ntt_fwd_centered_fbc(y, plan, mdr.dst_tables),
        fused_ntt.ntt_fwd_centered_fbc_plain(y, plan, mdr.dst_tables))


def test_fused_rot_golden_on_the_card(dev):
    z = np.load(GOLD / "golden_pins.npz")
    sess = Session.create("test_dnum", seed=b"\x33" * 32, galois_steps=[1],
                          device=dev)
    proto = sess.encrypt(0.0)
    a = proto.with_(data=from_u32(z["fused_a"], dev))
    b = proto.with_(data=from_u32(z["fused_b"], dev))
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    rot = sess.ev.rotate(out, 1, sess.gk)
    np.testing.assert_array_equal(to_u32(rot.data), z["fused_rot"])


@pytest.mark.parametrize("centered", [False, True])
def test_infer_step_card_equals_cpu(dev, centered):
    sess = Session.create("test_dnum", seed=b"\x37" * 32,
                          galois_steps=[1, 2, 3], device=dev,
                          centered_fbc=centered)
    x = np.random.default_rng(3).uniform(-1, 1, (2, sess.slots))
    ct = sess.encrypt(x[0])
    ct = ct.with_(data=torch.stack([ct.data, sess.encrypt(x[1]).data]))
    diags, act = pipeline._infer_weights(sess.slots, 4, 7)
    cuda_lib.reset_launches()
    out = pipeline.infer_step(sess, ct, diags, act)
    counts = cuda_lib.launches
    assert (counts["ntt_fwd_centered"] > 0) == centered, counts
    # the centered path fuses every lift and conversion into
    # ntt_fwd_centered; the default path never launches it
    off = ("centered_fbc", "ntt_fwd_lifted", "ntt_fwd_fbc") if centered \
        else ("centered_fbc",)
    assert all(counts[k] == 0 for k in off), counts
    dec = sess.decrypt(out).real
    for i in range(2):
        assert np.abs(dec[i] - pipeline.infer_reference(x[i], diags, act)
                      ).max() < 5e-3
    cpu = Session.from_wire(sess.ctx.params, sess.rk, sess.gk, device="cpu",
                            centered_fbc=centered)
    ref = pipeline.infer_step(cpu, ct.to("cpu"), diags, act)
    assert torch.equal(out.data.cpu(), ref.data)


# ----------------------------------------------------------------------
# the probes' kernels P1–P4 (hetpu_torch/probes)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape,rb,flat", [((32, 9, 128, 128), 8, False),
                                           ((32, 9, 128, 128), 32, True),
                                           ((288, 128, 128), 8, False),
                                           ((4, 3, 8, 8), 2, True),
                                           ((32, 9, 128, 128), 8, True),
                                           ((32, 9, 128, 128), 1, False),
                                           ((4, 3, 8, 8), 2, False)])
def test_copy_planes_kernel(dev, shape, rb, flat):
    x = copy_probe.planes_u32(shape, seed=len(shape) + rb, device=dev)
    before = cuda_lib.launches["copy_planes"]
    assert torch.equal(copy_probe.copy_planes(x, rb, flat), x)
    assert cuda_lib.launches["copy_planes"] == before + 1


def test_muladd_u32_kernel(dev):
    x = from_u32(np.random.default_rng(5).integers(
        0, 1 << 32, (32, 9, 128, 128), dtype=np.uint64).astype(np.uint32),
        dev)
    assert torch.equal(overhead2.muladd_u32(x), overhead2.muladd_u32_plain(x))


@pytest.mark.parametrize("pair", [p[0] for p in dot.PAIRS])
def test_dot_i8_pairs(dev, pair):
    _, la, ra = next(p for p in dot.PAIRS if p[0] == pair)
    a, b = dot.pair_inputs(la, ra)
    a, b = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)[None]
    assert torch.equal(dot.dot_i8(a, b), dot.dot_i8_plain(a, b))


@pytest.mark.parametrize("batch,ppb", [(1, 1), (19, 1), (19, 8), (288, 1),
                                       (288, 8)])
def test_dot_i8_batched(dev, batch, ppb):
    w, a = dot.int8_mxu_inputs(batch, seed=batch, device=dev)
    assert torch.equal(dot.dot_i8(w, a, ppb), dot.dot_i8_plain(w, a))


@pytest.mark.parametrize("pair", [p[0] for p in dot.PAIRS])
@pytest.mark.parametrize("M,K,batch,ppb", [(320, 96, 19, 8),
                                           (192, 1024, 5, 2),
                                           (64, 32, 3, 1)])
def test_dot_i8_edges(dev, pair, M, K, batch, ppb):
    """Slabs past M (clipped stores, zero-filled A), K not a multiple of
    the 128-byte chunk, the K = 1024 slab of 128 rows, one 64-row slab."""
    _, la, ra = next(p for p in dot.PAIRS if p[0] == pair)
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.integers(0, 256, (M, K)).astype(la)).to(dev)
    b = torch.from_numpy(rng.integers(0, 256, (batch, K, 128))
                         .astype(ra)).to(dev)
    assert torch.equal(dot.dot_i8(a, b, ppb), dot.dot_i8_plain(a, b))


@pytest.mark.parametrize("variant", ["copy", "dot", "dot2", "extract",
                                     "twiddle", "recomb"])
def test_plane_parts_kernel(dev, variant):
    x, w, tw, tws = kernel_parts.make_inputs(rows=2, limbs=3, seed=3,
                                             device=dev)
    x[0, 0, 0, :4] = torch.tensor([-1, -2**31, 2**31 - 1, 536870912],
                                  dtype=torch.int32)
    got = kernel_parts.plane_parts(variant, x, w, tw, tws)
    assert torch.equal(got, kernel_parts.plane_parts_plain(variant, x, w,
                                                           tw, tws))


@pytest.mark.parametrize("variant", kernel_parts.VARIANTS)
@pytest.mark.parametrize("rows", [1, 5, 32])
@pytest.mark.parametrize("limbs", [1, 3, 9])
def test_plane_parts_edges(dev, variant, rows, limbs):
    """Rows 1, 5, 32 by limbs 1, 3, 9 (at 5 x 9 and 32 x 9 the clusters'
    ranges cross limb boundaries), with the extreme int32 values."""
    x, w, tw, tws = kernel_parts.make_inputs(rows=rows, limbs=limbs,
                                             seed=rows * 10 + limbs,
                                             device=dev)
    x[-1, -1, -1, -4:] = torch.tensor([-1, -2**31, 2**31 - 1, 536870912],
                                      dtype=torch.int32)
    got = kernel_parts.plane_parts(variant, x, w, tw, tws)
    assert torch.equal(got, kernel_parts.plane_parts_plain(variant, x, w,
                                                           tw, tws))


def test_graph_replay_counts_its_launches(dev):
    """A call recorded into a CUDA graph is not counted as a launch; each
    replay counts the recorded launches; the cold-L2 time of one replayed
    call is positive."""
    from hetpu_torch import probes
    x = copy_probe.planes_u32((8, 1, 128, 128), device=dev)
    fn = lambda: overhead2.muladd_u32(copy_probe.copy_planes(x, 8))
    fn()                                         # builds the library
    before = dict(cuda_lib.launches)
    g = probes.Captured(fn)                      # one eager call, then capture
    assert g.kernels == {"copy_planes": 1, "muladd_u32": 1}
    assert cuda_lib.launches["copy_planes"] == before["copy_planes"] + 1
    for _ in range(3):
        g.replay()
    assert cuda_lib.launches["muladd_u32"] == before["muladd_u32"] + 4
    assert probes.cold_ms(fn, reps=2) > 0


def test_copy_and_dot_replay_in_a_graph(dev):
    """copy_planes (8b's flat blocks) and dot_i8 (tensor maps passed by
    value) capture into one CUDA graph; each replay recomputes both from
    the inputs' current contents and counts one launch of each."""
    from hetpu_torch import probes
    x = copy_probe.planes_u32((32, 9, 128, 128), device=dev)
    w, a = dot.int8_mxu_inputs(19, device=dev)
    got = {}
    fn = lambda: got.update(c=copy_probe.copy_planes(x, 8, True),
                            d=dot.dot_i8(w, a, 8))
    g = probes.Captured(fn)
    assert g.kernels == {"copy_planes": 1, "dot_i8": 1}
    before = dict(cuda_lib.launches)
    for seed in (1, 2):
        x.copy_(copy_probe.planes_u32(x.shape, seed=seed, device=dev))
        a.copy_(dot.int8_mxu_inputs(19, seed=seed, device=dev)[1])
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got["c"], x)
        assert torch.equal(got["d"], dot.dot_i8_plain(w, a))
    for k in ("copy_planes", "dot_i8"):
        assert cuda_lib.launches[k] == before[k] + 2


# ----------------------------------------------------------------------
# BFV (bfv_batch), the paired-prime rescale (ckks_hi14) and the wire
# format on the card
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def bfv14(dev):
    ctx = Context(preset("bfv_batch"), dev)
    return ctx, BfvScheme(ctx)


@pytest.fixture(scope="module")
def hi14(dev):
    return Context(preset("ckks_hi14"), dev)


@pytest.mark.parametrize("kind", ["q2", "q3", "b2", "b3", "t"])
def test_bfv_ntt_shapes(dev, bfv14, kind):
    """K1 at the BFV path's B=8 shapes: [8,2,7,N] and [8,3,7,N] over Q,
    [8,2,10,N] and [8,3,10,N] over the auxiliary basis, [1,N] over a t
    factor."""
    ctx, scheme = bfv14
    n = ctx.params.poly_degree
    lvl = scheme._lvl(6)
    t = {"q": ctx.tables(6), "b": lvl["tables_B"],
         "t": scheme.tables_t[scheme.t_factors[0]]}[kind[0]]
    assert len(lvl["B_primes"]) == 10
    shape = (1, n) if kind == "t" else (8, int(kind[1]), len(t.primes), n)
    x = _res(np.random.default_rng(len(kind)), shape, t.primes, dev)
    assert torch.equal(ntt_inv(x, t, strip_mont=True),
                       ntt_inv_plain(x, t, strip_mont=True))
    assert torch.equal(ntt_fwd(x, t, to_mont=True),
                       ntt_fwd_plain(x, t, to_mont=True))


def test_bfv_keyswitch_shapes(dev, bfv14):
    """K2 and the K6 lift [8,7,N]→[8,29,N] (α = 2, a short last digit),
    K3 and K6 mod-down [8,2,2,N]→[8,2,7,N], K4 at J=4, R=9."""
    ctx, _ = bfv14
    n = ctx.params.poly_degree
    ks = ctx.keyswitch_plan(6)
    rng = np.random.default_rng(61)
    y = _res(rng, (8, 7, n), ctx.params.moduli, dev)
    lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.foreign_cat_tables)
    got = fused_ntt.ntt_fwd_lifted(y, *lift)
    assert got.shape == (8, 29, n)
    assert torch.equal(got, fused_ntt.ntt_fwd_lifted_plain(y, *lift))
    clift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.q[:7],
             ks.foreign_cat_tables)
    assert torch.equal(fused_ntt.ntt_fwd_centered_lift(y, *clift),
                       fused_ntt.ntt_fwd_centered_lift_plain(y, *clift))
    md = ks.moddown
    u = _res(rng, (8, 2, 2, n), md.src_tables.primes, dev)
    assert torch.equal(fused_ntt.ntt_fwd_fbc(u, md.fbc, md.dst_tables),
                       fused_ntt.ntt_fwd_fbc_plain(u, md.fbc, md.dst_tables))
    plan = ctx.centered_fbc_plan(md.fbc)
    assert torch.equal(fused_ntt.ntt_fwd_centered_fbc(u, plan, md.dst_tables),
                       fused_ntt.ntt_fwd_centered_fbc_plain(u, plan,
                                                            md.dst_tables))
    primes = ks.basis_tables.primes
    assert (ks.num_digits, len(primes)) == (4, 9)
    ext = _res(rng, (8, 4, 9, n), primes, dev)
    k = _res(rng, (4, 2, 9, n), primes, dev)
    k_sh = shoup_companion(k, ks.q)
    assert torch.equal(ip_kernel.inner_product(ext, k, k_sh, ks.q),
                       ip_kernel.inner_product_plain(ext, k, k_sh, ks.q))


@pytest.mark.parametrize("kind", ["pair", "tail"])
def test_hi14_shapes(dev, hi14, kind):
    """The paired-prime path at ckks_hi14's top level: K1 INTT of the pair
    [8,2,2,N] or of the fused tail [8,2,5,N], then K3 and K6 onto the 10
    remaining primes."""
    plan = (hi14.group_rescale_plan(11) if kind == "pair"
            else hi14.moddown_rescale_plan(11))
    src = plan.src_tables.primes
    assert len(src) == (2 if kind == "pair" else 5)
    u = _res(np.random.default_rng(len(kind)), (8, 2, len(src), 16384), src,
             dev)
    kw = dict(strip_mont=True, extra=plan.fbc.inv_punit)
    assert torch.equal(ntt_inv(u, plan.src_tables, **kw),
                       ntt_inv_plain(u, plan.src_tables, **kw))
    dt = plan.dst_tables
    assert len(dt.primes) == 10
    assert torch.equal(fused_ntt.ntt_fwd_fbc(u, plan.fbc, dt),
                       fused_ntt.ntt_fwd_fbc_plain(u, plan.fbc, dt))
    cplan = hi14.centered_fbc_plan(plan.fbc)
    assert torch.equal(fused_ntt.ntt_fwd_centered_fbc(u, cplan, dt),
                       fused_ntt.ntt_fwd_centered_fbc_plain(u, cplan, dt))


def test_bfv_golden_on_the_card(dev):
    z = np.load(GOLD / "golden_pins.npz")
    bs = BfvSession.create("test_bfv_crt", seed=b"\x34" * 32,
                           galois_steps=[1], device=dev)
    proto = bs.encrypt(np.zeros(4, dtype=np.int64))
    out = bs.multiply_relin(proto.with_(data=from_u32(z["bfv_a"], dev)),
                            proto.with_(data=from_u32(z["bfv_b"], dev)))
    np.testing.assert_array_equal(to_u32(out.data), z["bfv_out"])


@pytest.mark.parametrize("centered", [False, True])
def test_bfv_card_equals_cpu(dev, centered):
    """test_bfv_crt on the card: multiply_relin, rotate_rows, mod_switch at
    B=2 decrypt exactly and equal the CPU plain path of the same keys;
    K1–K4 (or K1, K4, K6) launched."""
    kw = dict(seed=b"\x0b" * 32, galois_steps=[1], centered_fbc=centered)
    s = BfvSession.create("test_bfv_crt", device=dev, **kw)
    cpu = BfvSession.create("test_bfv_crt", device="cpu", **kw)
    t = s.ctx.params.plain_modulus
    xs = np.random.default_rng(5).integers(0, t, (2, 2, s.slots),
                                           dtype=np.uint64)
    enc = lambda sess, v, i: sess.encrypt(v, seed=bytes([i]) * 32)
    chain = lambda sess, a, b: sess.mod_switch(sess.rotate_rows(
        sess.multiply_relin(a, b), 1))
    a = [enc(s, v, i) for i, v in enumerate(xs[0])]
    b = [enc(s, v, 9 + i) for i, v in enumerate(xs[1])]
    st = lambda cs: cs[0].with_(data=torch.stack([c.data for c in cs]))
    cuda_lib.reset_launches()
    out = chain(s, st(a), st(b))
    counts = dict(cuda_lib.launches)
    on = ("ntt_fwd_centered",) if centered else ("ntt_fwd_lifted",
                                                 "ntt_fwd_fbc")
    assert all(counts[k] > 0 for k in ("ntt", "inner_product", *on)), counts
    ref = chain(cpu, st(a).to("cpu"), st(b).to("cpu"))
    assert torch.equal(out.data.cpu(), ref.data)
    half = s.slots // 2
    for i in range(2):
        prod = [int(x) * int(y) % t for x, y in zip(xs[0, i], xs[1, i])]
        want = prod[1:half] + prod[:1] + prod[half + 1:] + prod[half:half + 1]
        got = s.decrypt(out.with_(data=out.data[i]))
        assert [int(v) for v in got] == want
    assert s.noise_budget(out.with_(data=out.data[0])) > 0


@pytest.mark.parametrize("centered", [False, True])
def test_group_rescale_card_equals_cpu(dev, centered):
    """ckks_hi (rescale_group=2) on the card: the standalone pair rescale,
    the fused multiply_relin_rescale and square_relin_rescale equal the
    CPU plain path of the same keys; K3 (default) or K6 (centered)."""
    kw = dict(seed=b"\x42" * 32, galois_steps=[1], centered_fbc=centered)
    s = Session.create("ckks_hi", device=dev, **kw)
    cpu = Session.from_wire(s.ctx.params, s.rk, s.gk, device="cpu",
                            centered_fbc=centered)
    x = np.random.default_rng(8).uniform(-1, 1, (2, s.slots))
    a = s.encryptor.encrypt_symmetric(s.encode(x[0]), seed=b"\x01" * 32)
    b = s.encryptor.encrypt_symmetric(s.encode(x[1]), seed=b"\x02" * 32)
    ops = {"rescale": lambda z, a, b: z.ev.rescale(z.ev.relinearize(
               z.ev.multiply(a, b), z.rk)),
           "fused": lambda z, a, b: z.ev.multiply_relin_rescale(a, b, z.rk),
           "square": lambda z, a, b: z.ev.square_relin_rescale(a, z.rk)}
    for name, op in ops.items():
        cuda_lib.reset_launches()
        got = op(s, a, b)
        counts = dict(cuda_lib.launches)
        assert got.level == a.level - 2, name
        assert (counts["ntt_fwd_centered"] > 0) == centered, (name, counts)
        assert (counts["ntt_fwd_fbc"] > 0) != centered, (name, counts)
        ref = op(cpu, a.to("cpu"), b.to("cpu"))
        assert torch.equal(got.data.cpu(), ref.data), name
    err = np.abs(s.decrypt(ops["fused"](s, a, b)).real - x[0] * x[1]).max()
    assert err < 1e-9, err


def test_serial_on_the_card(dev):
    """Blobs load onto the card to the tensors they were dumped from."""
    s = Session.create("test_dnum", seed=b"\x33" * 32, galois_steps=[1],
                       device=dev)
    ct = s.encrypt(0.5, seed=b"\x01" * 32)
    sym = s.encryptor.encrypt_symmetric(s.encode(0.5), seed=b"\x02" * 32)
    pt = s.encode(0.25)
    got = serial.load_ciphertext(serial.dump_ciphertext(ct), s.ctx)
    assert got.data.is_cuda and torch.equal(got.data, ct.data)
    got = serial.load_ciphertext(serial.dump_ciphertext(sym, seed=b"\x02" * 32),
                                 s.ctx)
    assert torch.equal(got.data, sym.data)
    got = serial.load_plaintext(serial.dump_plaintext(pt))
    assert got.data.is_cuda and torch.equal(got.shoup, pt.shoup)
    assert torch.equal(serial.load_public_key(serial.dump_public_key(
        s.encryptor.pk)).data, s.encryptor.pk.data)
    rk = serial.load_relin_keys(serial.dump_relin_keys(s.rk), s.ctx)
    gk = serial.load_galois_keys(serial.dump_galois_keys(s.gk), s.ctx)
    assert torch.equal(rk.key.shoup, s.rk.key.shoup)
    assert all(torch.equal(u.data, v.data) for u, v in zip(gk.keys,
                                                            s.gk.keys))
    wire = Session.from_wire(serial.load_params(serial.dump_params(
        s.ctx.params)), rk, gk, device=dev)
    assert torch.equal(wire.ev.multiply_relin_rescale(ct, ct, wire.rk).data,
                       s.ev.multiply_relin_rescale(ct, ct, s.rk).data)


# ----------------------------------------------------------------------
# the application layer's shapes (ckks_deep_hi at N=2^15, ckks_fft ×64)
# and its paths on the card against the CPU
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def deep_hi(dev):
    return Context(preset("ckks_deep_hi"), dev)


@pytest.mark.parametrize("kind", ["inv", "fwd", "basis", "moddown"])
def test_deep_hi_ntt_shapes(dev, deep_hi, kind):
    """K1 at N=2^15 (clusters of 8 CTAs of 512 threads, five register
    passes): the decompose INTT and the forward NTT over the 25 data
    primes, the forward NTT over the key basis R=29, the mod-down INTT of
    the 4 specials."""
    ks = deep_hi.keyswitch_plan(24)
    t, rows, kw = {
        "inv": (deep_hi.tables(24), (1,), dict(strip_mont=True,
                                                extra=ks.dig_inv)),
        "fwd": (deep_hi.tables(24), (1,), dict(to_mont=True)),
        "basis": (ks.basis_tables, (1,), dict(to_mont=True)),
        "moddown": (ks.moddown.src_tables, (1, 2),
                    dict(strip_mont=True, extra=ks.moddown.fbc.inv_punit)),
    }[kind]
    assert (len(deep_hi.tables(24).primes), len(ks.basis_tables.primes),
            ks.num_digits) == (25, 29, 7)
    x = _res(np.random.default_rng(len(kind)), (*rows, len(t.primes), 1 << 15),
             t.primes, dev)
    inv = kind in ("inv", "moddown")
    got = (ntt_inv if inv else ntt_fwd)(x, t, **kw)
    assert torch.equal(got, (ntt_inv_plain if inv else ntt_fwd_plain)(x, t,
                                                                       **kw))


def _keyswitch_shapes(ctx, rows, dev, seed):
    """K2 and the K6 lift of the top level, K3 and K6 for the mod-down,
    the fused rescale tail and (g=2) the pair, K4: each against its twin."""
    lvl = ctx.num_data - 1
    n = ctx.params.poly_degree
    ks = ctx.keyswitch_plan(lvl)
    rng = np.random.default_rng(seed)
    y = _res(rng, (rows, lvl + 1, n), ctx.params.moduli[: lvl + 1], dev)
    lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.foreign_cat_tables)
    assert torch.equal(fused_ntt.ntt_fwd_lifted(y, *lift),
                       fused_ntt.ntt_fwd_lifted_plain(y, *lift))
    clift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.q[: lvl + 1],
             ks.foreign_cat_tables)
    assert torch.equal(fused_ntt.ntt_fwd_centered_lift(y, *clift),
                       fused_ntt.ntt_fwd_centered_lift_plain(y, *clift))
    plans = [ks.moddown, ctx.moddown_rescale_plan(lvl)]
    if ctx.params.rescale_group == 2:
        plans.append(ctx.group_rescale_plan(lvl))
    for plan in plans:
        src, dt = plan.src_tables.primes, plan.dst_tables
        u = _res(rng, (rows, 2, len(src), n), src, dev)
        assert torch.equal(fused_ntt.ntt_fwd_fbc(u, plan.fbc, dt),
                           fused_ntt.ntt_fwd_fbc_plain(u, plan.fbc, dt))
        cplan = ctx.centered_fbc_plan(plan.fbc)
        assert torch.equal(fused_ntt.ntt_fwd_centered_fbc(u, cplan, dt),
                           fused_ntt.ntt_fwd_centered_fbc_plain(u, cplan, dt))
    primes = ks.basis_tables.primes
    ext = _res(rng, (rows, ks.num_digits, len(primes), n), primes, dev)
    k = _res(rng, (ks.num_digits, 2, len(primes), n), primes, dev)
    k_sh = shoup_companion(k, ks.q)
    assert torch.equal(ip_kernel.inner_product(ext, k, k_sh, ks.q),
                       ip_kernel.inner_product_plain(ext, k, k_sh, ks.q))


def test_deep_hi_keyswitch_shapes(dev, deep_hi):
    """ckks_deep_hi's top level at one row: the lift [1,25,N] → 7 digits
    over R=29, conversions from the 4 specials, the fused tail and the
    pair onto 23 primes (25-target α at the mod-down), K4 [1,7,29,N]."""
    _keyswitch_shapes(deep_hi, 1, dev, 71)


def test_fft64_keyswitch_shapes(dev):
    """ckks_fft's top level at 64 rows (bfft over 64 ciphertexts): the
    lift [64,11,N], the conversions, K4 [64,4,14,N]."""
    _keyswitch_shapes(Context(preset("ckks_fft"), dev), 64, dev, 72)


@pytest.fixture(scope="module")
def tiny_pair(dev):
    kw = dict(seed=b"\x0c" * 32, galois_steps=[1, 2, 3, -1, -2, -4, 4])
    s = Session.create("test_tiny", device=dev, **kw)
    cpu = Session.from_wire(s.ctx.params, s.rk, s.gk, device="cpu")
    return s, cpu


def test_matrix_card_equals_cpu(dev, tiny_pair):
    """Matrix (2×3 @ 3×2, one operand transposed) and BatchedMatrix
    diag×col (4×4) on the card equal the CPU path on the same inputs."""
    s, cpu = tiny_pair
    rng = np.random.default_rng(15)
    a = Matrix.encrypt(s, rng.uniform(-1, 1, (2, 3)))
    b = Matrix.encrypt(s, rng.uniform(-1, 1, (2, 3)))
    on = lambda m, sess: Matrix(sess, m.ct.to(sess.ctx.device), m.rows,
                                m.cols, m.transposed)
    got = a.matmul(b.transp()).ct.data
    assert torch.equal(got.cpu(), on(a, cpu).matmul(on(b, cpu).transp()
                                                    ).ct.data)
    A, B4 = rng.uniform(-1, 1, (2, 4, 4))
    ma = BatchedMatrix.encrypt(s, A, "diag")
    mb = BatchedMatrix.encrypt(s, B4, "col")
    cuda_lib.reset_launches()
    got = ma.matmul(mb).ct.data
    assert cuda_lib.launches["inner_product"] > 0
    mv = lambda m: BatchedMatrix(cpu, m.ct.to("cpu"), m.rows, m.cols,
                                 m.layout)
    assert torch.equal(got.cpu(), mv(ma).matmul(mv(mb)).ct.data)


def test_bfft_card_equals_cpu(dev, tiny_pair):
    """A 4-point in-slot FFT (the merged ±2 stage, then ±1): test_tiny's
    two levels."""
    s, cpu = tiny_pair
    sig = np.random.default_rng(16).uniform(-1, 1, 4)
    ct = s.encrypt(np.tile(sig, s.slots // 4))
    got = bfft(s, ct, 4).data
    assert torch.equal(got.cpu(), bfft(cpu, ct.to("cpu"), 4).data)


def test_server_reply_card_equals_cpu(dev):
    """One request (simple at test_tiny) served on the card and on the
    CPU: the reply frames are equal byte for byte."""
    class Wire:
        def __init__(self, frames=()):
            self.sent, self.frames = [], list(frames)

        def send(self, b):
            self.sent.append(bytes(b))

        def recv(self):
            return self.frames.pop(0)

    client = Client("test_tiny", galois_steps=[1], seed=b"\x05" * 32,
                    device=dev)
    x = np.random.default_rng(17).uniform(-1, 1, (2, client.sess.slots))
    w = Wire()
    ops = [client._encrypt_seeded(v) for v in x]
    send_request(w, "simple", client.sess.ctx.params, rk=client.sess.rk,
                 cts=[c for c, _ in ops], seeds=[sd for _, sd in ops])
    replies = []
    for device in (dev, "cpu"):
        header, sess, cts = recv_request(Wire(w.sent), device=device)
        assert sess.decryptor is None
        out = Wire()
        send_reply(out, handle(header, sess, cts))
        replies.append(out.sent)
    assert replies[0] == replies[1]


CARD_RANKS_TIMEOUT_S = 300


def _card_ranks(main, world: int, tmp_path, *args, prefix: str = "card"):
    """``main`` of ``torch_parallel_ranks`` on ``world`` processes on
    cuda:0; ranks still running after ``CARD_RANKS_TIMEOUT_S`` are killed
    (the test fails instead of hanging).  Returns each rank's results."""
    import time
    ctx = mp.start_processes(main, args=(world, str(tmp_path / "store"),
                                         str(tmp_path)) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + CARD_RANKS_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"{world} card ranks did not finish")
    return [json.loads((tmp_path / f"{prefix}_r{r}.json").read_text())
            for r in range(world)]


def test_peer_permute_two_ranks(dev, tmp_path):
    """P5 at 2 ranks on the card (processes on cuda:0, buffers mapped with
    CUDA IPC): every exchange equals its gloo twin on the same values, the
    kernel launched; 64 exchanges with no host sync between them (the
    snippet's and the butterfly's sizes, the right shift and the xor
    pairing, one rank asleep 50 ms before its 10th) each equal their
    twins; an exchange refuses CUDA graph capture; tp_relinearize
    (test_dnum) and cp at n=2048 on the card equal their single-rank
    results."""
    for res in _card_ranks(ranks.main_card, 2, tmp_path, True):
        assert res.pop("launches") > 0
        assert all(res.values()), res


def test_peer_permute_four_ranks(dev, tmp_path):
    """P5 at 4 ranks on the card: every exchange, the 64-exchange stress
    sequence with its sleeping rank, and the capture refusal, as at 2."""
    for res in _card_ranks(ranks.main_card, 4, tmp_path, False):
        assert res.pop("launches") > 0
        assert all(res.values()), res


@pytest.mark.parametrize("world", [2, 4])
def test_peer_permute_stalled_rank_raises(dev, tmp_path, world):
    """A rank that skips an exchange: every other rank's synchronise
    raises within the watchdog's bound (``HANG_S`` and two of its looks,
    plus a second for the trap) instead of hanging, and its next exchange
    is refused with the watchdog's reason; the exchange before the skip
    was right."""
    from hetpu_torch.parallel import peer
    res = _card_ranks(ranks.main_stall, world, tmp_path, prefix="stall")
    assert all(r["first"] for r in res), res
    for r in res[:-1]:
        assert r["raised"] and r["refused"], r
        assert "made no progress" in r["failed"], r
        assert peer.HANG_S < r["seconds"] < peer.HANG_S + 2 * peer.WATCH_S \
            + 1.0, r


def test_sharded_pipeline_without_mesh():
    """evaluate_sharded and evaluate_sharded_infer with no mesh on a
    default-device Session ("cuda", no index): one rank on the session's
    card, each result equal to the unsharded step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sess = Session.create("test_dnum", seed=b"\x38" * 32,
                          galois_steps=[1, 2, 3])
    assert sess.ctx.device == torch.device("cuda")
    x = np.random.default_rng(18).uniform(-1, 1, (2, sess.slots))
    cts = [sess.encrypt(v) for v in x]
    diags, act = pipeline._infer_weights(sess.slots, 4, 7)
    got = pipeline.evaluate_sharded_infer(sess, cts, 7, n_diags=4)
    batch = cts[0].with_(data=torch.stack([c.data for c in cts]))
    want = pipeline.infer_step(sess, batch, diags, act)
    assert torch.equal(torch.stack([c.data for c in got]), want.data)
    got = pipeline.evaluate_sharded(sess, cts)
    prod = sess.ev.multiply_relin_rescale(cts[0], cts[1], sess.rk)
    want = sess.ev.add(prod, sess.ev.rotate(prod, 1, sess.gk))
    assert len(got) == 1 and torch.equal(got[0].data, want.data)


# ----------------------------------------------------------------------
# the demos CLI (python -m hetpu_torch.demos) on the card
# ----------------------------------------------------------------------

CARD_DEMOS = ([("matrix_operations", n) for n in (
    "op", "elemwise_square", "matmul", "batch_matmul_bfv",
    "batch_matmul_ckks", "matpow", "sum_elems", "least_squares_2d",
    "batched_matmul_ckks")]
    + [("fft", "fft"), ("fft", "bfft"), ("math_operations", "bench_rot")]
    + [("client_server_rookie", n) for n in (
        "simple", "batch_matmul", "inv", "inv_sqrt_twice", "abs",
        "twice_max", "fft")])


@pytest.mark.parametrize("suite,name", CARD_DEMOS,
                         ids=[f"{s}-{n}" for s, n in CARD_DEMOS])
def test_demo_card_equals_cpu(dev, suite, name, tmp_path, monkeypatch):
    """Each demo at --small on the card prints what its CPU run prints
    under the same seeds, each from an empty key cache: BFV's decrypts
    and noise budgets equal, CKKS's decoded values within 1e-9."""
    from hetpu_torch.demos.__main__ import main
    from hetpu_torch.utils import keycache
    argv = [suite, name, "--small"]
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path / "card")
    cuda_lib.reset_launches()
    card = torch_demo_cases.run(main, argv, f"{suite}.{name}")
    assert cuda_lib.launches["ntt"] > 0
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path / "cpu")
    cpu = torch_demo_cases.run(main, argv + ["--cpu"], f"{suite}.{name}")
    torch_demo_cases.assert_same_printed(card, cpu)


def test_chained_step_graph_equals_eager(dev):
    """Each op's chained step replayed from its CUDA graph leaves the tag
    that the same number of eager steps leaves (the capture's warm-up is
    one step).  Three steps in all: a linear op's tag alternates between
    its first fold and zero, so an even count would leave zeros."""
    from hetpu_torch import bench, probes
    from hetpu_torch.demos import math_operations as mo
    sess = Session.create("test_tiny", seed=b"\x46" * 32, galois_steps=[1])
    for name, (fn, data) in mo.chained_cases(sess).items():
        graph_chain = bench.Chain(fn, data.clone())
        graph = probes.Captured(graph_chain)
        for _ in range(2):
            graph.replay()
        eager = bench.Chain(fn, data.clone())
        for _ in range(3):
            eager()
        assert torch.equal(graph_chain.tag, eager.tag), name
        assert eager.tag.any(), name


@pytest.mark.parametrize("name", ["multiply_relin_rescale", "rotate"])
def test_bench_chain_graph_equals_eager(dev, name):
    """The bench harness's chain replayed from its captured step, K=4 steps
    from a zero tag at bench_n14 B=8, leaves the tag and last output of 4
    eager steps; the replays launch K1 and grow no device memory."""
    from hetpu_torch import bench
    from hetpu_torch.bench import headline, secondary
    sess = Session.create("bench_n14", seed=headline.SEED, galois_steps=[1])
    a, b = headline.operands(sess, 8)
    make = {"multiply_relin_rescale": lambda: headline.chain(sess, a, b),
            "rotate": lambda: secondary.rotate(sess, a)}[name]
    graph = make()
    r = bench.timed(graph, 4, reps=1, eager=False)
    eager = make()
    for _ in range(4):
        eager()
    assert torch.equal(graph.tag, eager.tag)
    assert torch.equal(graph.out, eager.out) and eager.out.any()
    assert r["launches"]["ntt"] > 0 and r["grown_bytes"] == 0


@pytest.mark.parametrize("program", torch_profile_cases.PROGRAMS)
def test_profile_chains_card_equal_cpu(dev, program):
    """Each chain of an op-profiling program at --small (test_dnum, B=2,
    K=3): K eager steps on the card leave the tag and last output of K
    steps on the CPU (plain twins, the same keys and encryptions), and K
    replays of the captured step leave the same."""
    from hetpu_torch import probes
    from hetpu_torch.core import random as port_rnd
    cases = torch_profile_cases
    seed = b"\x21" * 32
    card = cases.port_chains(program, Session.create(
        "test_dnum", seed=seed, galois_steps=[1]), (port_rnd,))
    cpu = cases.port_chains(program, Session.create(
        "test_dnum", seed=seed, galois_steps=[1], device="cpu"), (port_rnd,))
    assert set(card) == set(cpu)
    for label, c in card.items():
        want = cpu[label]
        if not hasattr(c, "tag"):          # probe_n15b's direct call
            assert torch.equal(c().cpu(), want()), label
            continue
        for _ in range(cases.K):
            c()
            want()
        assert torch.equal(c.tag.cpu(), want.tag), label
        assert torch.equal(c.out.cpu(), want.out) and want.out.any(), label
        graph = probes.Captured(c)
        c.tag.zero_()
        for _ in range(cases.K):
            graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(c.tag.cpu(), want.tag), label
        assert torch.equal(c.out.cpu(), want.out), label
