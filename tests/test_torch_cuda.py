"""hetpu_torch's CUDA kernels against their plain PyTorch versions, on the
card (marker ``cuda``; each test skips where no CUDA device is present).

Imports neither JAX nor hetpu, so it also runs on a GPU host without JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -o addopts="" -p no:cacheprovider

(``--noconftest``: tests/conftest.py sets up JAX for the reference tests.)
"""

import pathlib

import numpy as np
import pytest
import torch

from hetpu_torch.core import cuda_lib, fused_ntt, ip_kernel
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import from_u32, shoup_companion, to_u32
from hetpu_torch.core.nt import gen_primes
from hetpu_torch.core.ntt import (build_tables, ntt_fwd, ntt_fwd_plain,
                                  ntt_inv, ntt_inv_plain)
from hetpu_torch.core.params import ckks_params, preset
from hetpu_torch.session import Session

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


@pytest.mark.parametrize("logn", [10, 12, 15])
@pytest.mark.parametrize("epi", ["fwd", "fwd_mont", "inv", "inv_strip",
                                 "inv_strip_extra"])
def test_ntt_kernel(dev, logn, epi):
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


def test_fbc_kernel(dev, ctx):
    mdr = ctx.moddown_rescale_plan(5)
    u = _res(np.random.default_rng(3), (2, 2, len(mdr.src_tables.primes),
                                        4096), mdr.src_tables.primes, dev)
    for to_mont in (False, True):
        assert torch.equal(
            fused_ntt.ntt_fwd_fbc(u, mdr.fbc, mdr.dst_tables, to_mont=to_mont),
            fused_ntt.ntt_fwd_fbc_plain(u, mdr.fbc, mdr.dst_tables,
                                        to_mont=to_mont))


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
    assert all(v > 0 for v in cuda_lib.launches.values()), cuda_lib.launches


def test_bench_n14_b1_equals_cpu(dev):
    sess = Session.create("bench_n14", seed=b"\x21" * 32, galois_steps=[1],
                          device=dev)
    rng = np.random.default_rng(9)
    x, y = rng.uniform(-1, 1, (2, sess.slots))
    a, b = sess.encrypt(x), sess.encrypt(y)
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    assert np.abs(sess.decrypt(out).real - x * y).max() < 2e-3
    ref = Evaluator(Context(preset("bench_n14"))).multiply_relin_rescale(
        a.to("cpu"), b.to("cpu"), sess.rk.to("cpu"))
    assert torch.equal(out.data.cpu(), ref.data)
