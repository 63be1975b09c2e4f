"""hetpu_torch.core.mxu_digits is bit-equal to the int8-digit helpers of
hetpu.core.mxu_ntt (``_extract_digit_list``, ``_extract_digits``,
``_shoup_scalarish``, ``_carry_save``, ``_fold_mul``) on the same numpy
inputs, including values at q_half, q_half ± 1, at and above q, and with
the high bit set."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import mxu_ntt as ref
from hetpu.core.params import preset
from hetpu_torch.core import mxu_digits as md
from hetpu_torch.core.modular import from_u32, to_u32

torch.set_num_threads(1)

N = 256
PROBE_Q = (1 << 30) + 1


def _moduli(kind):
    """q as [L, 1] u32: the probe's q = 2^30 + 1, or bench_n14's primes."""
    if kind == "probe":
        return np.array([[PROBE_Q]], dtype=np.uint32)
    p = preset("bench_n14")
    return np.array(p.moduli + p.special_moduli, dtype=np.uint32)[:, None]


def _x(q, seed):
    """u32 [L, N]: residues below q, then edges q_half - 1, q_half,
    q_half + 1, q - 1, q, q + 1, 2^31 - 1, 2^31, 2^32 - 1, 0, and a block of
    values anywhere in [0, 2^32)."""
    rng = np.random.default_rng(seed)
    L = q.shape[0]
    x = (rng.integers(0, 1 << 62, (L, N), dtype=np.uint64)
         % q).astype(np.uint32)
    qh = q[:, 0] // 2
    edges = [qh - 1, qh, qh + 1, q[:, 0] - 1, q[:, 0], q[:, 0] + 1]
    for i, e in enumerate(edges):
        x[:, i] = e
    x[:, 6:10] = np.array([(1 << 31) - 1, 1 << 31, (1 << 32) - 1, 0],
                          dtype=np.uint64).astype(np.uint32)
    x[:, 10:74] = rng.integers(0, 1 << 32, (L, 64), dtype=np.uint64)
    return x


@pytest.mark.parametrize("kind", ["probe", "bench_n14"])
def test_extract_digit_list(kind):
    q = _moduli(kind)
    x = _x(q, 1)
    qh = q // 2
    want = ref._extract_digit_list(jnp.asarray(x), jnp.asarray(q),
                                   jnp.asarray(qh))
    got = md.extract_digit_list(from_u32(x), from_u32(q), from_u32(qh))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the probe passes q and q // 2 as scalars
    if kind == "probe":
        s = md.extract_digit_list(from_u32(x), PROBE_Q, PROBE_Q // 2)
        for g, w in zip(s, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("kind", ["probe", "bench_n14"])
def test_extract_digits(kind):
    x = _x(_moduli(kind), 2)
    want = ref._extract_digits(jnp.asarray(x))
    got = md.extract_digits(from_u32(x))
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("companion", ["true", "probe_script"])
@pytest.mark.parametrize("kind", ["probe", "bench_n14"])
def test_shoup_scalarish(kind, companion):
    """With the true companion ⌊w·2^32/q⌋ and with the value the probe
    script computes (a u32 shift by 32): the same formula either way."""
    q = _moduli(kind)
    x = _x(q, 3)
    rng = np.random.default_rng(4)
    w = (rng.integers(0, 1 << 62, x.shape, dtype=np.uint64)
         % q).astype(np.uint32)
    if companion == "true":
        ws = ((w.astype(np.uint64) << np.uint64(32))
              // q.astype(np.uint64)).astype(np.uint32)
    else:
        ws = (np.asarray(jnp.asarray(w) << jnp.uint32(31) << jnp.uint32(1))
              // q).astype(np.uint32)
    want = np.asarray(ref._shoup_scalarish(jnp.asarray(x), jnp.asarray(w),
                                           jnp.asarray(ws), jnp.asarray(q)))
    got = to_u32(md.shoup_scalarish(from_u32(x), from_u32(w), from_u32(ws),
                                    from_u32(q)))
    np.testing.assert_array_equal(got, want)
    if companion == "true":
        np.testing.assert_array_equal(
            got, (x.astype(np.uint64) * w % q).astype(np.uint32))


def _g_list(seed):
    """Four int32 digit-plane sums in [-2^23, 2^23], with the extremes."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-(1 << 23), (1 << 23) + 1, (4, 3, N)).astype(np.int32)
    g[:, :, 0] = -(1 << 23)
    g[:, :, 1] = 1 << 23
    g[:, :, 2] = 0
    g[:, :, 3] = -1
    return g


@pytest.mark.parametrize("seed", [5, 6])
def test_carry_save(seed):
    g = _g_list(seed)
    want = ref._carry_save([jnp.asarray(v) for v in g])
    got = md.carry_save([torch.from_numpy(v) for v in g])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(to_u32(a), np.asarray(b))


@pytest.mark.parametrize("kind", ["probe", "bench_n14"])
def test_fold_mul(kind):
    """The fold of a carry-save pair with per-limb constants, corr both
    below and above the folded sum."""
    q = _moduli(kind)
    L = q.shape[0]
    rng = np.random.default_rng(7)
    s_lo, s_hi = (np.asarray(v) for v in ref._carry_save(
        [jnp.asarray(v) for v in _g_list(8)[:, :1].repeat(L, 1)]))

    def col():
        return (rng.integers(0, 1 << 62, (L, 1), dtype=np.uint64)
                % q).astype(np.uint32)

    def sh(c):
        return ((c.astype(np.uint64) << np.uint64(32))
                // q.astype(np.uint64)).astype(np.uint32)

    c, cR, corr = col(), col(), col()
    args = (s_lo, s_hi, c, sh(c), cR, sh(cR), corr, q)
    want = np.asarray(ref._fold_mul(*map(jnp.asarray, args)))
    got = to_u32(md.fold_mul(*map(from_u32, args)))
    np.testing.assert_array_equal(got, want)


def test_wrap_i8_matches_astype():
    v = np.array([0, 1, 127, 128, 255, 256, -1, -128, -129, 2**31 - 1,
                  -2**31, 33554432 + 200], dtype=np.int32)
    want = np.asarray(jnp.asarray(v).astype(jnp.int8))
    np.testing.assert_array_equal(md.wrap_i8(torch.from_numpy(v)).numpy(),
                                  want)
    assert md.OFF == int(ref._OFF)


@pytest.mark.parametrize("kind", ["probe", "bench_n14"])
def test_mulhi_mullo(kind):
    from hetpu.core import modular as rmod
    x = _x(_moduli(kind), 9)
    y = np.random.default_rng(10).integers(0, 1 << 32, x.shape,
                                           dtype=np.uint64).astype(np.uint32)
    for ours, theirs in ((md.mulhi_u32, rmod.mulhi_u32),
                         (md.mullo_u32, rmod.mullo_u32)):
        got = ours(from_u32(x), from_u32(y)).numpy().astype(np.uint32)
        np.testing.assert_array_equal(
            got, np.asarray(theirs(jnp.asarray(x), jnp.asarray(y))))
