"""hetpu_torch.core.modular is bit-equal to hetpu.core.modular on random
residues of the test_dnum and bench_n14 primes (the port computes in
int64, the reference in 16-bit-emulated uint32 Montgomery/Shoup forms;
both return canonical residues)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import modular as ref
from hetpu.core.params import preset
from hetpu_torch.core import modular as mod
from hetpu_torch.core.modular import from_u32, to_u32

torch.set_num_threads(1)

N = 512


def _primes(name):
    p = preset(name)
    return np.array(p.moduli + p.special_moduli, dtype=np.uint32).reshape(-1, 1)


def _operands(name, seed):
    q = _primes(name)
    rng = np.random.default_rng(seed)
    a = (rng.integers(0, 1 << 62, (q.shape[0], N), dtype=np.uint64)
         % q).astype(np.uint32)
    b = (rng.integers(0, 1 << 62, (q.shape[0], N), dtype=np.uint64)
         % q).astype(np.uint32)
    # edges: 0, 1, q-1 in both operands
    for col, v in enumerate((0, 1, None)):
        edge = q[:, 0] - 1 if v is None else v
        a[:, col] = edge
        b[:, col + 3] = edge
        a[:, col + 6] = b[:, col + 6] = edge
    return q, a, b


PRESETS = ["test_dnum", "bench_n14"]


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("op", ["mod_add", "mod_sub"])
def test_add_sub(name, op):
    q, a, b = _operands(name, 1)
    want = np.asarray(getattr(ref, op)(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(q)))
    got = to_u32(getattr(mod, op)(from_u32(a), from_u32(b), from_u32(q)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PRESETS)
def test_mod_neg(name):
    q, a, _ = _operands(name, 2)
    want = np.asarray(ref.mod_neg(jnp.asarray(a), jnp.asarray(q)))
    got = to_u32(mod.mod_neg(from_u32(a), from_u32(q)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PRESETS)
def test_mont_mul(name):
    q, a, b = _operands(name, 3)
    mc = mod.mont_constants(q[:, 0].tolist())
    want = np.asarray(ref.mont_mul(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(q), jnp.asarray(mc["qinv_neg"])))
    got = to_u32(mod.mont_mul(from_u32(a), from_u32(b), from_u32(q),
                              from_u32(mc["r_inv"])))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PRESETS)
def test_shoup_mul(name):
    """x may be any 32-bit value (a residue of another prime in the lift)."""
    q, a, w = _operands(name, 4)
    rng = np.random.default_rng(5)
    x = np.concatenate([a, rng.integers(0, 1 << 32, a.shape, dtype=np.uint64)
                        .astype(np.uint32)], axis=1)
    w = np.concatenate([w, w], axis=1)
    ws = ref.shoup_precompute(w, q)
    want = np.asarray(ref.shoup_mul(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(ws), jnp.asarray(q)))
    got = to_u32(mod.shoup_mul(from_u32(x), from_u32(w), from_u32(ws),
                               from_u32(q)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        to_u32(mod.shoup_companion(from_u32(w), from_u32(q))), ws)


@pytest.mark.parametrize("name", PRESETS)
def test_barrett_reduce(name):
    q, _, _ = _operands(name, 6)
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 32, (q.shape[0], N), dtype=np.uint64)
    x[:, :3] = [0, (1 << 32) - 1, 1 << 31]
    x = x.astype(np.uint32)
    mu = ref.mont_constants(q[:, 0].tolist())["mu"]
    want = np.asarray(ref.barrett_reduce_u32(jnp.asarray(x), jnp.asarray(q),
                                             jnp.asarray(mu)))
    got = to_u32(mod.barrett_reduce_u32(from_u32(x), from_u32(q),
                                        from_u32(mu)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PRESETS)
def test_host_constants(name):
    q = _primes(name)
    want = ref.mont_constants(q[:, 0].tolist())
    got = mod.mont_constants(q[:, 0].tolist())
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    r_mod = want["r_mod_q"].astype(np.uint64)
    assert ((got["r_inv"].astype(np.uint64) * r_mod) % q == 1).all()
    w = (np.arange(q.shape[0] * 8, dtype=np.uint64).reshape(-1, 8) * 7919
         % q).astype(np.uint32)
    np.testing.assert_array_equal(mod.shoup_precompute(w, q),
                                  ref.shoup_precompute(w, q))


def test_storage_roundtrip():
    """uint32 values ≥ 2^31 survive the int32 bit-pattern storage."""
    a = np.array([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], np.uint32)
    t = from_u32(a)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(to_u32(t), a)
    assert mod.u32(t).tolist() == [int(v) for v in a]
    np.testing.assert_array_equal(to_u32(mod.to_i32(mod.u32(t))), a)
