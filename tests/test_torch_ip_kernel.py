"""hetpu_torch inner_product (plain path on the CPU) against hetpu's
Pallas key-switch MAC in interpret mode and its jnp twin, with and
without a batch dim (the shapes and inputs of tests/test_ip_kernel.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import ip_kernel as ref
from hetpu_torch.core import ip_kernel
from hetpu_torch.core.modular import from_u32, to_u32

torch.set_num_threads(1)


def _inputs(lead, J=2, R=5, N=256, seed=7):
    rng = np.random.default_rng(seed)
    q = (rng.integers(1 << 29, 1 << 30, R, dtype=np.uint32) | 1).reshape(R, 1)
    ext = rng.integers(0, q.min(), (*lead, J, R, N), dtype=np.uint32)
    k = rng.integers(0, q.min(), (J, 2, R, N), dtype=np.uint32)
    ks = ((k.astype(np.uint64) << 32) // q.astype(np.uint64)).astype(np.uint32)
    return ext, k, ks, q


@pytest.mark.parametrize("lead", [(), (3,)])
def test_vs_pallas_interpret(lead):
    ext, k, ks, q = _inputs(lead)
    old = ref._FORCE, ref._INTERPRET
    ref._FORCE, ref._INTERPRET = True, True
    try:
        want = np.asarray(ref.inner_product(jnp.asarray(ext), jnp.asarray(k),
                                            jnp.asarray(ks), q))
    finally:
        ref._FORCE, ref._INTERPRET = old
    got = ip_kernel.inner_product(from_u32(ext), from_u32(k), from_u32(ks),
                                  from_u32(q))
    assert tuple(got.shape) == (*lead, 2, 5, 256)
    np.testing.assert_array_equal(to_u32(got), want)


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_vs_jnp_twin(lead):
    """Also with J=3 digits and a 2-D batch; the dispatching wrapper on a
    CPU tensor equals the plain twin."""
    ext, k, ks, q = _inputs(lead, J=3, R=4, N=128, seed=9)
    want = np.asarray(ref.inner_product_jnp(jnp.asarray(ext), jnp.asarray(k),
                                            jnp.asarray(ks), jnp.asarray(q)))
    args = (from_u32(ext), from_u32(k), from_u32(ks), from_u32(q))
    got = ip_kernel.inner_product(*args)
    np.testing.assert_array_equal(to_u32(got), want)
    assert torch.equal(got, ip_kernel.inner_product_plain(*args))
