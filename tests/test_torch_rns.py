"""hetpu_torch.core.rns.fbc_apply (plain f32 α) is bit-equal to
hetpu.core.rns.fbc_apply(precise=False) for every (correct, premul) pair,
on the fused tail's conversion of test_dnum (dropped prime + specials →
remaining data primes) with centered inputs, including values near the
±P/2 edges where α is largest."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import rns as ref
from hetpu.core.params import preset
from hetpu_torch.core import rns
from hetpu_torch.core.modular import from_u32, to_u32

torch.set_num_threads(1)


@pytest.mark.parametrize("correct", [True, False])
@pytest.mark.parametrize("premul", [True, False])
def test_fbc_apply_equal(correct, premul):
    p = preset("test_dnum")
    src = list(p.moduli[-1:]) + list(p.special_moduli)
    dst = list(p.moduli[:-1])
    P = int(np.prod([int(x) for x in src], dtype=object))
    rng = np.random.default_rng(31)
    # centered values in (-P/2, P/2]: random, plus the extremes
    vals = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, 1021)]
    vals += [P // 2, -(P // 2) + 1, 0]
    x = np.array([[v % q for v in vals] for q in src], dtype=np.uint32)
    want = ref.fbc_apply(jnp.asarray(x), ref.make_fbc(src, dst),
                         correct=correct, premul=premul)
    got = rns.fbc_apply(from_u32(x), rns.make_fbc(src, dst),
                        correct=correct, premul=premul)
    np.testing.assert_array_equal(to_u32(got), np.asarray(want))
