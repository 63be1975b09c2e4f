"""Shared helpers of the application-layer tests (test_torch_math,
test_torch_linalg, test_torch_fft, test_torch_models, test_torch_offload).

hetpu's and the port's sessions are built from one seed, so their keys
agree bit for bit; operands are hetpu's seeded encryptions carried over
with ``hetpu_torch.convert``.  Where a function encrypts by itself (the
linalg constructors), ``fixed_seeds`` makes both packages draw the same
sequence of fresh seeds.
"""

import numpy as np
import torch

from hetpu.core import random as ref_rnd
from hetpu_torch import convert
from hetpu_torch.core import random as port_rnd
from hetpu_torch.core.modular import to_u32

import torch_demo_cases

torch.set_num_threads(1)


def fixed_seeds(tag: str):
    """Inside the block, ``new_seed`` of both packages returns the same
    sequence (restarted by every block with the same tag)."""
    return torch_demo_cases.fixed_seeds(tag, (ref_rnd, port_rnd))


def encrypt_pair(ref, values, seed: bytes):
    """hetpu's seeded public-key encryption of ``values`` and its copy on
    the CPU for the port."""
    ct = ref.encryptor.encrypt(ref.encode(values), seed=seed)
    return ct, convert.ciphertext(ct, "cpu")


def assert_same(got, want) -> None:
    """The port's ciphertext equals hetpu's: level, scale and residues."""
    assert (got.level, got.scale) == (want.level, want.scale)
    np.testing.assert_array_equal(to_u32(got.data), np.asarray(want.data))


def inv_replica(x, a, k):
    """Plain replica of signed_inv: a·(1+t)(1+t²)…, t = 1 − a·x."""
    t = 1 - a * x
    y = a * (1 + t)
    for _ in range(1, k):
        t = t * t
        y = y * (1 + t)
    return y


def inv_sqrt_twice_replica(x, a, k):
    """Plain replica of inv_sqrt_twice: y ← 1.5·y − x·y³ from y₀ = a."""
    y = 1.5 * a - a ** 3 * x
    for _ in range(1, k):
        y = 1.5 * y - x * y ** 3
    return y


def abs_replica(x, a, k):
    """Plain replica of abs_: √(x²) as (1/√(2x²))·√2·x²."""
    return inv_sqrt_twice_replica(x * x, a, k) * np.sqrt(2.0) * x * x
