"""Galois automorphisms on NTT-domain polynomials.

Counterpart of ``hetpu/core/galois.py`` (same permutations; ``apply``
gathers a tensor on its own device).  Replaces SEAL's
``util::GaloisTool`` + ``Evaluator::apply_galois`` / ``rotate_vector``
internals (the reference's rotation hot loop —
``he_linalg.cpp:589-638, 977-1003`` — bottoms out here).

Design: in our NTT evaluation order (``out[i] = a(ψ^{2·br(i)+1})``
— pinned by tests/test_ntt.py::test_output_ordering), the automorphism
σ_t: a(x) → a(x^t) is a *pure index permutation* of the evaluation values:
σ_t(a) at exponent e equals a at exponent t·e mod 2N.  We precompute the
permutation host-side once per galois element; applying it is a single
gather — no NTT round-trip (SEAL does the same via permutation tables).

Slot semantics (tied to the encoder's 5^s slot ordering, encoding.py):
  * galois element 5^k mod 2N  ⇔  rotate slots LEFT by k
  * element 2N-1               ⇔  complex conjugation of all slots

While a torch profiler records, ``apply`` opens the span ``hetpu/rot.galois``
and adds its gather's bytes to :data:`gather_bytes` (every plane read once
and written once, int32 words, the index not counted: the rule of
``cuda_lib.launch_bytes``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import cuda_lib
from ..utils.profiling import profiler_on, span

# the gathers' device-memory bytes while a profiler records
gather_bytes = cuda_lib.register_counter({"apply": 0})


@lru_cache(maxsize=None)
def _exp_vectors(n: int):
    """(E, A): E[i] = odd exponent 2·br(i)+1 of output index i;
    A[e] = index with that exponent (A[E] = arange)."""
    logn = n.bit_length() - 1
    br = np.zeros(n, dtype=np.int64)
    for b in range(logn):                    # vectorized bit reversal
        br |= (((np.arange(n) >> b) & 1) << (logn - 1 - b))
    E = 2 * br + 1                           # [N] odd exponents mod 2N
    A = np.zeros(2 * n, dtype=np.int32)
    A[E] = np.arange(n, dtype=np.int32)
    return E, A


@lru_cache(maxsize=None)
def permutation(n: int, galois_elt: int) -> np.ndarray:
    """Index array π (int32 [N]) with σ_t(a)_ntt = a_ntt[π]."""
    if galois_elt % 2 == 0:
        raise ValueError("galois element must be odd")
    E, A = _exp_vectors(n)
    return A[(galois_elt * E) % (2 * n)]


def rotation_elt(n: int, steps: int) -> int:
    """Galois element rotating CKKS slots left by ``steps`` (negative =
    right), matching SEAL's generator-3 convention adapted to our 5^s slot
    order."""
    slots = n // 2
    steps = steps % slots
    return pow(5, steps, 2 * n)


def conjugation_elt(n: int) -> int:
    return 2 * n - 1


@lru_cache(maxsize=None)
def _perm_tensor(n: int, galois_elt: int, device: torch.device):
    return torch.from_numpy(permutation(n, galois_elt).astype(np.int64)
                            ).to(device)


def apply(data: torch.Tensor, n: int, galois_elt: int) -> torch.Tensor:
    """Gather along the last axis; works on any [..., N] tensor (leading
    batch and digit dimensions pass through)."""
    if profiler_on():
        gather_bytes["apply"] += cuda_lib.plane_bytes(
            n, 2 * data[..., 0].numel())
    with span("rot.galois"):
        return data.index_select(-1, _perm_tensor(n, galois_elt,
                                                  data.device))
