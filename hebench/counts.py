"""The least bytes of an op, computed from a configuration's shapes.

The rule of ``hetpu_torch.bench.bytes_bound_ms``, kept here so that the
yardstick does not move with the program: each input ciphertext and the
output ciphertext moved once, and the relinearisation key (its values,
not the Shoup companions derived from them) once a call; int32 residues;
NTT tables and other constants not counted.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # one H100 SXM's device memory (data sheet)
WORD = 4                       # bytes a residue


def mul_call_bytes(config: dict, batch: int) -> int:
    """multiply + relinearize (+ rescale, in CKKS) of ``batch`` ciphertext
    pairs at the top level: 2 inputs of L limbs, one output of L − g limbs
    (g the primes the op drops: a CKKS rescale's group, none in BFV), and
    the key of J digits over L + K limbs."""
    n = config["poly_degree"]
    L, K = len(config["moduli"]), len(config["special_moduli"])
    g = config["rescale_group"] if config["scheme"] == "ckks" else 0
    J = -(-L // K)
    op = (2 * 2 * L + 2 * (L - g)) * n * WORD
    key = J * 2 * (L + K) * n * WORD
    return batch * op + key


def bound_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
