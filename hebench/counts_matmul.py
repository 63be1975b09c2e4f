"""The least bytes of the diagonal method's rotation steps, computed from
a configuration's shapes.

One d × d by d × p product at the top level rotates B's batch of p
column ciphertexts by each step 1..d−1 from one hoisted decomposition.
Each step reads c0 of the batch once ([p, L, N]) and its J·R digit
planes once ([p, J, R, N], R = L + K the key basis), writes the 2-part
rotation once ([p, 2, L, N]) and reads its key's values once ([J, 2, R,
N], not the Shoup companions), as int32 residues, whatever implements
the step.  Kept here, apart from the program's own counter, so that the
yardstick does not move with the program.
"""

from __future__ import annotations

from .counts import WORD


def rot_steps_bytes(config: dict, dim: int, cols: int | None = None) -> int:
    """Bytes of the d − 1 hoisted rotation steps of one product of a
    ``dim`` × ``dim`` matrix by ``cols`` (default ``dim``) columns."""
    n = config["poly_degree"]
    L, K = len(config["moduli"]), len(config["special_moduli"])
    J, R = -(-L // K), L + K
    p = dim if cols is None else cols
    step = p * L + p * J * R + p * 2 * L + J * 2 * R
    return (dim - 1) * step * n * WORD
