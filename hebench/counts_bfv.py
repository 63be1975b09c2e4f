"""The least bytes of the BFV multiply's precise base conversions,
computed from a configuration's shapes.

The HPS multiply at the top level converts four times between the data
basis Q (L primes) and the auxiliary basis B (``aux_moduli``, K_B
primes): each operand's 2 parts Q → B, the 3-part t·x's Q-residues
Q → B, and the 3-part scaled y back B → Q.  Each conversion reads every
source limb once and writes every target limb once, as int32 residues:
10 parts of L + K_B limbs an op, whatever implements the conversions.
Kept here, apart from the program's own counter, so that the yardstick
does not move with the program.
"""

from __future__ import annotations

from .counts import WORD

PARTS = 2 + 2 + 3 + 3          # a, b, t·x over Q, y over B


def convert_call_bytes(config: dict, batch: int) -> int:
    """Bytes of the four precise conversions of ``batch`` BFV multiplies
    at the top level of ``config``."""
    n = config["poly_degree"]
    L, KB = len(config["moduli"]), len(config["aux_moduli"])
    return batch * PARTS * (L + KB) * n * WORD
