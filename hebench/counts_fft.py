"""The least bytes of the forward in-slot FFT's masks and rescales,
computed from a configuration's shapes.

One transform of ``batch`` ciphertexts at the top level (L0 limbs) runs
log2(n) stages, stage s at L = L0 − g·s limbs (g the rescale group).  A
stage's masks read each of its sources once ([batch, 2, L, N]: the input
and each rotation; two in the first stage, whose ±n/2 rotations merge
through the tiling, three after) and each mask once ([L, N]), and write
the sum once; its rescale reads the sum once and writes [batch, 2, L − g,
N] once.  Int32 residues, whatever implements the stage; the plaintexts'
Shoup companions and other constants not counted.  Kept here, apart from
the program's own counter, so that the yardstick does not move with the
program.
"""

from __future__ import annotations

from .counts import WORD


def _stages(config: dict, n: int) -> list:
    """(limbs, sources) of each stage of one forward transform."""
    L0, g = len(config["moduli"]), config["rescale_group"]
    return [(L0 - g * s, 2 if s == 0 else 3)
            for s in range(n.bit_length() - 1)]


def mask_bytes(config: dict, batch: int, n: int) -> int:
    """Bytes of the mask products and their sums of one transform."""
    planes = sum((k + 1) * batch * 2 * L + k * L
                 for L, k in _stages(config, n))
    return planes * config["poly_degree"] * WORD


def rescale_bytes(config: dict, batch: int, n: int) -> int:
    """Bytes of the stages' rescales of one transform."""
    g = config["rescale_group"]
    planes = sum(batch * 2 * (2 * L - g) for L, _ in _stages(config, n))
    return planes * config["poly_degree"] * WORD
