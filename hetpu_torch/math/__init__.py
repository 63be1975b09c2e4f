"""Encrypted elementary functions.

Counterpart of ``hetpu/math/__init__.py``; only :func:`mult_const_to`, the
solved-scale constant multiply the inference layer needs, is ported so far.
"""

from __future__ import annotations

from ..core.ciphertext import Ciphertext
from ..session import Session


def mult_const_to(sess: Session, ct: Ciphertext, value,
                  target_scale: float) -> Ciphertext:
    """ct · value with the constant's encode scale solved so that the
    result (after one rescale) has EXACTLY ``target_scale``."""
    g = sess.ctx.params.rescale_group
    q = 1.0
    for p in sess.ctx.params.moduli[ct.level - g + 1: ct.level + 1]:
        q *= p
    pt = sess.cached_encode(("const", complex(value)), value,
                            level=ct.level, scale=target_scale * q / ct.scale)
    return sess.ev.rescale(sess.ev.multiply_plain(ct, pt))
