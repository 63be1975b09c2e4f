"""Two-float (double-single) arithmetic: ~2^-45 precision out of f32 pairs.

Counterpart of ``hetpu/core/twofloat.py``.  Where BFV needs a near-f64
rounding decision — the FBC α-correction of exact BFV arithmetic
(``rns.fbc_apply(precise=True)``) — classic error-free transformations on
float32:

* Veltkamp splitting + Dekker TwoProd: the product of two f32 values as an
  exact hi+lo pair, with no fused multiply-add;
* Knuth TwoSum: exact hi+lo of a sum.

The algebra holds only if every f32 product and sum rounds on its own.
Each line below is one eager torch op on float32 tensors, which rounds
once on the CPU and on the card alike; do not fuse them (no ``addcmul``,
no ``torch.compile``), or a contracted multiply-add changes the error
terms and, on rare near-half columns, α.  The reference calls these
functions without ``jax.jit``, so its ops round one by one too.  These
functions are the plain twin's (``rns.fbc_apply_plain``); on the card a
precise conversion runs kernel ``fbc_precise`` (K9,
``csrc/fbc_precise.cu``), which spells each of these ops out as its own
rounded float32 instruction, in the same order.
"""

from __future__ import annotations

import torch

_SPLIT = 4097.0                      # 2^12 + 1 (f32 Veltkamp constant)


def _split(a):
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p + e == a·b exactly (a, b f32, no overflow)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def two_sum(a, b):
    """(s, e) with s + e == a + b exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def ds_add(hi, lo, p, e):
    """Accumulate the exact pair (p, e) into the double-single (hi, lo)."""
    s, err = two_sum(hi, p)
    lo = lo + (err + e)
    return s, lo


def ds_round(hi, lo):
    """round(hi + lo) to the nearest integer, honoring lo even when hi sits
    within ~2^-45 of a half-integer (``torch.round`` rounds half to even,
    as ``jnp.round`` does).

    f = hi − round(hi) is exact (Sterbenz), as are f ± 0.5; adding lo to
    an exact quantity can round the magnitude but never flips the sign,
    so the two boundary comparisons are exact-sign decisions."""
    r = torch.round(hi)
    f = hi - r
    up = ((f - 0.5) + lo) >= 0        # hi+lo ≥ r + 0.5
    dn = ((f + 0.5) + lo) < 0         # hi+lo < r − 0.5
    return r + up.to(hi.dtype) - dn.to(hi.dtype)
