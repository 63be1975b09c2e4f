"""Digit vectors for the fast base conversion and their exact conversion
by Python big ints: a copy of tests/test_rns.py's ``_digits_to_input``,
``_expected`` and ``_craft_near_half`` (same digits for the same seed)
in numpy and Python ints only, so the port's card tests can use them
without JAX.

Math: with premultiplied digits y_i ∈ [0, p_i), the lift s = Σ y_i·(P/p_i)
satisfies s ≡ v (mod P) and s/P = Σ y_i/p_i.  Centered FBC returns
(s − round(s/P)·P) mod r — so exact expectations are computable for ANY
digit combination, letting us craft Σ y_i/p_i arbitrarily close to a
half-integer (the worst case for the float α)."""

from fractions import Fraction
import random

import numpy as np


def digits_to_input(y, src, n) -> np.ndarray:
    """Premultiplied digits y_i → the raw fbc input x_i with x_i·P̂ᵢ⁻¹ ≡ y_i
    (undo the premultiply so fbc_apply's own premul reproduces y), each
    repeated over n columns: uint32 [len(src), n]."""
    P = 1
    for p in src:
        P *= p
    x = np.zeros((len(src), n), dtype=np.uint32)
    for i, p in enumerate(src):
        phat = (P // p) % p
        x[i, :] = (y[i] * phat) % p
    return x


def expected(y, src, dst):
    """Exact centered conversion of the digit vector y, and the distance of
    Σ y_i/p_i from its rounding."""
    P = 1
    for p in src:
        P *= p
    s = sum(int(y[i]) * (P // p) for i, p in enumerate(src))
    frac = Fraction(s, P)
    alpha = int(frac) + (1 if frac - int(frac) >= Fraction(1, 2) else 0)
    v = s - alpha * P
    return np.array([v % r for r in dst], dtype=np.uint32), frac - alpha


def craft_near_half(src, seed, want=8):
    """Digit vectors with Σ y_i/p_i within ~2/p_last of a half-integer
    (but NOT exactly on it — exact ties are ambiguous by definition)."""
    rng = random.Random(seed)
    out = []
    while len(out) < want:
        y = [rng.randrange(p) for p in src[:-1]]
        p_last = src[-1]
        frac = sum(Fraction(yi, p) for yi, p in zip(y, src[:-1]))
        target = frac + Fraction(1, 2)
        # choose y_last so the total lands just past the half boundary
        y_last = (-(target.numerator * p_last) // target.denominator) % p_last
        for cand in (y_last, (y_last + 1) % p_last):
            tot = frac + Fraction(cand, p_last)
            d = tot - int(tot) - Fraction(1, 2)
            if d != 0 and abs(d) < Fraction(2, p_last):
                out.append(y + [cand])
                break
    return out
