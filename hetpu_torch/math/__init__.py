"""Encrypted elementary functions by polynomial iterations.

Counterpart of ``hetpu/math/__init__.py``: ``signed_inv``,
``inv_sqrt_twice`` (the depth-2 Newton variant), ``sqrt``, ``abs_``,
``twice_max`` (the offload server's workload) and ``max_`` / ``min_``,
with the same iteration schemes and domain contracts.  Constants are
encoded at solved scales (:func:`mult_const_to`), so every add and sub
lines up exactly.  The functions compose :class:`~hetpu_torch.session.Session`
and its evaluator and run on the session's device.
"""

from __future__ import annotations

import math as _m

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


def signed_inv(sess: Session, x: Ciphertext, guess: float,
               iter_num: int) -> Ciphertext:
    """1/x by the product expansion  a·(1+t)(1+t²)(1+t⁴)…, t = 1−a·x.
    Converges for 0 < a·x < 2 (reference contract ``he_math.h:9-15``).
    Depth: iter_num+1 levels.  Reference ``he_math.cpp:22-90``."""
    if iter_num < 1:
        raise ValueError("iter_num must be >= 1")
    ev = sess.ev
    # u = a·x − 1  (= −t)
    ax = mult_const_to(sess, x, guess, x.scale)
    u = ev.sub_plain(ax, sess.const_like(ax, 1.0))
    # y = a·(1 − u) = a(2 − ax)
    one_minus_u = ev.add_plain(ev.negate(u), sess.const_like(u, 1.0))
    y = mult_const_to(sess, one_minus_u, guess, one_minus_u.scale)
    for _ in range(1, iter_num):
        u = ev.square_relin_rescale(u, sess.rk)           # t^{2^i}
        factor = ev.add_plain(u, sess.const_like(u, 1.0))  # 1 + t^{2^i}
        y = sess.reach_level(y, factor.level)
        y = ev.multiply_relin_rescale(y, factor, sess.rk)
    return y


def inv_sqrt_twice(sess: Session, x: Ciphertext, guess: float,
                   iter_num: int) -> Ciphertext:
    """1/√(2x) by Newton  y ← 1.5·y − x·y³, y₀ = guess (depth 2/iter —
    the reference's default variant, ``he_math.cpp:127-164``)."""
    if iter_num < 1:
        raise ValueError("iter_num must be >= 1")
    ev = sess.ev
    # first step with constant y₀: y₁ = 1.5a − a³·x  (affine, 1 level)
    a = guess
    y = mult_const_to(sess, x, -(a ** 3), x.scale)
    y = ev.add_plain(y, sess.const_like(y, 1.5 * a))
    for _ in range(1, iter_num):
        xr = sess.reach_level(x, y.level)
        y2 = ev.square_relin_rescale(y, sess.rk)          # y²     ℓ-1
        xy = ev.multiply_relin_rescale(xr, y, sess.rk)    # x·y    ℓ-1
        t = ev.multiply_relin_rescale(y2, xy, sess.rk)    # x·y³   ℓ-2
        y15 = mult_const_to(sess, y, 1.5, t.scale)       # ℓ-1, scale == t
        y15 = sess.reach_level(y15, t.level)
        y = ev.sub(y15, t)
    return y


def sqrt(sess: Session, x: Ciphertext, guess: float,
         iter_num: int) -> Ciphertext:
    """√x = (1/√(2x)) · √2·x  (reference ``he_math.cpp:211-232``)."""
    s = inv_sqrt_twice(sess, x, guess, iter_num)
    xr = sess.reach_level(x, s.level)
    x2 = mult_const_to(sess, xr, _m.sqrt(2.0), s.scale)
    s = sess.reach_level(s, x2.level)
    return sess.ev.multiply_relin_rescale(s, x2, sess.rk)


def abs_(sess: Session, x: Ciphertext, guess: float,
         iter_num: int) -> Ciphertext:
    """|x| = √(x²)  (reference ``he_math.cpp:237-269``).  The inv-sqrt
    guess applies to x², so it should approximate 1/√(2·x²)."""
    xx = sess.ev.square_relin_rescale(x, sess.rk)
    return sqrt(sess, xx, guess, iter_num)


def twice_max(sess: Session, x1: Ciphertext, x2: Ciphertext, guess: float,
              iter_num: int) -> Ciphertext:
    """2·max(x₁,x₂) = (x₁+x₂) + |x₁−x₂|  (server workload,
    ``server.cpp:489-503``)."""
    ev = sess.ev
    a, b = sess.align(x1, x2)
    s = ev.add(a, b)
    d = abs_(sess, ev.sub(a, b), guess, iter_num)
    s = sess.reach_level(s, d.level)
    # align scales exactly: multiply the sum by 1 at a solved scale
    if abs(s.scale - d.scale) > 1e-9 * d.scale:
        s = mult_const_to(sess, s, 1.0, d.scale)
        d = sess.reach_level(d, s.level)
    return ev.add(s, d)


def max_(sess: Session, x1, x2, guess: float, iter_num: int) -> Ciphertext:
    t = twice_max(sess, x1, x2, guess, iter_num)
    return mult_const_to(sess, t, 0.5, t.scale)


def min_(sess: Session, x1, x2, guess: float, iter_num: int) -> Ciphertext:
    """2·min = (x₁+x₂) − |x₁−x₂|."""
    ev = sess.ev
    a, b = sess.align(x1, x2)
    s = ev.add(a, b)
    d = abs_(sess, ev.sub(a, b), guess, iter_num)
    s = sess.reach_level(s, d.level)
    if abs(s.scale - d.scale) > 1e-9 * d.scale:
        s = mult_const_to(sess, s, 1.0, d.scale)
        d = sess.reach_level(d, s.level)
    t = ev.sub(s, d)
    return mult_const_to(sess, t, 0.5, t.scale)
