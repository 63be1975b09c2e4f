"""Encrypted 2-D least-squares fit — the flagship end-to-end pipeline
(reference ``bench_he_least_squares_2d``, matrix_operations.cpp:833-1040;
call stack SURVEY.md §3.1); counterpart of
``hetpu/models/least_squares.py``, on the session's device.

Fits y = a·x + b over n encrypted points:
    a = (n·Σxy − Σx·Σy) / D,   b = (Σx²·Σy − Σx·Σxy) / D,
    D = n·Σx² − (Σx)²
with rotation-tree sums, a slot-0 mask before inversion (the reference's
FIXME workaround at matrix_operations.cpp:951 — partial sums in slots ≠ 0
would diverge under signed_inv), and the product-form signed_inv.

Exact-scale discipline throughout (solved constant scales) — no drift.
"""

from __future__ import annotations

from ..core.ciphertext import Ciphertext
from ..linalg.batched import BatchedVector
from ..math import mult_const_to, signed_inv
from ..session import Session


def least_squares_2d(sess: Session, cx: Ciphertext, cy: Ciphertext, n: int,
                     inv_guess: float, inv_iters: int = 6):
    """cx, cy: ciphertexts whose first n slots are the data points.
    Returns (ct_a, ct_b); the fitted coefficients live in slot 0."""
    ev = sess.ev
    X = BatchedVector(sess, cx, n)
    Y = BatchedVector(sess, cy, n)

    sum_x = X.sum_elems().ct                   # level L,   scale Δ
    sum_y = Y.sum_elems().ct
    sum_xx = X.square().sum_elems().ct         # level L-1, scale s1 = Δ²/q_L
    sum_xy = (X * Y).sum_elems().ct
    s1 = sum_xx.scale

    # D = n·Σx² − (Σx)²
    sum_x_sq = ev.square_relin_rescale(sum_x, sess.rk)      # (L-1, s1)
    n_sxx = mult_const_to(sess, sum_xx, float(n), s1)      # (L-2, s1)
    denom = ev.sub(n_sxx, sess.reach_level(sum_x_sq, n_sxx.level))

    # isolate slot 0 before inverting (reference FIXME parity)
    denom = BatchedVector(sess, denom, 1).mask([0]).ct
    inv_d = signed_inv(sess, denom, inv_guess, inv_iters)

    # numerators
    sxy_l = ev.multiply_relin_rescale(sess.reach_level(sum_x, sum_y.level),
                                      sum_y, sess.rk)       # Σx·Σy (L-1, s1)
    n_sxy = mult_const_to(sess, sum_xy, float(n), s1)      # (L-2, s1)
    num_a = ev.sub(n_sxy, sess.reach_level(sxy_l, n_sxy.level))

    xx_y = ev.multiply_relin_rescale(sum_xx,
                                     sess.reach_level(sum_y, sum_xx.level),
                                     sess.rk)               # Σx²·Σy (L-2)
    x_xy = ev.multiply_relin_rescale(sess.reach_level(sum_x, sum_xy.level),
                                     sum_xy, sess.rk)       # Σx·Σxy (L-2)
    num_b = ev.sub(xx_y, x_xy)

    a = ev.multiply_relin_rescale(sess.reach_level(num_a, inv_d.level),
                                  inv_d, sess.rk)
    b = ev.multiply_relin_rescale(sess.reach_level(num_b, inv_d.level),
                                  inv_d, sess.rk)
    return a, b
