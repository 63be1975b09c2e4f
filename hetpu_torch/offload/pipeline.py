"""The encrypted inference layer of the offload pipeline.

Counterpart of ``hetpu/offload/pipeline.py`` ``_infer_weights``,
``infer_step`` and ``infer_reference`` (the workload of
``evaluate_sharded_infer``; the transport and the device mesh are not
ported).  A batch of encrypted vectors [B, 2, L, N] goes through the step
as one ciphertext.
"""

from __future__ import annotations

import numpy as np

from ..core.modular import mod_add
from ..math import mult_const_to
from ..session import Session


def _infer_weights(slots: int, n_diags: int, wseed: int):
    """Deterministic model weights derived from a seed: ``n_diags``
    circulant diagonals and a degree-2 activation polynomial."""
    rng = np.random.default_rng(wseed)
    diags = rng.uniform(-1, 1, (n_diags, slots)) / n_diags
    act = (0.5, 0.25, -0.02)          # c0 + c1·u + c2·u² (sigmoid-ish)
    return diags, act


def infer_step(sess: Session, ct, diags, act):
    """One inference layer on an encrypted activation vector: a
    diagonal-method matvec against plaintext weights (the rotations share
    ONE hoisted decomposition) and a degree-2 activation polynomial with
    exact solved-scale alignment.  Consumes 3 levels."""
    ev = sess.ev
    n_diags = len(diags)
    rots = [ct] + ev.rotate_hoisted(ct, list(range(1, n_diags)), sess.gk)
    q = sess.ctx.mont(ct.level)["q"]
    acc = None
    for d, src in enumerate(rots):
        pt = sess.cached_encode(("infer_diag", d, n_diags), diags[d],
                                level=src.level)
        term = ev.multiply_plain(src, pt)
        acc = term.data if acc is None else mod_add(acc, term.data, q)
    u = ev.rescale(term.with_(data=acc))               # W·x
    c0, c1, c2 = act
    u2 = ev.square_relin_rescale(u, sess.rk)           # u²
    s = u.scale
    quad = mult_const_to(sess, u2, c2, s)
    lin = mult_const_to(sess, sess.reach_level(u, u2.level), c1, s)
    y = ev.add(quad, lin)
    return ev.add_plain(y, sess.const_like(y, c0))


def infer_reference(x: np.ndarray, diags: np.ndarray, act) -> np.ndarray:
    """Plaintext replica of :func:`infer_step`."""
    u = sum(diags[d] * np.roll(x, -d) for d in range(len(diags)))
    c0, c1, c2 = act
    return c0 + c1 * u + c2 * u * u
