"""Operator DSL — infix homomorphic expressions.

Counterpart of ``hetpu/ops/__init__.py``, on the session's device.
Parity with reference ``he::operators`` (``include/he_operators.h`` +
``src/core/he_operators.cpp``): the reference's ``%`` operator ties a
SEAL Evaluator/keys to operands (``he_operators.h:22-39``); here a
``Session`` plays that role and ``HE(sess, ct)`` wraps a ciphertext into
an expression object with the same operator surface:

    ==========  =======================================  ==============
    reference   meaning                                  here
    ==========  =======================================  ==============
    ``-x``      negate            (he_operators.cpp:14)  ``-x``
    ``x + y``   add ct/pt                 (:33-64)       ``x + y``
    ``x - y``   sub ct/pt                 (:69-100)      ``x - y``
    ``x * y``   multiply ct/pt            (:105-142)     ``x * y``
    ``x & rk``  relinearize               (:147-161)     ``x & sess.rk``
    ``x ^ 1``   rescale_to_next           (:166-180)     ``x ^ 1``
    ``x | 1``   mod_switch_to_next        (:185-199)     ``x | 1``
    ``x << k``  rotate slots left         (:204-220)     ``x << k``
    ``x >> k``  rotate slots right        (:221-237)     ``x >> k``
    ==========  =======================================  ==============

Plain operands (scalars / numpy arrays) are auto-encoded at the
ciphertext's level and scale.  ``.ct`` unwraps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.ciphertext import Ciphertext
from ..core.keys import RelinKeys
from ..session import Session

__all__ = ["HE"]


@dataclass
class HE:
    sess: Session
    ct: Ciphertext

    # -- helpers -------------------------------------------------------
    def _wrap(self, ct: Ciphertext) -> "HE":
        return HE(self.sess, ct)

    def _coerce_pt(self, other):
        return self.sess.const_like(self.ct, other)

    # -- arithmetic ----------------------------------------------------
    def __neg__(self) -> "HE":
        return self._wrap(self.sess.ev.negate(self.ct))

    def __add__(self, other) -> "HE":
        if isinstance(other, HE):
            a, b = self.sess.align(self.ct, other.ct)
            return self._wrap(self.sess.ev.add(a, b))
        return self._wrap(self.sess.ev.add_plain(self.ct,
                                                 self._coerce_pt(other)))

    __radd__ = __add__

    def __sub__(self, other) -> "HE":
        if isinstance(other, HE):
            a, b = self.sess.align(self.ct, other.ct)
            return self._wrap(self.sess.ev.sub(a, b))
        return self._wrap(self.sess.ev.sub_plain(self.ct,
                                                 self._coerce_pt(other)))

    def __mul__(self, other) -> "HE":
        if isinstance(other, HE):
            a, b = self.sess.align(self.ct, other.ct)
            return self._wrap(self.sess.ev.multiply(a, b))
        pt = self.sess.encode(other, level=self.ct.level)
        return self._wrap(self.sess.ev.multiply_plain(self.ct, pt))

    __rmul__ = __mul__

    # -- maintenance ops (the reference's punctuation) -----------------
    def __and__(self, rk: RelinKeys) -> "HE":
        """relinearize (reference ``ct & rk``)."""
        return self._wrap(self.sess.ev.relinearize(self.ct, rk))

    def __xor__(self, times: int) -> "HE":
        """rescale `times` levels (reference ``ct ^ 1``)."""
        out = self.ct
        for _ in range(times):
            out = self.sess.ev.rescale(out)
        return self._wrap(out)

    def __or__(self, times: int) -> "HE":
        """mod_switch `times` levels (reference ``ct | 1``)."""
        out = self.ct
        for _ in range(times):
            out = self.sess.ev.mod_switch(out)
        return self._wrap(out)

    def __lshift__(self, steps: int) -> "HE":
        return self._wrap(self.sess.ev.rotate(self.ct, steps, self.sess.gk))

    def __rshift__(self, steps: int) -> "HE":
        return self._wrap(self.sess.ev.rotate(self.ct, -steps, self.sess.gk))

    # -- terminal ------------------------------------------------------
    def decrypt(self) -> np.ndarray:
        return self.sess.decrypt(self.ct)
