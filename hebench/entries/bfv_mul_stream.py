"""A saturating stream of ``BfvSession.multiply_relin`` calls (the HPS
multiply over Q and the auxiliary basis B, then relinearize), each on a
batch of BFV ciphertext pairs from a device-resident pool.

The stream of :mod:`.mul_stream`, with the values drawn uniform in
[0, t) and the plain math x·y mod t: every output is folded, and the
outputs of one sampled call a pool batch, and of the last call, are
kept for the comparison.
"""

from __future__ import annotations

from . import mul_stream


def galois_steps(p: dict) -> list:
    return []


class Driver(mul_stream.Driver):
    def __init__(self, sess, p: dict, inputs):
        self.sess = sess
        self.t = sess.ctx.params.plain_modulus
        super().__init__(sess, p, inputs)

    def draw(self, rng, p: dict):
        return rng.integers(0, self.t, (p["batch"], self.slots))

    def op(self, a, b):
        return self.sess.multiply_relin(a, b)

    def plain(self, x, y) -> dict:
        return {"x": x, "y": y, "t": self.t}
