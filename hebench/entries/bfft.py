"""A saturating stream of forward in-slot FFTs (``hetpu_torch.fft.bfft``),
each call one transform of a batch of ciphertexts from a device-resident
pool, every ciphertext one n-point complex signal tiled over its slots.

A call runs log2(n) stages: each decomposes its input once, makes the
hoisted ±h rotations (the first stage's ±n/2 merged through the tiling:
one rotation), multiplies the diagonal plaintext masks and adds them, and
rescales.  The host enqueues without waiting.  As in :mod:`.mul_stream`,
every output is folded, and the outputs of one sampled call a pool batch,
and of the last call, are kept for the comparison, which reads every slot
of every ciphertext (``hebench.reference.bfft``).
"""

from __future__ import annotations

import numpy as np

from hetpu_torch.fft import bfft

from . import mul_stream


def galois_steps(p: dict) -> list:
    """The forward transform's steps: +n/2, then ±h for h = n/4 … 1."""
    n = p["n"]
    hs = [n >> (s + 1) for s in range(n.bit_length() - 1)]
    return hs[:1] + [s for h in hs[1:] for s in (h, -h)]


class Driver(mul_stream.Driver):
    """``batch`` is the transforms a call (one a ciphertext), the unit
    ``ops_per_s`` counts."""

    def __init__(self, sess, p: dict, inputs):
        self.sess = sess
        self.slots = sess.slots
        self.units = p["batch"]
        self.n = p["n"]
        lo, hi = p["value_range"]
        shape = (p["batch"], self.n)
        self.pool = []
        for _ in range(p["pool"]):
            x = inputs.rng.uniform(lo, hi, shape)
            x = x + 1j * inputs.rng.uniform(lo, hi, shape)
            ct = inputs.encrypt(sess, np.tile(x, (1, self.slots // self.n)))
            self.pool.append((x, None, ct, None))
        self.keep = set(inputs.sample(p["pool"], p["keep_within"]))
        self.min_calls = max(self.keep) + 1
        self.fold = p["fold"]
        self.kept, self.last = {}, None
        self.counts = [0] * p["pool"]
        self.acc = None

    def op(self, a, b):
        return bfft(self.sess, a, self.n)

    def plain(self, x, y) -> dict:
        return {"x": x, "slots": self.slots}
