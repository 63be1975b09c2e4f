"""A saturating stream of encrypted matrix products, each call one
``BatchedMatrix.matmul`` of a d × d matrix A in diagonal layout (d
ciphertexts) by a d × d matrix B in column layout (d ciphertexts), from a
device-resident pool of (A, B) pairs.

The product is the diagonal method over hoisted rotations: B's batch of
columns decomposed once, d − 1 rotation steps, each step's rotation
multiplied by its diagonal of A and added into one running sum, then one
relinearize and one rescale.  The host enqueues without waiting.  As in
:mod:`.mul_stream`, every output is folded, and the outputs of one
sampled call a pool pair, and of the last call, are kept for the
comparison, which reads every slot of each output column
(``hebench.reference.diag_matmul``).
"""

from __future__ import annotations

import numpy as np

from hetpu_torch.linalg import BatchedMatrix

from . import mul_stream


def galois_steps(p: dict) -> list:
    return list(range(1, p["dim"]))


class Driver(mul_stream.Driver):
    """``batch`` is the matrix products a call, the unit ``ops_per_s``
    counts; one a call."""

    def __init__(self, sess, p: dict, inputs):
        if p["batch"] != 1:
            raise ValueError("diag_matmul: one matrix product a call")
        self.sess = sess
        self.slots = sess.slots
        self.units = p["batch"]
        d = p["dim"]
        lo, hi = p["value_range"]
        self.pool = []
        for _ in range(p["pool"]):
            a = inputs.rng.uniform(lo, hi, (d, d))
            b = inputs.rng.uniform(lo, hi, (d, d))
            i = np.arange(d)
            diag = a[i[None, :], (i[None, :] + i[:, None]) % d]
            ca = inputs.encrypt(sess, np.tile(diag, 2))
            cb = inputs.encrypt(sess, np.tile(b.T, 2))
            self.pool.append((a, b, BatchedMatrix(sess, ca, d, d, "diag"),
                              BatchedMatrix(sess, cb, d, d, "col")))
        self.keep = set(inputs.sample(p["pool"], p["keep_within"]))
        self.min_calls = max(self.keep) + 1
        self.fold = p["fold"]
        self.kept, self.last = {}, None
        self.counts = [0] * p["pool"]
        self.acc = None

    def op(self, a, b):
        return a.matmul(b).ct

    def plain(self, x, y) -> dict:
        return {"a": x, "b": y, "slots": self.slots}
