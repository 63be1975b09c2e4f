"""Trusted client (counterpart of ``hetpu/offload/client.py``; the
reference's ``src/demos/client.cpp``).

Owns the secret key on ``device``; encodes and symmetric-encrypts the
operands under a fresh seed each (seeded: half the wire size,
``client.cpp:113-115``), ships params, evaluation keys and ciphertexts,
receives the encrypted results and decrypts them locally.
"""

from __future__ import annotations

import numpy as np

from ..core import random as rnd
from ..core.params import HeParams
from ..runtime import native
from ..session import Session
from . import recv_reply, send_request


class Client:
    def __init__(self, params: HeParams | str = "ckks_small",
                 galois_steps=None, seed: bytes | None = None,
                 device="cuda"):
        self.sess = Session.create(params, seed=seed,
                                   galois_steps=galois_steps, device=device)

    # -- helpers -------------------------------------------------------
    def _encrypt_seeded(self, values):
        seed = rnd.new_seed()
        ct = self.sess.encryptor.encrypt_symmetric(self.sess.encode(values),
                                                   seed=seed)
        return ct, seed

    def _roundtrip(self, t, workload, cts_seeds, meta=None, gk=False):
        cts = [c for c, _ in cts_seeds]
        seeds = [s for _, s in cts_seeds]
        send_request(t, workload, self.sess.ctx.params, rk=self.sess.rk,
                     gk=self.sess.gk if gk else None, cts=cts, seeds=seeds,
                     meta=meta)
        return recv_reply(t, self.sess.ctx)

    # -- workloads (client_side_* parity, client.cpp:66-870) -----------
    def simple(self, t, x1, x2):
        """ct×ct product (client.cpp:66-171)."""
        res = self._roundtrip(t, "simple",
                              [self._encrypt_seeded(x1),
                               self._encrypt_seeded(x2)])
        return self.sess.decrypt(res[0])

    def batch_matmul(self, t, a: np.ndarray, b: np.ndarray):
        """Element-per-ct matmul of slot-batched matrices
        (client.cpp:173-319; dims sent out of band as at :250-254).
        a: [m, n] or [m, n, batch]; b: [n, p] or [n, p, batch]."""
        m, n = a.shape[:2]
        n2, p = b.shape[:2]
        ops = [self._encrypt_seeded(a[i, j]) for i in range(m) for j in range(n)]
        ops += [self._encrypt_seeded(b[i, j]) for i in range(n2) for j in range(p)]
        res = self._roundtrip(t, "batch_matmul", ops, meta={"dims": [m, n, p]})
        out = np.stack([self.sess.decrypt(r) for r in res])
        return out.reshape(m, p, -1)

    def inv(self, t, x, guess: float, iters: int):
        """1/x (client.cpp:321-426)."""
        res = self._roundtrip(t, "inv", [self._encrypt_seeded(x)],
                              meta={"guess": guess, "iters": iters})
        return self.sess.decrypt(res[0])

    def inv_sqrt_twice(self, t, x, guess: float, iters: int):
        """1/√(2x) (client.cpp:428-532)."""
        res = self._roundtrip(t, "inv_sqrt_twice", [self._encrypt_seeded(x)],
                              meta={"guess": guess, "iters": iters})
        return self.sess.decrypt(res[0])

    def abs(self, t, x, guess: float, iters: int):
        res = self._roundtrip(t, "abs", [self._encrypt_seeded(x)],
                              meta={"guess": guess, "iters": iters})
        return self.sess.decrypt(res[0])

    def twice_max(self, t, x1, x2, guess: float, iters: int):
        res = self._roundtrip(t, "twice_max",
                              [self._encrypt_seeded(x1),
                               self._encrypt_seeded(x2)],
                              meta={"guess": guess, "iters": iters})
        return self.sess.decrypt(res[0])

    def fft(self, t, coeffs: np.ndarray):
        """Encrypted DFT of a length-n complex vector (client.cpp:749-870)."""
        ops = [self._encrypt_seeded(c) for c in coeffs]
        res = self._roundtrip(t, "fft", ops, meta={"n": len(coeffs)})
        return np.array([self.sess.decrypt(r)[0] for r in res])


def connect() -> native.Transport:
    return native.connect()
