"""What the benchmark makes from ``--seed`` and hands to both sides: the
key seed, the values, and the encryption seeds.

Every draw comes from SHA-256 of the run's seed and a label, so any whole
number (of any size or sign) gives one stream, and the same seed gives
the same keys, values and ciphertexts.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def derive(seed: int, label: str) -> bytes:
    return hashlib.sha256(f"hebench/{label}/{seed}".encode()).digest()


def key_seed(seed: int) -> bytes:
    """The 32-byte seed of the session's keys (``Session.create``)."""
    return derive(seed, "keys")


class Inputs:
    """The seed's values and encryptions, in the order a driver asks."""

    def __init__(self, seed: int):
        self.seed = seed
        self.rng = np.random.default_rng(
            int.from_bytes(derive(seed, "values")[:16], "little"))
        self._enc = 0

    def encrypt(self, sess, rows: np.ndarray):
        """One ciphertext a row of slot values, stacked into a batch
        ``[rows, 2, L, N]`` on the session's device."""
        cts = []
        for row in rows:
            self._enc += 1
            cts.append(sess.encrypt(row, seed=derive(self.seed,
                                                     f"enc/{self._enc}")))
        return cts[0].with_(data=torch.stack([c.data for c in cts]))

    def sample(self, pool: int, within: int) -> list[int]:
        """One call index a pool entry, drawn among its first ``within``
        turns: the calls whose answers are kept for the comparison."""
        turns = self.rng.integers(0, within, pool)
        return [int(k) * pool + b for b, k in enumerate(turns)]
