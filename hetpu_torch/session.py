"""Session: the user-facing bundle of context + keys + engines, on one
device.

Counterpart of ``hetpu/session.py`` (``Session.create``, ``encode``,
``encrypt``, ``decrypt``, ``slots``).  ``device`` chooses where the keys,
tables and ciphertexts live: ``"cuda"`` runs the CUDA kernels, ``"cpu"``
their plain PyTorch versions; both give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .core.ciphertext import Ciphertext, Plaintext
from .core.context import Context
from .core.encoding import CkksEncoder
from .core.encrypt import Decryptor, Encryptor
from .core.evaluator import Evaluator
from .core.keys import GaloisKeys, KeyGenerator, RelinKeys
from .core.params import HeParams, preset


@dataclass
class Session:
    ctx: Context
    encoder: CkksEncoder
    ev: Evaluator
    rk: RelinKeys | None = None
    gk: GaloisKeys | None = None
    encryptor: Encryptor | None = None
    decryptor: Decryptor | None = None

    @classmethod
    def create(cls, params: HeParams | str, *, seed: bytes | None = None,
               galois_steps=None, device="cpu") -> "Session":
        """Keys in the reference's order (public, relin, galois), so a
        seed gives the reference's keys bit for bit."""
        if isinstance(params, str):
            params = preset(params)
        ctx = Context(params, device)
        kg = KeyGenerator(ctx, seed=seed)
        pk = kg.create_public_key()
        rk = kg.create_relin_keys()
        gk = kg.create_galois_keys(galois_steps)
        return cls(
            ctx=ctx, encoder=CkksEncoder(ctx), ev=Evaluator(ctx), rk=rk, gk=gk,
            encryptor=Encryptor(ctx, public_key=pk, secret_key=kg.secret),
            decryptor=Decryptor(ctx, kg.secret),
        )

    @property
    def slots(self) -> int:
        return self.encoder.slot_count

    def encode(self, values, level=None, scale=None) -> Plaintext:
        return self.encoder.encode(values, level, scale)

    def encrypt(self, values, level=None, scale=None,
                seed: bytes | None = None) -> Ciphertext:
        return self.encryptor.encrypt(self.encode(values, level, scale),
                                      seed=seed)

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        return self.decryptor.decrypt(ct)
