"""User-facing BFV session (exact integer HE), on one device.

Counterpart of ``hetpu/bfv.py`` (``BfvSession``): the reference demos
elemwise_square / matmul / batch_matmul_bfv / matpow run on this path with
noise-budget probes.  ``device`` is ``"cuda"`` (the default; raises without
a card) or ``"cpu"`` for the plain PyTorch paths, with the same bits;
``centered_fbc=True`` routes relinearize's conversions through the
centered FBC (the reference's ``HETPU_MXU_FBC=1``).

Rotation nomenclature follows SEAL's BatchEncoder semantics:
``rotate_rows(k)`` cyclically shifts each of the two N/2-slot rows,
``rotate_columns`` swaps the rows — the same galois elements and keys as
CKKS rotation and conjugation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .core.bfv import BfvScheme
from .core.ciphertext import Ciphertext, Plaintext
from .core.context import Context
from .core.encrypt import Encryptor
from .core.evaluator import Evaluator
from .core.keys import GaloisKeys, KeyGenerator, RelinKeys
from .core.params import HeParams, preset
from .utils.profiling import phase


@dataclass
class BfvSession:
    ctx: Context
    scheme: BfvScheme
    ev: Evaluator
    rk: RelinKeys | None
    gk: GaloisKeys | None
    encryptor: Encryptor | None
    sk_data: object            # secret key tensor (None on evaluator side)

    @classmethod
    def create(cls, params: HeParams | str, *, seed: bytes | None = None,
               galois_steps=None, device="cuda",
               centered_fbc: bool = False) -> "BfvSession":
        """Keys in the reference BfvSession's order — relin, galois, then
        public (its keyword arguments are evaluated in that order) — so a
        seed gives its keys bit for bit."""
        if isinstance(params, str):
            with phase("context"):
                params = preset(params)
        ctx = Context(params, device)
        kg = KeyGenerator(ctx, seed=seed)
        rk = kg.create_relin_keys()
        gk = kg.create_galois_keys(galois_steps)
        pk = kg.create_public_key()
        return cls(
            ctx=ctx, scheme=BfvScheme(ctx),
            ev=Evaluator(ctx, centered_fbc=centered_fbc), rk=rk, gk=gk,
            encryptor=Encryptor(ctx, public_key=pk, secret_key=kg.secret),
            sk_data=kg.secret.data,
        )

    @property
    def slots(self) -> int:
        return self.ctx.params.poly_degree

    # -- encode/encrypt/decrypt ----------------------------------------
    def encode(self, values, level=None) -> Plaintext:
        return self.scheme.encode(values, level)

    def encrypt(self, values, level=None, scale=None,
                seed: bytes | None = None) -> Ciphertext:
        """``scale`` is accepted and ignored (signature parity with the CKKS
        Session for the linalg layer: BFV's scale is Δ = Q/t); ``seed``
        fixes the encryption's randomness."""
        return self.scheme.encrypt(self.encryptor, self.encode(values, level),
                                   seed)

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        return self.scheme.decrypt(ct, self.sk_data)

    def noise_budget(self, ct: Ciphertext) -> int:
        return self.scheme.invariant_noise_budget(ct, self.sk_data)

    # -- arithmetic ----------------------------------------------------
    def add(self, a, b):
        return self.ev.add(a, b)

    def sub(self, a, b):
        return self.ev.sub(a, b)

    def negate(self, a):
        return self.ev.negate(a)

    def add_plain(self, ct, pt):
        return self.scheme.add_plain(ct, pt, self.ev)

    def sub_plain(self, ct, pt):
        return self.scheme.sub_plain(ct, pt, self.ev)

    def multiply_plain(self, ct, pt):
        return self.scheme.multiply_plain(ct, pt, self.ev)

    def multiply(self, a, b) -> Ciphertext:
        return self.scheme.multiply(a, b, self.ev)

    def mod_switch(self, ct) -> Ciphertext:
        """SEAL BFV mod_switch_to_next: drop the last prime by
        divide-and-round (message invariant)."""
        return self.scheme.mod_switch(ct)

    def multiply_relin(self, a, b) -> Ciphertext:
        return self.ev.relinearize(self.multiply(a, b), self.rk)

    def square_relin(self, a) -> Ciphertext:
        return self.multiply_relin(a, a)

    def relinearize(self, ct) -> Ciphertext:
        return self.ev.relinearize(ct, self.rk)

    # -- level management (BFV flavour) ----------------------------------
    def align(self, a, b):
        """Bring two ciphertexts to a common level by modulus switching
        (BFV has no scale; levels only shrink ct size / manage noise)."""
        while a.level > b.level:
            a = self.mod_switch(a)
        while b.level > a.level:
            b = self.mod_switch(b)
        return a, b

    # -- scheme protocol of the linalg layer (exact-integer flavour) ----
    def mat_multiply(self, a, b) -> Ciphertext:
        return self.scheme.multiply(a, b, self.ev)

    def mat_reduce_finish(self, c3) -> Ciphertext:
        """Finish an accumulated 3-part sum: relinearize only (no rescale
        in BFV — the invariant scale is Δ = Q/t at every level)."""
        return self.ev.relinearize(c3, self.rk)

    def mat_mult_finish(self, a, b) -> Ciphertext:
        return self.multiply_relin(a, b)

    # -- rotations (SEAL BatchEncoder semantics) -----------------------
    def rotate_rows(self, ct, steps: int) -> Ciphertext:
        return self.ev.rotate(ct, steps, self.gk)

    def rotate_columns(self, ct) -> Ciphertext:
        return self.ev.conjugate(ct, self.gk)
