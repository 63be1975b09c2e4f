"""RLWE encryption / decryption.

Counterpart of ``hetpu/core/encrypt.py``: public-key and seeded symmetric
encryption with the reference's sampling domains (1-3 public, 101-102
symmetric), so a seed gives the same ciphertext in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from . import random as rnd
from .ciphertext import Ciphertext, Plaintext
from .context import Context
from .encoding import CkksEncoder
from .keys import PublicKey, SecretKey
from .modular import from_u32, mod_add, mod_neg, mont_mul, shoup_mul, to_u32
from .ntt import ntt_fwd_mont, ntt_inv
from ..utils.profiling import phase


class Encryptor:
    def __init__(self, ctx: Context, public_key: PublicKey | None = None,
                 secret_key: SecretKey | None = None):
        if public_key is None and secret_key is None:
            raise ValueError("need a public or secret key")
        self.ctx = ctx
        self.pk = public_key
        self.sk = secret_key

    def _sample(self, sampler, seed: bytes, domain: int, level: int):
        """Signed draw of the seed's stream → residues on the device."""
        n = self.ctx.params.poly_degree
        q = np.array(self.ctx.params.moduli[: level + 1],
                     dtype=np.uint32).reshape(-1, 1)
        return from_u32(rnd.signed_to_rns(sampler(seed, domain, n), q),
                        self.ctx.device)

    @phase("encrypt")
    def encrypt(self, pt: Plaintext, seed: bytes | None = None) -> Ciphertext:
        """Public-key encryption: (b·u + e0 + m, a·u + e1)."""
        if self.pk is None:
            return self.encrypt_symmetric(pt, seed)
        lvl = pt.level
        tabs = self.ctx.tables(lvl)
        mc = self.ctx.mont(lvl)
        q, rinv = mc["q"], mc["r_inv"]
        seed = seed if seed is not None else rnd.new_seed()
        u_m = ntt_fwd_mont(self._sample(rnd.ternary, seed, 1, lvl), tabs)
        e0m = ntt_fwd_mont(self._sample(rnd.gaussian, seed, 2, lvl), tabs)
        e1m = ntt_fwd_mont(self._sample(rnd.gaussian, seed, 3, lvl), tabs)
        b, a = self.pk.data[0, : lvl + 1], self.pk.data[1, : lvl + 1]
        ptm = shoup_mul(pt.data, tabs.r, tabs.r_shoup, tabs.q)
        c0 = mod_add(mod_add(mont_mul(b, u_m, q, rinv), e0m, q), ptm, q)
        c1 = mod_add(mont_mul(a, u_m, q, rinv), e1m, q)
        return Ciphertext(data=torch.stack([c0, c1]), level=lvl,
                          scale=pt.scale)

    @phase("encrypt")
    def encrypt_symmetric(self, pt: Plaintext,
                          seed: bytes | None = None) -> Ciphertext:
        """Secret-key encryption: (-(a·s) + e + m, a) with `a` expanded from
        a seed — the compact-wire form the reference's client uses."""
        if self.sk is None:
            raise ValueError("symmetric encryption needs the secret key")
        ctx = self.ctx
        lvl = pt.level
        n = ctx.params.poly_degree
        tabs = ctx.tables(lvl)
        mc = ctx.mont(lvl)
        q, rinv = mc["q"], mc["r_inv"]
        seed = seed if seed is not None else rnd.new_seed()
        q_host = np.array(ctx.params.moduli[: lvl + 1],
                          dtype=np.uint32).reshape(-1, 1)
        a = from_u32(rnd.uniform_rns(seed, 101, q_host, n), ctx.device)
        e_m = ntt_fwd_mont(self._sample(rnd.gaussian, seed, 102, lvl), tabs)
        s = self.sk.data[: lvl + 1]
        ptm = shoup_mul(pt.data, tabs.r, tabs.r_shoup, tabs.q)
        c0 = mod_add(mod_add(mod_neg(mont_mul(a, s, q, rinv), q), e_m, q),
                     ptm, q)
        return Ciphertext(data=torch.stack([c0, a]), level=lvl,
                          scale=pt.scale)


class Decryptor:
    def __init__(self, ctx: Context, secret_key: SecretKey):
        self.ctx = ctx
        self.sk = secret_key
        self._encoder: CkksEncoder | None = None

    def decrypt_to_coeffs(self, ct: Ciphertext) -> np.ndarray:
        """Σ_k c_k·s^k, INTT'd → standard-form coefficient residues
        [..., ℓ+1, N] (numpy uint32)."""
        lvl = ct.level
        mc = self.ctx.mont(lvl)
        q, rinv = mc["q"], mc["r_inv"]
        s = self.sk.data[: lvl + 1]
        acc = ct.data[..., 0, :, :]
        s_pow = s
        for k in range(1, ct.num_parts):
            acc = mod_add(acc, mont_mul(ct.data[..., k, :, :], s_pow, q, rinv),
                          q)
            s_pow = mont_mul(s_pow, s, q, rinv)
        return to_u32(ntt_inv(acc.contiguous(), self.ctx.tables(lvl),
                              strip_mont=True))

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        """Decrypt + CKKS-decode to complex slot values; a batched
        ciphertext [B, parts, L, N] gives [B, slots]."""
        if self._encoder is None:
            self._encoder = CkksEncoder(self.ctx)
        coeffs = self.decrypt_to_coeffs(ct)
        if coeffs.ndim == 2:
            return self._encoder.decode(coeffs, ct.level, ct.scale)
        flat = coeffs.reshape(-1, *coeffs.shape[-2:])
        vals = [self._encoder.decode(c, ct.level, ct.scale) for c in flat]
        return np.stack(vals).reshape(*coeffs.shape[:-2], -1)
