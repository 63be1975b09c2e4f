"""Carry state of the JAX package (``hetpu``) into this package.

Each function takes a ``hetpu`` object — or anything with the same
attributes holding arrays (``np.asarray`` is applied, so numpy and JAX
arrays both work) — and returns its counterpart here with tensors on
``device`` (the card unless ``device="cpu"``).  Nothing here imports
``hetpu`` or JAX: the caller, which already holds the object, supplies it.
"""

from __future__ import annotations

import numpy as np

from .core.ciphertext import Ciphertext, Plaintext
from .core.keys import GaloisKeys, KSwitchKey, PublicKey, RelinKeys, SecretKey
from .core.modular import from_u32


def _t(a, device):
    return from_u32(np.asarray(a), device)


def secret_key(sk, device="cuda") -> SecretKey:
    return SecretKey(data=_t(sk.data, device), seed=getattr(sk, "seed", b""))


def public_key(pk, device="cuda") -> PublicKey:
    return PublicKey(data=_t(pk.data, device))


def kswitch_key(k, device="cuda") -> KSwitchKey:
    return KSwitchKey(data=_t(k.data, device), shoup=_t(k.shoup, device))


def relin_keys(rk, device="cuda") -> RelinKeys:
    return RelinKeys(key=kswitch_key(rk.key, device),
                     more=tuple(kswitch_key(k, device)
                                for k in getattr(rk, "more", ())))


def galois_keys(gk, device="cuda") -> GaloisKeys:
    return GaloisKeys(elts=tuple(int(e) for e in gk.elts),
                      keys=tuple(kswitch_key(k, device) for k in gk.keys))


def ciphertext(ct, device="cuda") -> Ciphertext:
    return Ciphertext(data=_t(ct.data, device), level=int(ct.level),
                      scale=float(ct.scale))


def plaintext(pt, device="cuda") -> Plaintext:
    return Plaintext(data=_t(pt.data, device), shoup=_t(pt.shoup, device),
                     level=int(pt.level), scale=float(pt.scale))
