"""Carry state of the JAX package (``hetpu``) into this package.

Each function takes a ``hetpu`` object — or anything with the same
attributes holding arrays (``np.asarray`` is applied, so numpy and JAX
arrays both work) — and returns its counterpart here with tensors on
``device``.  Nothing here imports ``hetpu`` or JAX: the caller, which
already holds the object, supplies it.
"""

from __future__ import annotations

import numpy as np

from .core.ciphertext import Ciphertext
from .core.keys import KSwitchKey, PublicKey, RelinKeys, SecretKey
from .core.modular import from_u32


def _t(a, device):
    return from_u32(np.asarray(a), device)


def secret_key(sk, device="cpu") -> SecretKey:
    return SecretKey(data=_t(sk.data, device), seed=getattr(sk, "seed", b""))


def public_key(pk, device="cpu") -> PublicKey:
    return PublicKey(data=_t(pk.data, device))


def kswitch_key(k, device="cpu") -> KSwitchKey:
    return KSwitchKey(data=_t(k.data, device), shoup=_t(k.shoup, device))


def relin_keys(rk, device="cpu") -> RelinKeys:
    if getattr(rk, "more", ()):
        raise ValueError("relinearization keys for s^3 and up are not "
                         "ported yet")
    return RelinKeys(key=kswitch_key(rk.key, device))


def ciphertext(ct, device="cpu") -> Ciphertext:
    return Ciphertext(data=_t(ct.data, device), level=int(ct.level),
                      scale=float(ct.scale))
