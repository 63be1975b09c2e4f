"""Key generation: secret, public, relinearization and Galois keys.

Counterpart of ``hetpu/core/keys.py``: the same seeded host sampling in
the same domain-counter order, so that a seed gives keys bit-equal to the
reference's; the NTTs and the modular arithmetic run on the context's
device.

Representation.  All key polynomials are NTT-domain.  Secret/public keys
are Montgomery form; key-switching keys are stored in Shoup form (value +
⌊value·2^32/q⌋ companion): the key-switch inner product multiplies a
standard-form extended digit by the key with one Shoup multiply, landing
directly in Montgomery form.

Switching-key structure (generalized hybrid, digits of α = #special primes,
P = ∏ specials):
    ksk_j = ( -(a_j·s + e_j) + δ·s' on digit j's limbs ,  a_j )
over the basis {q_0..q_{L-1}} ∪ specials, with δ_i = P mod q_i.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import galois, random as rnd
from .context import Context
from .modular import (from_u32, mod_add, mod_neg, mont_mul, shoup_companion,
                      shoup_mul)
from .ntt import ntt_fwd_mont


@dataclass(frozen=True)
class SecretKey:
    data: torch.Tensor                   # [L_tot, N] Montgomery NTT
    seed: bytes = b""


@dataclass(frozen=True)
class PublicKey:
    data: torch.Tensor                   # [2, L_data, N] Montgomery NTT (b, a)


@dataclass(frozen=True)
class KSwitchKey:
    """Key-switch key in Shoup form: ``data`` holds the NTT-domain key
    values, ``shoup`` the per-element companion ⌊data·2^32/q⌋."""

    data: torch.Tensor                   # [J, 2, L_tot, N] NTT
    shoup: torch.Tensor                  # [J, 2, L_tot, N] companions

    def to(self, device) -> "KSwitchKey":
        return KSwitchKey(data=self.data.to(device),
                          shoup=self.shoup.to(device))


@dataclass(frozen=True)
class RelinKeys:
    """``key`` switches s² → s (keys for s³, s⁴, … are not ported yet)."""

    key: KSwitchKey

    def to(self, device) -> "RelinKeys":
        return RelinKeys(key=self.key.to(device))


@dataclass(frozen=True)
class GaloisKeys:
    elts: tuple = ()
    keys: tuple = ()                     # tuple[KSwitchKey] parallel to elts


class KeyGenerator:
    """Samples a fresh secret on construction (like seal::KeyGenerator).
    Every draw takes the next domain tag of the seed's stream, in the
    reference's order: secret, then whatever keys are created in turn."""

    def __init__(self, ctx: Context, seed: bytes | None = None):
        self.ctx = ctx
        self.seed = seed if seed is not None else rnd.new_seed()
        self._domain = 0
        n = ctx.params.poly_degree
        tabs = ctx.tables_full
        self._q_host = np.array(tabs.primes, dtype=np.uint32).reshape(-1, 1)
        s = rnd.ternary(self.seed, self._next_domain(), n)
        s_rns = from_u32(rnd.signed_to_rns(s, self._q_host), ctx.device)
        self.secret = SecretKey(data=ntt_fwd_mont(s_rns, tabs), seed=self.seed)
        # generalized hybrid: digits of size α = #specials; P = ∏ specials.
        # δ_i = P mod q_i is naturally 0 on special limbs.
        alpha = ctx.num_special
        self.num_digits = J = -(-ctx.num_data // alpha)
        L_tot = len(ctx.all_primes)
        P = 1
        for p in ctx.params.special_moduli:
            P *= p
        self._delta = from_u32(
            np.array([P % q for q in ctx.all_primes]).reshape(L_tot, 1),
            ctx.device)
        self._delta_shoup = shoup_companion(self._delta, tabs.q)
        digit_mask = np.zeros((J, L_tot, 1), dtype=bool)
        for j in range(J):
            digit_mask[j, j * alpha: min((j + 1) * alpha, ctx.num_data)] = True
        self._digit_mask = torch.from_numpy(digit_mask).to(ctx.device)
        self._r_inv = from_u32(
            np.array([pow((1 << 32) % q, -1, q) for q in ctx.all_primes])
            .reshape(L_tot, 1), ctx.device)

    def _next_domain(self) -> int:
        self._domain += 1
        return self._domain

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return from_u32(a, self.ctx.device)

    # ------------------------------------------------------------------
    def create_public_key(self) -> PublicKey:
        ctx = self.ctx
        n = ctx.params.poly_degree
        nd = ctx.num_data
        q_host = self._q_host[:nd]
        a = self._to_dev(rnd.uniform_rns(self.seed, self._next_domain(),
                                         q_host, n))
        e = self._to_dev(rnd.signed_to_rns(
            rnd.gaussian(self.seed, self._next_domain(), n), q_host))
        dtabs = ctx.tables(nd - 1)
        e_m = ntt_fwd_mont(e, dtabs)
        b = mod_neg(mod_add(mont_mul(a, self.secret.data[:nd], dtabs.q,
                                     self._r_inv[:nd]), e_m, dtabs.q), dtabs.q)
        return PublicKey(data=torch.stack([b, a]))

    # ------------------------------------------------------------------
    def _sample_jln(self):
        """[J, L_tot, N] uniform + noise tensors from the seeded stream."""
        n = self.ctx.params.poly_degree
        q = self._q_host
        J = self.num_digits
        a = np.stack([rnd.uniform_rns(self.seed, self._next_domain(), q, n)
                      for _ in range(J)])
        e = np.stack([rnd.signed_to_rns(
            rnd.gaussian(self.seed, self._next_domain(), n), q)
            for _ in range(J)])
        return self._to_dev(a), self._to_dev(e)

    def _kswitch_key(self, s_prime: torch.Tensor) -> KSwitchKey:
        """Switching key for s' → s.  s_prime: [L_tot, N] Montgomery NTT."""
        tabs = self.ctx.tables_full
        a, e = self._sample_jln()
        e_m = ntt_fwd_mont(e, tabs)
        b = mod_neg(mod_add(mont_mul(a, self.secret.data, tabs.q, self._r_inv),
                            e_m, tabs.q), tabs.q)
        term = shoup_mul(s_prime, self._delta, self._delta_shoup, tabs.q)
        b = torch.where(self._digit_mask, mod_add(b, term, tabs.q), b)
        k = torch.stack([b, a], dim=1)
        return KSwitchKey(data=k, shoup=shoup_companion(k, tabs.q))

    def create_relin_keys(self) -> RelinKeys:
        """The s² → s key."""
        s = self.secret.data
        s2 = mont_mul(s, s, self.ctx.tables_full.q, self._r_inv)
        return RelinKeys(key=self._kswitch_key(s2))

    def create_galois_keys(self, steps=None) -> GaloisKeys:
        """Keys for slot rotations.  Default: ± all powers of two plus
        conjugation (the conjugation key is always included)."""
        n = self.ctx.params.poly_degree
        if steps is None:
            slots = n // 2
            steps = []
            p = 1
            while p < slots:
                steps += [p, -p]
                p *= 2
        elts = []
        for s in steps:
            e = galois.rotation_elt(n, s)
            if e not in elts:
                elts.append(e)
        ce = galois.conjugation_elt(n)
        if ce not in elts:
            elts.append(ce)
        keys = []
        for e in elts:
            s_prime = galois.apply(self.secret.data, n, e)
            keys.append(self._kswitch_key(s_prime))
        return GaloisKeys(elts=tuple(elts), keys=tuple(keys))
