"""RLWE sampling (host-side, seeded, reproducible).

Counterpart of ``hetpu/core/random.py``, kept identical: the same seed and
domain tag give the same draws in both packages, which is what makes keys
and ciphertexts bit-equal across them.  Replaces SEAL's ``UniformRandomGenerator``/``ClippedNormalDistribution``
sampling inside ``KeyGenerator``/``Encryptor`` (reference relies on it via
every keygen/encrypt call — SURVEY.md §2b).  Philox counter-based RNG so a
32-byte seed fully determines the stream: this is what makes *seeded
symmetric ciphertexts* possible (client sends a seed instead of the `a`
polynomial, halving wire size — the reference leans on
``encrypt_symmetric`` for exactly this, ``client.cpp:113-115``).

All samplers return standard-form RNS residue arrays [L, N] uint32 given
the prime column [L, 1]; callers NTT/Montgomery-convert as needed.
"""

from __future__ import annotations

import secrets

import numpy as np

NOISE_STD = 3.2          # SEAL's default error std-dev
NOISE_MAX = 6 * 3.2      # truncation bound


def new_seed() -> bytes:
    return secrets.token_bytes(32)


def _gen(seed: bytes, domain: int) -> np.random.Generator:
    """Independent stream per (seed, domain-tag).  Philox takes a 2×u64 key;
    fold the 32-byte seed and the domain tag into it."""
    w = np.frombuffer(seed, dtype=np.uint64)
    mix = np.uint64((0x9E3779B97F4A7C15 * domain) & 0xFFFFFFFFFFFFFFFF)
    mix1 = np.uint64((0x9E3779B97F4A7C15 * domain + 1) & 0xFFFFFFFFFFFFFFFF)
    key = np.array([w[0] ^ w[2] ^ mix, w[1] ^ w[3] ^ mix1], dtype=np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


def uniform_rns(seed: bytes, domain: int, primes: np.ndarray, n: int) -> np.ndarray:
    """Uniform in [0, q_i) per limb — used for the `a` part of RLWE samples.
    Sampled directly in the evaluation domain (uniform is uniform under NTT)."""
    g = _gen(seed, domain)
    L = primes.shape[0]
    out = np.empty((L, n), dtype=np.uint32)
    for i in range(L):
        out[i] = g.integers(0, int(primes[i, 0]), size=n, dtype=np.uint64).astype(
            np.uint32
        )
    return out


def ternary(seed: bytes, domain: int, n: int) -> np.ndarray:
    """Uniform ternary {-1,0,1} secret coefficients (SEAL's default secret
    distribution), as int64 in {-1,0,1}."""
    g = _gen(seed, domain)
    return g.integers(-1, 2, size=n, dtype=np.int64)


def gaussian(seed: bytes, domain: int, n: int) -> np.ndarray:
    """Centered discrete gaussian noise, σ=3.2 truncated at 6σ, int64."""
    g = _gen(seed, domain)
    x = np.rint(g.normal(0.0, NOISE_STD, size=n))
    return np.clip(x, -NOISE_MAX, NOISE_MAX).astype(np.int64)


def signed_to_rns(coeffs: np.ndarray, primes: np.ndarray) -> np.ndarray:
    """Small signed int64 coeffs [N] → residues [L, N] uint32."""
    q = primes.astype(np.int64)                       # [L, 1]
    r = coeffs[None, :] % q                           # numpy % is nonneg for q>0
    return r.astype(np.uint32)
