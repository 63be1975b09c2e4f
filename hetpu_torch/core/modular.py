"""Modular arithmetic on residue tensors (plain PyTorch).

Counterpart of ``hetpu/core/modular.py``.  The JAX package builds every
product from 32-bit lane arithmetic (16-bit mulhi emulation, Montgomery
and Shoup forms) because its chip has no 64-bit multiply.  Every one of
those ops returns the canonical residue in [0, q), so any exact
implementation of the same function gives the same bits; the plain
versions here compute in ``torch.int64``, where the product of two
residues below 2^31 fits:

  * ``shoup_mul(x, w, ws, q)`` = x·w mod q (the companion ``ws`` is what
    the CUDA kernels use; the plain form does not need it)
  * ``mont_mul(a, b, q, r_inv)`` = a·b·R⁻¹ mod q with R = 2^32
  * ``barrett_reduce_u32(x, q, mu)`` = x mod q for any 32-bit x

Storage: residues live in [0, q) as ``torch.int32`` (q < 2^31, so the
bits equal the reference's uint32).  Shoup companions can be ≥ 2^31 and
are stored as the int32 bit pattern; :func:`u32` recovers the unsigned
value in int64.  ``torch.uint32`` is not used: it lacks add, sub, shifts
and compares.  Per-limb constants are [L, 1] tensors that broadcast over
data [..., L, N].
"""

from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


# ----------------------------------------------------------------------
# storage helpers
# ----------------------------------------------------------------------

def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit-pattern storage → int64 holding the unsigned value."""
    return x.to(torch.int64) & _MASK32


def to_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) → int32 bit-pattern storage."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


def from_u32(a, device=None) -> torch.Tensor:
    """numpy array of unsigned values < 2^32 → int32 bit-pattern tensor."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor → numpy uint32 array (host copy)."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ----------------------------------------------------------------------
# multiplication
# ----------------------------------------------------------------------

def mont_mul(a, b, q, r_inv):
    """a·b·R⁻¹ mod q (R = 2^32) for residues a, b < q; ``r_inv`` is the
    per-limb R⁻¹ mod q (``mont_constants(...)["r_inv"]``)."""
    qq = u32(q)
    return ((u32(a) * u32(b)) % qq * u32(r_inv) % qq).to(torch.int32)


def shoup_mul(x, w, w_shoup, q):
    """x·w mod q for x < 2^32 and a constant w < q with Shoup companion
    ``w_shoup`` = ⌊w·2^32/q⌋ (unused by this exact int64 form)."""
    return (u32(x) * u32(w) % u32(q)).to(torch.int32)


def shoup_companion(w, q):
    """⌊w·2^32/q⌋ of w < q as int32 bit-pattern storage (on w's device)."""
    return to_i32((u32(w) << 32) // u32(q))


# ----------------------------------------------------------------------
# add / sub / neg (int32 throughout: no intermediate leaves (-q, q))
# ----------------------------------------------------------------------

def mod_add(a, b, q):
    d = a - (q - b)                          # a + b - q in [-q, q)
    return torch.where(d < 0, d + q, d)


def mod_sub(a, b, q):
    return torch.where(a >= b, a - b, a + (q - b))


def mod_neg(a, q):
    return torch.where(a == 0, torch.zeros_like(a), q - a)


def add_i64(a, b, q):
    """mod_add on int64 values (the plain kernels' working type)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_i64(a, b, q):
    d = a - b
    return torch.where(d < 0, d + q, d)


# ----------------------------------------------------------------------
# reduction of a full 32-bit value
# ----------------------------------------------------------------------

def barrett_reduce_u32(x, q, mu):
    """x mod q for any 32-bit x (``mu`` = ⌊2^32/q⌋ kept for signature
    parity with the reference)."""
    return (u32(x) % u32(q)).to(torch.int32)


# ----------------------------------------------------------------------
# Host-side constant computation (exact Python ints → numpy)
# ----------------------------------------------------------------------

def mont_constants(primes) -> dict[str, np.ndarray]:
    """Per-prime constants, each shaped [L, 1] uint32 for broadcast over
    [L, N]: the reference's set plus ``r_inv`` = R⁻¹ mod q."""
    R = 1 << 32
    qinv = [pow(int(p), -1, R) for p in primes]
    qinv_neg = [(R - x) % R for x in qinv]
    r_mod = [R % int(p) for p in primes]
    r2 = [(R * R) % int(p) for p in primes]
    mu = [R // int(p) for p in primes]
    col = lambda xs, dt=np.uint32: np.array(xs, dtype=dt).reshape(-1, 1)
    out = {
        "q": col([int(p) for p in primes]),
        "qinv": col(qinv),
        "qinv_neg": col(qinv_neg),
        "r_mod_q": col(r_mod),
        "r2": col(r2),
        "mu": col(mu),
        "r_inv": col([pow(R % int(p), -1, int(p)) for p in primes]),
    }
    out["r_mod_q_shoup"] = col([(x << 32) // int(p) for x, p in zip(r_mod, primes)])
    return out


def shoup_precompute(w: np.ndarray, primes: np.ndarray) -> np.ndarray:
    """floor(w * 2^32 / q) elementwise; w shape [..., L, N] (or [L, 1]),
    primes broadcastable.  Host-side exact: w < 2^31 so w<<32 fits uint64."""
    w64 = w.astype(np.uint64)
    q64 = np.broadcast_to(primes, w.shape).astype(np.uint64)
    return ((w64 << np.uint64(32)) // q64).astype(np.uint32)
