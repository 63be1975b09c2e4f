"""Coefficient-axis (sequence-parallel) sharded NTT: the four-step
transform with one all-to-all.

Counterpart of ``hetpu/parallel/cp.py`` (``cp_ntt_fwd`` :43, ``cp_ntt_inv``
:72) and of the part of ``hetpu/core/ntt4.py`` it runs (``FourStepTables``
:39 without its int8 digit matrices, ``_fwd_axis2`` :155, ``_inv_axis2``
:175).  The N coefficients are viewed as an [n1, n2] matrix (n2 = 128 for
N ≤ 2^14, else 256): sub-NTT along n1 → twiddle → transpose → sub-NTT
along n2.  Over ``cp`` ranks that transpose IS the exchange:

  fwd: coefficients sharded on the n2 axis → local sub-NTT along n1 →
       local twiddle → ONE all-to-all (the n1 ↔ n2 transpose) → local
       sub-NTT along n2 → evaluations sharded in contiguous N/cp blocks;
  inv: the mirror, evaluations in, ONE all-to-all, coefficients out.

Each rank returns the whole [L, N] result (its shard gathered with the
others'), equal bit for bit to the flat :func:`..core.ntt.ntt_fwd` /
``ntt_inv`` (the ``ntt`` kernel on the card) and to hetpu's four-step.
The sub-transforms (n1, n2 ≤ 256, below the ``ntt`` kernel's 2^10) are
plain int64 PyTorch on either device, as hetpu computes them outside any
Pallas kernel; the exchanges are ``peer_permute`` launches on the card.
The plain int64 products need no Shoup companions, so the tables carry
none.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..core import nt
from ..core.modular import add_i64, sub_i64
from .peer import all_gather, all_to_all


@dataclass(frozen=True)
class FourStepTables:
    """The flat transform's ψ split into an [n1, n2] four-step, int64
    tensors on one device: sub-transform twiddles [L, n_sub] (bit-reversed
    powers of ψ^{n2} and ψ^{n1}), their N_sub⁻¹ constants [L] (and
    n1⁻¹·R⁻¹, R = 2^32, for the inverse that strips the Montgomery
    factor), and the inter-step twiddles [L, n1, n2]."""

    n: int
    n1: int
    n2: int
    primes: tuple[int, ...]
    q: torch.Tensor
    sub1_fwd: torch.Tensor
    sub1_inv: torch.Tensor
    sub1_n_inv: torch.Tensor
    sub1_n_inv_rinv: torch.Tensor
    sub2_fwd: torch.Tensor
    sub2_inv: torch.Tensor
    sub2_n_inv: torch.Tensor
    t_fwd: torch.Tensor
    t_inv: torch.Tensor


def _powers(base: int, count: int, q: int) -> np.ndarray:
    out = np.empty(count, dtype=np.int64)
    x = 1
    for i in range(count):
        out[i] = x
        x = x * base % q
    return out


@lru_cache(maxsize=None)
def _host(n: int, primes: tuple[int, ...]) -> dict[str, np.ndarray]:
    n2 = 128 if n <= (1 << 14) else 256
    n1 = n // n2
    L = len(primes)
    out = {k: np.zeros((L, s), dtype=np.int64) for k, s in (
        ("sub1_fwd", n1), ("sub1_inv", n1), ("sub2_fwd", n2),
        ("sub2_inv", n2))}
    out.update({k: np.zeros(L, dtype=np.int64) for k in (
        "sub1_n_inv", "sub1_n_inv_rinv", "sub2_n_inv")})
    out["t_fwd"] = np.zeros((L, n1, n2), dtype=np.int64)
    out["t_inv"] = np.zeros((L, n1, n2), dtype=np.int64)
    br1 = np.array([nt.bit_reverse(i, n1.bit_length() - 1)
                    for i in range(n1)])
    br2 = np.array([nt.bit_reverse(i, n2.bit_length() - 1)
                    for i in range(n2)])
    for li, q in enumerate(primes):
        psi = nt.root_of_unity(2 * n, q)
        psi_i = nt.modinv(psi, q)
        for k, size, br, e in (("sub1", n1, br1, n2), ("sub2", n2, br2, n1)):
            out[f"{k}_fwd"][li] = _powers(pow(psi, e, q), size, q)[br]
            out[f"{k}_inv"][li] = _powers(pow(psi_i, e, q), size, q)[br]
            out[f"{k}_n_inv"][li] = nt.modinv(size, q)
        out["sub1_n_inv_rinv"][li] = nt.modinv(n1, q) \
            * nt.modinv((1 << 32) % q, q) % q
        for p in range(n1):
            e = int(1 + 2 * br1[p] - n1) % (2 * n)
            out["t_fwd"][li, p] = _powers(pow(psi, e, q), n2, q)
            out["t_inv"][li, p] = _powers(pow(psi_i, e, q), n2, q)
    out["q"] = np.array(primes, dtype=np.int64)
    return out


def build_tables(n: int, primes, device="cuda") -> FourStepTables:
    """Four-step tables of the flat N-point transform over ``primes``."""
    primes = tuple(int(p) for p in primes)
    h = _host(n, primes)
    n2 = h["sub2_fwd"].shape[1]
    return FourStepTables(n=n, n1=n // n2, n2=n2, primes=primes,
                          **{k: torch.from_numpy(v).to(device)
                             for k, v in h.items()})


def _fwd_axis2(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor):
    """Negacyclic Cooley-Tukey along axis -2 of int64 x [L, n_sub, V]."""
    L, n, V = x.shape
    q4 = q.reshape(L, 1, 1, 1)
    m, half = 1, n // 2
    while m < n:
        x = x.reshape(L, m, 2, half, V)
        u = x[..., 0, :, :]
        v = x[..., 1, :, :] * w[:, m: 2 * m].reshape(L, m, 1, 1) % q4
        x = torch.stack([add_i64(u, v, q4), sub_i64(u, v, q4)], dim=-3)
        m, half = m * 2, half // 2
    return x.reshape(L, n, V)


def _inv_axis2(x: torch.Tensor, w: torch.Tensor, q: torch.Tensor,
               fin: torch.Tensor):
    """Gentleman-Sande along axis -2 of int64 x [L, n_sub, V], times the
    per-limb constant ``fin`` [L]."""
    L, n, V = x.shape
    q4 = q.reshape(L, 1, 1, 1)
    m, half = n // 2, 1
    while m >= 1:
        x = x.reshape(L, m, 2, half, V)
        u, v = x[..., 0, :, :], x[..., 1, :, :]
        d = sub_i64(u, v, q4) * w[:, m: 2 * m].reshape(L, m, 1, 1) % q4
        x = torch.stack([add_i64(u, v, q4), d], dim=-3)
        m, half = m // 2, half * 2
    return x.reshape(L, n, V) * fin.reshape(L, 1, 1) % q.reshape(L, 1, 1)


def _check(t: FourStepTables, x: torch.Tensor, cp: int) -> int:
    if t.n1 % cp or t.n2 % cp:
        raise ValueError(f"cp={cp} must divide n1={t.n1} and n2={t.n2}")
    if x.dim() != 2 or x.shape != (len(t.primes), t.n):
        raise ValueError(f"expected [{len(t.primes)}, {t.n}], got "
                         f"{tuple(x.shape)}")
    return x.shape[0]


def cp_ntt_fwd(x: torch.Tensor, t: FourStepTables, mesh,
               axis: str = "cp") -> torch.Tensor:
    """x int32 [L, N] coefficients (natural order) → [L, N] bit-reversed
    evaluations, the flat ``ntt_fwd``'s bits.  Rank i transforms the n2
    columns i·n2/cp … and holds the i-th contiguous N/cp block of the
    output before the gather."""
    cp = mesh.shape[axis]
    L = _check(t, x, cp)
    i, w2 = mesh.axis_index(axis), t.n2 // cp
    cols = slice(i * w2, (i + 1) * w2)
    y = x.reshape(L, t.n1, t.n2)[:, :, cols].to(torch.int64)
    y = _fwd_axis2(y, t.sub1_fwd, t.q)                    # along n1
    y = y * t.t_fwd[:, :, cols] % t.q.reshape(L, 1, 1)
    y = y.transpose(-1, -2).to(torch.int32)               # [L, n2/cp, n1]
    y = all_to_all(y, mesh, axis, split_axis=2, concat_axis=1)
    y = _fwd_axis2(y.to(torch.int64), t.sub2_fwd, t.q)    # [L, n2, n1/cp]
    y = y.transpose(-1, -2).to(torch.int32)               # [L, n1/cp, n2]
    return all_gather(y, mesh, axis, dim=1).reshape(L, t.n)


def cp_ntt_inv(x: torch.Tensor, t: FourStepTables, mesh, axis: str = "cp",
               *, strip_mont: bool = False) -> torch.Tensor:
    """Mirror of :func:`cp_ntt_fwd`: [L, N] bit-reversed evaluations →
    [L, N] coefficients (×N⁻¹, and ×R⁻¹ with ``strip_mont``: Montgomery
    evaluations out of standard form), the flat ``ntt_inv``'s bits.  Rank
    i transforms the i-th n1 row block."""
    cp = mesh.shape[axis]
    L = _check(t, x, cp)
    i, h1 = mesh.axis_index(axis), t.n1 // cp
    y = x.reshape(L, t.n1, t.n2)[:, i * h1:(i + 1) * h1, :]
    y = y.transpose(-1, -2).to(torch.int64)               # [L, n2, n1/cp]
    y = _inv_axis2(y, t.sub2_inv, t.q, t.sub2_n_inv)      # along n2
    y = all_to_all(y.to(torch.int32), mesh, axis, split_axis=1,
                   concat_axis=2)                         # [L, n2/cp, n1]
    w2 = t.n2 // cp
    y = y.transpose(-1, -2).to(torch.int64)               # [L, n1, n2/cp]
    y = y * t.t_inv[:, :, i * w2:(i + 1) * w2] % t.q.reshape(L, 1, 1)
    fin = t.sub1_n_inv_rinv if strip_mont else t.sub1_n_inv
    y = _inv_axis2(y, t.sub1_inv, t.q, fin).to(torch.int32)
    return all_gather(y, mesh, axis, dim=2).reshape(L, t.n)
