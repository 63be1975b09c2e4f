"""The int8-digit pieces of the JAX package's matrix-unit NTT and FBC.

Counterparts of ``hetpu/core/mxu_ntt.py`` ``_OFF`` (:62),
``_extract_digit_list`` (:473), ``_extract_digits`` (:488),
``_shoup_scalarish`` (:501), ``_carry_save`` (:531) and ``_fold_mul``
(:553).  The probe ``probes/kernel_parts.py`` uses the first and the
third; the rest are the pieces an int8 tensor-core NTT on the card would
be built from.

Plain PyTorch, with the reference's 32-bit semantics: u32 values are held
as their int32 bit pattern (as in :mod:`.modular`), and every wrapping u32
add, multiply or shift of the reference is computed in int64 and masked,
so nothing relies on int32 overflow.  Arguments may be int32 tensors or
Python ints (a Python int is the unsigned value); results are int32 bit
patterns, and the digit lists int8.
"""

from __future__ import annotations

import torch

from .modular import to_i32, u32

OFF = 1 << 23                   # unsigned offset of the recombination
_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def _u(x):
    """u32 value in int64 (tensor) or a Python int."""
    return u32(x) if isinstance(x, torch.Tensor) else int(x) & _MASK32


def _s(x):
    """The reference's ``x.astype(int32)``: the signed value of the bit
    pattern, in int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64)
    x = int(x) & _MASK32
    return x - (1 << 32) if x >= 1 << 31 else x


def wrap_i8(v: torch.Tensor) -> torch.Tensor:
    """``astype(int8)`` of an integer tensor: the low 8 bits, signed."""
    wide = v.dtype in (torch.int32, torch.int64)
    b = (v if wide else v.to(torch.int32)) & 255
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product of two u32 values (int64)."""
    a, b = _u(a), _u(b)
    a0, a1 = a & _MASK16, a >> 16
    b0, b1 = b & _MASK16, b >> 16
    mid = a1 * b0 + a0 * b1                  # < 2^33
    return a1 * b1 + (((mid << 16) + a0 * b0) >> 32)


def mullo_u32(a, b):
    """Low 32 bits of the product of two u32 values (int64)."""
    a, b = _u(a), _u(b)
    return (a * (b & _MASK16) + (((a * (b >> 16)) & _MASK16) << 16)) \
        & _MASK32


def extract_digit_list(x, q, q_half) -> list[torch.Tensor]:
    """u32 residues → 4 balanced int8 digit tensors: v = x − q if
    x > q_half (signed compare), then 3 digits in [−128, 128) and the
    remaining high part."""
    v = _s(x)
    v = v - torch.where(v > _s(q_half), _s(q), 0)
    ds = []
    for _ in range(3):
        d = ((v + 128) & 255) - 128
        ds.append(d.to(torch.int8))
        v = (v - d) >> 8
    ds.append(wrap_i8(v))
    return ds


def extract_digits(x) -> list[torch.Tensor]:
    """u32 residues → 4 UNSIGNED-SHIFTED int8 digits d_j = ((x >> 8j) &
    255) − 128, so x = Σ (d_j + 128)·2^{8j}."""
    v = _u(x)
    return [(((v >> (8 * j)) & 255) - 128).to(torch.int8) for j in range(4)]


def shoup_scalarish(x, w, ws, q) -> torch.Tensor:
    """The reference's Shoup multiply with broadcast operands: q_est =
    mulhi(x, ws), r = x·w − q_est·q (mod 2^32), one conditional subtract.
    x may exceed q; for a true companion ws = ⌊w·2^32/q⌋ this is x·w mod q."""
    q_est = mulhi_u32(x, ws)
    r = (mullo_u32(x, w) - mullo_u32(q_est, q)) & _MASK32
    qq = _u(q)
    return to_i32(torch.where(r >= qq, r - qq, r))


def carry_save(g_list) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact u32 pair (s_lo, s_hi) with s_hi·2^32 + s_lo = Σ_j 2^{8j}·(G_j
    + OFF) for int32 digit-plane sums |G_j| ≤ 2^23."""
    u0, u1, u2, u3 = ((_s(g) + OFF) & _MASK32 for g in g_list)
    t1 = (u0 + ((u1 << 8) & _MASK32)) & _MASK32
    c1 = (t1 < u0).to(torch.int64)
    t2 = (t1 + ((u2 << 16) & _MASK32)) & _MASK32
    c2 = (t2 < t1).to(torch.int64)
    s_lo = (t2 + ((u3 << 24) & _MASK32)) & _MASK32
    c3 = (s_lo < t2).to(torch.int64)
    s_hi = ((u1 >> 24) + (u2 >> 16) + (u3 >> 8) + c1 + c2 + c3) & _MASK32
    return to_i32(s_lo), to_i32(s_hi)


def fold_mul(s_lo, s_hi, c, cs, cR, cRs, corr, q) -> torch.Tensor:
    """y·mult mod q from a carry-save pair: c·s_lo + cR·s_hi − corr, with
    two Shoup multiplies and wrapping u32 adds as in the reference."""
    qq, cc = _u(q), _u(corr)
    s = (_u(shoup_scalarish(s_lo, c, cs, q))
         + _u(shoup_scalarish(s_hi, cR, cRs, q))) & _MASK32
    s = torch.where(s >= qq, s - qq, s)
    return to_i32(torch.where(s >= cc, s - cc, (s + ((qq - cc) & _MASK32))
                              & _MASK32))
