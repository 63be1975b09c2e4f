"""RNS fast base conversion (FBC) between prime bases.

Counterpart of ``hetpu/core/rns.py`` (``FbcPlan``, ``make_fbc`` and
``fbc_apply`` with the plain f32 α).  ``fbc_apply`` converts residues of
CENTERED values between bases with a float32 α-correction (a misround
shifts by ±P — absorbed as bounded noise at every use site).  The
two-float precise α of the reference (used by BFV) is not ported yet.

Bit-exactness with the reference hinges on α = round(Σ_i f32(y_i)·f32(1/p_i)).
The reference computes it as ``jnp.sum(y.astype(f32) * recip, axis=-2)``
inside ``jax.jit``, which XLA compiles into one chain of fused
multiply-adds: s ← fma(f32(y_i), f32(1/p_i), s) for i = 0…A−1 from s = 0,
one rounding per step; then α rounds half to even.  :func:`fma_f32`
reproduces that single rounding exactly (a multiply and an add rounded
separately would flip α on rare near-half columns and shift the
coefficient by P).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import nt
from .modular import from_u32, mod_add, mod_sub, shoup_mul, shoup_precompute, u32


def _col(xs, dt=np.uint32):
    return np.array(xs, dtype=dt).reshape(-1, 1)


@dataclass(frozen=True)
class FbcPlan:
    """Convert RNS residues over basis P to residues over basis R (int32
    tensors; ``p_recip`` float32)."""
    inv_punit: torch.Tensor       # [(P/p_i)^{-1} mod p_i]   [Lp, 1]
    inv_punit_shoup: torch.Tensor
    p: torch.Tensor               # source primes            [Lp, 1]
    p_recip: torch.Tensor         # f32(1/p_i)               [Lp, 1]
    phat_mod_r: torch.Tensor      # (P/p_i) mod r_j          [Lp, Lr]
    phat_shoup: torch.Tensor
    ptot_mod_r: torch.Tensor      # P mod r_j                [Lr, 1]
    ptot_shoup: torch.Tensor
    r: torch.Tensor               # target primes            [Lr, 1]


def make_fbc(src_primes, dst_primes, device) -> FbcPlan:
    P = 1
    for p in src_primes:
        P *= int(p)
    inv_punit = _col([nt.modinv((P // p) % p, p) for p in src_primes])
    phat = np.array([[(P // p) % r for r in dst_primes] for p in src_primes],
                    dtype=np.uint32)
    rcol = _col(dst_primes)
    pcol = _col(src_primes)
    ptot = _col([P % r for r in dst_primes])
    t = lambda a: from_u32(a, device)
    return FbcPlan(
        inv_punit=t(inv_punit),
        inv_punit_shoup=t(shoup_precompute(inv_punit, pcol)),
        p=t(pcol),
        p_recip=torch.from_numpy(
            (1.0 / pcol.astype(np.float64)).astype(np.float32)).to(device),
        phat_mod_r=t(phat),
        phat_shoup=t(np.stack([shoup_precompute(phat[:, j:j + 1],
                                                rcol[j:j + 1])[:, 0]
                               for j in range(len(dst_primes))], axis=1)),
        ptot_mod_r=t(ptot),
        ptot_shoup=t(shoup_precompute(ptot, rcol)),
        r=t(rcol),
    )


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """float32 a·b + c rounded ONCE to nearest even, as a fused
    multiply-add rounds it (``__fmaf_rn`` on the card).  The product of
    two float32 values is exact in float64 (24 × 24 bits); its sum with c
    is split by TwoSum into hi + lo exactly.  Casting hi to float32 rounds
    correctly unless hi lies exactly halfway between two float32 values
    while lo ≠ 0: then the exact sum lies on lo's side of that tie."""
    p = a.to(torch.float64) * b.to(torch.float64)
    s = c.to(torch.float64)
    hi = p + s
    z = hi - p
    lo = (p - (hi - z)) + (s - z)
    f = hi.to(torch.float32)
    f64 = f.to(torch.float64)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=f.device)
    g = torch.nextafter(f, torch.where(hi > f64, inf, -inf))
    tie = (f64 + g.to(torch.float64)) == 2 * hi
    return torch.where(tie & (lo != 0) & ((lo > 0) == (g > f)), g, f)


def alpha_f32(v: torch.Tensor, recip: torch.Tensor) -> torch.Tensor:
    """round_half_even(fma chain of f32(v_i)·recip_i over i ascending)
    as int64 [..., 1, N]; v int32 [..., S, N] (signed values welcome),
    recip float32 [S, 1]."""
    al = torch.zeros_like(v[..., :1, :], dtype=torch.float32)
    for i in range(v.shape[-2]):
        al = fma_f32(v[..., i:i + 1, :].to(torch.float32), recip[i, 0], al)
    return torch.round(al).to(torch.int64)


def fbc_apply(x: torch.Tensor, plan: FbcPlan, *, correct: bool = True,
              premul: bool = True) -> torch.Tensor:
    """x: int32 [..., Lp, N] standard-form residues → [..., Lr, N] over the
    target basis.  ``correct=True`` assumes centered values (subtracts
    α·P); ``correct=False`` returns the plain lift Σ y_i·(P/p_i) mod r.
    ``premul=False`` means x already carries the P̂⁻¹ factors."""
    y = shoup_mul(x, plan.inv_punit, plan.inv_punit_shoup,
                  plan.p) if premul else x
    if correct:
        alpha = alpha_f32(y, plan.p_recip)
    outs = []
    for j in range(plan.r.shape[0]):
        r = plan.r[j:j + 1]
        acc = None
        for i in range(plan.p.shape[0]):
            term = shoup_mul(y[..., i:i + 1, :], plan.phat_mod_r[i, j],
                             plan.phat_shoup[i, j], r)
            acc = term if acc is None else mod_add(acc, term, r)
        if correct:
            corr = (alpha * u32(plan.ptot_mod_r[j]) % u32(r)).to(torch.int32)
            acc = mod_sub(acc, corr, r)
        outs.append(acc)
    return torch.cat(outs, dim=-2)
