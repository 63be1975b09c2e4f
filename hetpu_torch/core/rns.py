"""RNS fast base conversion (FBC) between prime bases.

Counterpart of ``hetpu/core/rns.py`` (``FbcPlan``, ``make_fbc`` and
``fbc_apply`` with the plain f32 α).  ``fbc_apply`` converts residues of
CENTERED values between bases with a float32 α-correction (a misround
shifts by ±P — absorbed as bounded noise at every use site).  The
two-float precise α of the reference (used by BFV) is not ported yet.

Bit-exactness with the reference hinges on α = round(Σ_i f32(y_i)·f32(1/p_i)):
the sum runs over i = 0…A−1 in that order as separate f32 multiplies and
adds (never a fused multiply-add, never a tree reduction), and rounds
half to even.
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


def make_fbc(src_primes, dst_primes, device="cpu") -> FbcPlan:
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


def fbc_alpha(y: torch.Tensor, plan: FbcPlan) -> torch.Tensor:
    """α = round_half_even(Σ_i f32(y_i)·f32(1/p_i)), i ascending, as int64
    [..., 1, N].  One f32 multiply and one f32 add per term, each its own
    rounding step (the CUDA kernel uses __fmul_rn/__fadd_rn in the same
    order)."""
    al = None
    for i in range(plan.p.shape[0]):
        t = y[..., i:i + 1, :].to(torch.float32) * plan.p_recip[i, 0]
        al = t if al is None else al + t
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
        alpha = fbc_alpha(y, plan)
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
