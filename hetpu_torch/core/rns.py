"""RNS fast base conversion (FBC) between prime bases.

Counterpart of ``hetpu/core/rns.py`` (``FbcPlan``, ``make_fbc``,
``_alpha_precise`` and ``fbc_apply``).  ``fbc_apply`` converts residues of
CENTERED values between bases with a float32 α-correction (a misround
shifts by ±P — absorbed as bounded noise at every use site), or with
``precise=True`` with the two-float α of BFV (:func:`_alpha_precise`).
A precise conversion of a CUDA tensor, in BFV's form (with the
premultiply and the α-correction), launches kernel ``fbc_precise`` (K9,
``csrc/fbc_precise.cu``, :func:`fbc_precise`) on the constants that each
``FbcPlan`` packs from its fields into ``kernel_consts``; a CPU tensor
takes the plain PyTorch :func:`fbc_apply_plain`.

Bit-exactness with the reference hinges on α = round(Σ_i f32(y_i)·f32(1/p_i)).
The reference computes it as ``jnp.sum(y.astype(f32) * recip, axis=-2)``
inside ``jax.jit``, which XLA compiles into one chain of fused
multiply-adds: s ← fma(f32(y_i), f32(1/p_i), s) for i = 0…A−1 from s = 0,
one rounding per step; then α rounds half to even.  :func:`fma_f32`
reproduces that single rounding exactly (a multiply and an add rounded
separately would flip α on rare near-half columns and shift the
coefficient by P).  The precise α is different: the reference runs it
eagerly, outside ``jax.jit`` (``hetpu/core/bfv.py``), so each of its f32
products and sums rounds on its own, and so does each eager torch op of
:mod:`.twofloat` here, and each spelled-out float32 op of K9.

:data:`convert_bytes` counts the device-memory bytes of the precise
conversions by the rule of :func:`.cuda_lib.plane_bytes` (every source
limb read once, every target limb written once, as int32 planes), only
while a torch profiler records, on either route (K9's launches count the
same bytes under ``launch_bytes["fbc_precise"]`` too);
:func:`.cuda_lib.reset_launches` clears it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import cuda_lib, nt
from .cuda_lib import plane_bytes
from .modular import (add_i64, from_u32, shoup_mul, shoup_precompute,
                      sub_i64, to_u32, u32)
from ..utils.profiling import profiler_on

# conversion → bytes of its calls made while a profiler recorded
convert_bytes = cuda_lib.register_counter({"fbc_apply": 0})
MAX_SRC, MAX_DST = 16, 16      # K9's largest plan (csrc/fbc_precise.cu)


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
    # two-float split of 2^16/p_i and 1/p_i for the precise α (float32)
    r16_hi: torch.Tensor          # f32 hi of 2^16/p_i       [Lp, 1]
    r16_lo: torch.Tensor          # f32 residual             [Lp, 1]
    r0_hi: torch.Tensor           # f32 hi of 1/p_i          [Lp, 1]
    r0_lo: torch.Tensor
    phat_mod_r: torch.Tensor      # (P/p_i) mod r_j          [Lp, Lr]
    phat_shoup: torch.Tensor
    ptot_mod_r: torch.Tensor      # P mod r_j                [Lr, 1]
    ptot_shoup: torch.Tensor
    r: torch.Tensor               # target primes            [Lr, 1]
    # K9's constants packed from the fields above (:func:`pack_consts`);
    # derived, so ``dataclasses.replace`` packs them anew
    kernel_consts: torch.Tensor = field(init=False, repr=False,
                                        compare=False)

    def __post_init__(self):
        object.__setattr__(self, "kernel_consts",
                           from_u32(pack_consts(self), self.r.device))


def _two_float(x: np.ndarray):
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def make_fbc(src_primes, dst_primes, device="cuda") -> FbcPlan:
    P = 1
    for p in src_primes:
        P *= int(p)
    inv_punit = _col([nt.modinv((P // p) % p, p) for p in src_primes])
    phat = np.array([[(P // p) % r for r in dst_primes] for p in src_primes],
                    dtype=np.uint32)
    rcol = _col(dst_primes)
    pcol = _col(src_primes)
    ptot = _col([P % r for r in dst_primes])
    pcol_f = pcol.astype(np.float64)
    r16_hi, r16_lo = _two_float((2.0 ** 16) / pcol_f)
    r0_hi, r0_lo = _two_float(1.0 / pcol_f)
    t = lambda a: from_u32(a, device)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    return FbcPlan(
        inv_punit=t(inv_punit),
        inv_punit_shoup=t(shoup_precompute(inv_punit, pcol)),
        p=t(pcol),
        p_recip=f(1.0 / pcol_f),
        r16_hi=f(r16_hi), r16_lo=f(r16_lo), r0_hi=f(r0_hi), r0_lo=f(r0_lo),
        phat_mod_r=t(phat),
        phat_shoup=t(np.stack([shoup_precompute(phat[:, j:j + 1],
                                                rcol[j:j + 1])[:, 0]
                               for j in range(len(dst_primes))], axis=1)),
        ptot_mod_r=t(ptot),
        ptot_shoup=t(shoup_precompute(ptot, rcol)),
        r=t(rcol),
    )


def fbc_chunk(src_primes, dst_primes) -> int:
    """Terms K9 adds into its unsigned 64-bit sum between two reductions:
    the most that cannot overflow after a reduced value (< r), each term
    y_i·(P/p_i mod r) ≤ (p − 1)(r − 1), or α·(r − P mod r) ≤ Lp·r (α ≤
    Lp, as every y_i/p_i < 1)."""
    p, r = max(map(int, src_primes)), max(map(int, dst_primes))
    term = max((p - 1) * (r - 1), len(src_primes) * r)
    return min(((1 << 64) - r) // term, 64)


def pack_consts(plan: FbcPlan) -> np.ndarray:
    """K9 ``fbc_precise``'s constants as uint32 words, read from the
    plan's fields, in the order it stages them: (P/p_i) mod r_f at i·F +
    f; per target r_f, ⌊2^32/r_f⌋ (the Shoup companion of 1), 2^32 mod
    r_f and its companion, P mod r_f; per source p_i, (P/p_i)⁻¹ mod p_i
    and its companion, the float32 bits of 2^16/p_i's and 1/p_i's
    two-float splits (hi, lo, hi, lo); last :func:`fbc_chunk`."""
    w = lambda t: to_u32(t).astype(np.uint64)
    r, pcol = w(plan.r), w(plan.p)
    r32 = (np.uint64(1) << np.uint64(32)) % r
    per_f = [r, shoup_precompute(np.ones_like(r), r), r32,
             shoup_precompute(r32, r), w(plan.ptot_mod_r)]
    per_s = [pcol, w(plan.inv_punit), w(plan.inv_punit_shoup)] + [
        w(f.view(torch.int32)) for f in (plan.r16_hi, plan.r16_lo,
                                         plan.r0_hi, plan.r0_lo)]
    chunk = fbc_chunk(pcol[:, 0], r[:, 0])
    words = [w(plan.phat_mod_r).reshape(-1),
             np.concatenate(per_f, axis=1).reshape(-1),
             np.concatenate(per_s, axis=1).reshape(-1), [chunk]]
    return np.concatenate([np.asarray(a, dtype=np.uint64) for a in words]
                          ).astype(np.uint32)


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
    inf = torch.full_like(f, float("inf"))     # no host copy: capturable
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


def _alpha_precise(y: torch.Tensor, plan: FbcPlan) -> torch.Tensor:
    """round(Σ y_i/p_i) with ~2^-40 total error via the two-float error-free
    transformations of :mod:`.twofloat` — the exactness-grade α of BFV.
    y: int32 [..., Lp, N] standard-form residues (< 2^31, so the 16-bit
    halves convert to float32 exactly) → int64 [..., 1, N].  Every float32
    op is its own eager torch op, as the reference's eager call runs it:
    the exact products of all source primes at once, then their sum in the
    reference's order (i ascending, the high half first)."""
    from .twofloat import ds_add, ds_round, two_prod
    y_top = (y >> 16).to(torch.float32)
    y_bot = (y & 0xFFFF).to(torch.float32)
    p1, e1 = two_prod(y_top, plan.r16_hi)
    e1 = e1 + y_top * plan.r16_lo
    p0, e0 = two_prod(y_bot, plan.r0_hi)
    e0 = e0 + y_bot * plan.r0_lo
    hi = torch.zeros_like(y[..., :1, :], dtype=torch.float32)
    lo = torch.zeros_like(hi)
    for i in range(plan.p.shape[0]):
        row = slice(i, i + 1)
        hi, lo = ds_add(hi, lo, p1[..., row, :], e1[..., row, :])
        hi, lo = ds_add(hi, lo, p0[..., row, :], e0[..., row, :])
    return ds_round(hi, lo).to(torch.int64)


def fbc_apply(x: torch.Tensor, plan: FbcPlan, *, correct: bool = True,
              premul: bool = True, precise: bool = False) -> torch.Tensor:
    """x: int32 [..., Lp, N] standard-form residues → [..., Lr, N] over the
    target basis.  ``correct=True`` assumes centered values (subtracts
    α·P); ``correct=False`` returns the plain lift Σ y_i·(P/p_i) mod r.
    ``premul=False`` means x already carries the P̂⁻¹ factors.
    ``precise=True`` takes α from :func:`_alpha_precise` (two-float, the
    BFV grade) instead of the f32 fma chain.  A precise call of a CUDA
    tensor launches K9 (:func:`fbc_precise`) and takes only BFV's form
    (``correct`` and ``premul``); every other call takes
    :func:`fbc_apply_plain`.  A precise call adds its bytes to
    :data:`convert_bytes` while a profiler records, on either route."""
    if precise and profiler_on():
        lp, lr = plan.p.shape[0], plan.r.shape[0]
        rows = x[..., 0, 0].numel()
        convert_bytes["fbc_apply"] += plane_bytes(x.shape[-1],
                                                  rows * (lp + lr))
    if precise and cuda_lib.on_card(x, plan.kernel_consts):
        if not (correct and premul):
            raise ValueError("fbc_apply: a precise conversion on the card "
                             "is BFV's form (correct and premul), kernel "
                             "fbc_precise; fbc_apply_plain takes the others")
        return fbc_precise(x, plan)
    return fbc_apply_plain(x, plan, correct=correct, premul=premul,
                           precise=precise)


def fbc_apply_plain(x: torch.Tensor, plan: FbcPlan, *, correct: bool = True,
                    premul: bool = True,
                    precise: bool = False) -> torch.Tensor:
    """:func:`fbc_apply` in plain PyTorch on either device (K9's twin in
    the precise form).  Each source term is taken mod every target prime
    in one op (exact int64 arithmetic, so the order of the terms is
    free)."""
    y = shoup_mul(x, plan.inv_punit, plan.inv_punit_shoup,
                  plan.p) if premul else x
    r = u32(plan.r)                                     # [Lr, 1]
    yy = u32(y)
    acc = None
    for i in range(plan.p.shape[0]):
        term = yy[..., i:i + 1, :] * u32(plan.phat_mod_r[i]).reshape(-1, 1) % r
        acc = term if acc is None else add_i64(acc, term, r)
    if correct:
        alpha = (_alpha_precise(y, plan) if precise
                 else alpha_f32(y, plan.p_recip))
        acc = sub_i64(acc, alpha * u32(plan.ptot_mod_r) % r, r)
    return acc.to(torch.int32)


def fbc_precise(x: torch.Tensor, plan: FbcPlan) -> torch.Tensor:
    """``fbc_apply(x, plan, correct=True, premul=True, precise=True)`` on
    the card: kernel ``fbc_precise`` (K9), one pass over x [..., Lp, N]
    (int32, contiguous, 16-byte aligned, N a multiple of 4) into a new
    [..., Lr, N]; the bits of the plain body."""
    cuda_lib.check_i32("fbc_precise", x)
    if x.device.type != "cuda":
        raise ValueError(f"fbc_precise: x on {x.device}; the kernel takes a "
                         "CUDA tensor (fbc_apply_plain takes the others)")
    lp, lr = plan.p.shape[0], plan.r.shape[0]
    if x.dim() < 2 or x.shape[-2] != lp:
        raise ValueError(f"fbc_precise: shape {tuple(x.shape)} is not "
                         f"[..., {lp}, N]")
    if lp > MAX_SRC or lr > MAX_DST:
        raise ValueError(f"fbc_precise: {lp} → {lr} primes; the kernel takes "
                         f"at most {MAX_SRC} → {MAX_DST}")
    if x.device != plan.kernel_consts.device:
        raise ValueError(f"fbc_precise: x on {x.device}, the plan on "
                         f"{plan.kernel_consts.device}")
    n = x.shape[-1]
    rows = x.numel() // (lp * n) if n else 0
    out = torch.empty((*x.shape[:-2], lr, n), dtype=torch.int32,
                      device=x.device)
    if rows == 0:
        return out
    if n % 4:
        raise ValueError(f"fbc_precise: N={n} is no multiple of 4 (a thread "
                         "moves 4 columns)")
    cuda_lib.check_aligned("fbc_precise", x, out)
    cuda_lib.launch("fbc_precise", "hetpu_fbc_precise", x.device,
                    x.data_ptr(), out.data_ptr(), rows, lp, lr, n,
                    plan.kernel_consts.data_ptr(),
                    nbytes=plane_bytes(n, rows * lp, rows * lr))
    return out
