"""Centered fast base conversion: the RNS base switch of the key-switch
digit lift and of the mod-down / fused-rescale tail, on CENTERED source
values.

Counterpart of ``hetpu/core/mxu_fbc.py`` (``MxuFbcPlan`` → here
:class:`CenteredFbcPlan`; ``lift_plan``, ``fbc_plan``).  The JAX package
evaluates the contraction on the TPU's matrix unit as an int8 digit
matmul; there is no such unit here, hence the new name.  The function is
the same, for source residues y [..., S, N] and destination primes q_f:

    v_i    = y_i − q_i if y_i > q_i/2 else y_i
    α      = rint(fma chain of f32(v_i)·f32(1/q_i))      (plans with an α row)
    out[f] = ((Σ_i v_i·C[i, f] − α·P_f)·extra_f) mod q_f

The centered representative differs from the plain one by a multiple of
the source product, so a centered lift is NOT bit-equal to the default
(uncentered) lift: compare it with the reference's centered path only.

:meth:`CenteredFbcPlan.apply` is the counterpart of ``MxuFbcPlan.apply``:
a CUDA tensor launches kernel ``centered_fbc`` (``csrc/centered_fbc.cu``),
a CPU tensor takes :meth:`CenteredFbcPlan.apply_plain`.  The evaluator
built with ``centered_fbc=True`` (the reference's ``HETPU_MXU_FBC=1``)
launches no standalone conversion: every lift and conversion of its path
is fused with the forward NTT that follows it
(``fused_ntt.ntt_fwd_centered_lift`` / ``ntt_fwd_centered_fbc``, kernel
``ntt_fwd_centered``), on these plans' constants.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib
from .modular import from_u32, shoup_precompute, to_u32
from .rns import FbcPlan, alpha_f32


def _col(xs) -> np.ndarray:
    return np.array([int(x) for x in xs], dtype=np.uint32).reshape(-1, 1)


class CenteredFbcPlan:
    """out[f] = ((Σ_i v_i·C[i, f] − α·P_f)·extra_f) mod q_f on ``device``.

    C: [S, F] (reduced mod q_f here).  alpha_coeff: None (no α), or [F]
    holding P mod q_f.  extra: None, or a per-destination constant [F]
    folded in last."""

    def __init__(self, src_primes, dst_primes, C, alpha_coeff=None,
                 extra=None, *, device="cuda"):
        C = np.asarray(C, dtype=np.uint64)
        S, F = C.shape
        if len(src_primes) != S or len(dst_primes) != F:
            raise ValueError(f"C is {C.shape}, primes {len(src_primes)} → "
                             f"{len(dst_primes)}")
        self.S, self.F = S, F
        self.has_alpha = alpha_coeff is not None
        self.has_extra = extra is not None
        qs, qd = _col(src_primes), _col(dst_primes)
        qd_row = qd.reshape(1, F).astype(np.uint64)
        c = (C % qd_row).astype(np.uint32)
        t = lambda a: from_u32(a, device)
        self.q_src = t(qs)                                       # [S, 1]
        self.q_half = t(qs // 2)
        self.recip = torch.from_numpy(
            (1.0 / qs.astype(np.float64)).astype(np.float32)).to(device)
        self.q_dst = t(qd)                                       # [F, 1]
        self.c = t(c)                                            # [S, F]
        self.c_shoup = t(shoup_precompute(c, qd_row))
        if self.has_alpha:
            pm = _col(alpha_coeff) % qd
            self.p_mod, self.p_mod_shoup = t(pm), t(shoup_precompute(pm, qd))
        if self.has_extra:
            ex = _col(np.asarray(extra).reshape(-1)) % qd
            self.extra, self.extra_shoup = t(ex), t(shoup_precompute(ex, qd))
        self.kernel_consts = t(self._kernel_consts(
            c, qs, qd, pm if self.has_alpha else None,
            ex if self.has_extra else None))

    @staticmethod
    def _kernel_consts(c, qs, qd, pm, ex) -> np.ndarray:
        """The ``centered_fbc`` kernel's constants, in the order it stages
        them: C centered ([S, F] as int32 bits: C or C − q_f, whichever is
        smaller in magnitude); per target q_f, floor(2^32/q_f), 2^32 mod
        q_f and its Shoup companion, P_f centered, extra_f and its
        companion (0 where absent), and q_f·floor(2^63/q_f) (low word,
        high word); per source q_i, then f32(1/q_i) bits."""
        qd = qd.astype(np.uint64)                                # [F, 1]
        centered = lambda x, q: np.where(x > q // 2, x.astype(np.int64) - q,
                                         x).astype(np.int64)
        cc = centered(c.astype(np.uint64), qd.reshape(1, -1))
        r32 = (np.uint64(1) << np.uint64(32)) % qd
        zero = np.zeros_like(qd)
        per_f = [qd, shoup_precompute(np.ones_like(qd), qd), r32,
                 shoup_precompute(r32, qd),
                 zero if pm is None else centered(pm.astype(np.uint64), qd),
                 zero if ex is None else ex,
                 zero if ex is None else shoup_precompute(ex, qd)]
        off = qd * ((np.uint64(1) << np.uint64(63)) // qd)
        per_f += [off & np.uint64(0xFFFFFFFF), off >> np.uint64(32)]
        recip = (1.0 / qs.astype(np.float64)).astype(np.float32)
        words = [cc.reshape(-1), np.concatenate(per_f, axis=1).reshape(-1),
                 qs.reshape(-1), recip.view(np.uint32).reshape(-1)]
        return np.concatenate([w.astype(np.int64) & 0xFFFFFFFF
                               for w in words]).astype(np.uint32)

    # ------------------------------------------------------------------

    def apply_plain(self, y: torch.Tensor) -> torch.Tensor:
        """Plain twin of the ``centered_fbc`` kernel (int64 arithmetic)."""
        q_src = self.q_src.to(torch.int64)
        v = y.to(torch.int64)
        v = torch.where(v > self.q_half.to(torch.int64), v - q_src, v)
        q = self.q_dst.to(torch.int64)                           # [F, 1]
        terms = v.unsqueeze(-2) * self.c.to(torch.int64).unsqueeze(-1) % q
        acc = terms.sum(dim=-3) % q                              # [..., F, N]
        if self.has_alpha:
            alpha = alpha_f32(v.to(torch.int32), self.recip)     # [..., 1, N]
            acc = (acc - alpha * self.p_mod.to(torch.int64)) % q
        if self.has_extra:
            acc = acc * self.extra.to(torch.int64) % q
        return acc.to(torch.int32)

    def apply(self, y: torch.Tensor) -> torch.Tensor:
        """y: int32 [..., S, N] standard-form residues → [..., F, N]; the
        ``centered_fbc`` kernel on a CUDA tensor."""
        cuda_lib.check_i32("centered_fbc", y)
        if y.dim() < 2 or y.shape[-2] != self.S:
            raise ValueError(f"centered_fbc: shape {tuple(y.shape)} is not "
                             f"[..., {self.S}, N]")
        if not cuda_lib.on_card(y, self.q_dst):
            return self.apply_plain(y)
        N = y.shape[-1]
        rows = y.numel() // (self.S * N) if N else 0
        out = torch.empty((*y.shape[:-2], self.F, N), dtype=torch.int32,
                          device=y.device)
        if rows == 0:
            return out
        if N % 4:
            raise ValueError(f"centered_fbc: N={N} is no multiple of 4 (a "
                             "thread moves 4 columns)")
        cuda_lib.check_aligned("centered_fbc", y, out)
        cuda_lib.launch(
            "centered_fbc", "hetpu_centered_fbc", y.device, y.data_ptr(),
            out.data_ptr(), rows, self.S, self.F, N,
            self.kernel_consts.data_ptr(), int(self.has_alpha),
            int(self.has_extra),
            nbytes=cuda_lib.plane_bytes(N, rows * self.S, rows * self.F))
        return out


# ----------------------------------------------------------------------
# plans of the two call sites (Context.centered_fbc_plan caches the
# conversion plans)
# ----------------------------------------------------------------------

def lift_plan(ks_plan, di: int) -> CenteredFbcPlan:
    """Key-switch digit lift (``Evaluator._decompose``): digit ``di``'s
    source primes → its foreign key-basis primes, C = dhat, no α (the
    centered-lift excess is standard hybrid mod-up noise)."""
    lo, hi = ks_plan.digit_bounds[di]
    foreign = ks_plan.foreign_idx[di]
    q = to_u32(ks_plan.q)[:, 0]
    C = to_u32(ks_plan.dhat)[lo:hi][:, foreign]
    return CenteredFbcPlan(q[lo:hi], q[foreign], C, device=ks_plan.q.device)


def fbc_plan(plan: FbcPlan, extra=None) -> CenteredFbcPlan:
    """Centered form of ``rns.fbc_apply(..., correct=True, premul=False)``
    for an :class:`~.rns.FbcPlan`, with an optional folded per-destination
    constant."""
    return CenteredFbcPlan(
        to_u32(plan.p)[:, 0], to_u32(plan.r)[:, 0], to_u32(plan.phat_mod_r),
        alpha_coeff=to_u32(plan.ptot_mod_r)[:, 0], extra=extra,
        device=plan.r.device)
