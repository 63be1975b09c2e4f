"""The homomorphic evaluator: ct·ct multiply and the fused
relinearize + rescale.

Counterpart of the main-path subset of ``hetpu/core/evaluator.py``:
``multiply`` (:117), ``square``, ``_decompose`` (:167), the key-switch
MAC ``_inner_product_raw`` (:242), ``_relin_rescale_fused`` (:410),
``_fbc_fwd_mont`` (:468), ``multiply_relin_rescale`` and
``square_relin_rescale`` — the reference's hot combination
(``he_linalg.cpp:556-584``).  Every function is bit-exact with its
reference twin.

On a CUDA tensor the four transforms of the path run in hand-written
kernels (``ntt``, ``ntt_fwd_lifted``, ``ntt_fwd_fbc``, ``inner_product``);
the elementwise steps between them (Karatsuba multiply, direct-row Shoup,
concatenations, tail arithmetic) stay plain PyTorch.
"""

from __future__ import annotations

import torch

from . import fused_ntt, ip_kernel
from .ciphertext import Ciphertext
from .context import Context, ModDownRescalePlan
from .keys import KSwitchKey, RelinKeys
from .modular import mod_add, mod_sub, mont_mul, shoup_mul
from .ntt import ntt_inv


class Evaluator:
    def __init__(self, ctx: Context):
        self.ctx = ctx

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """ct·ct tensor product: k-part × m-part → (k+m−1)-part; the 2×2
        case uses Karatsuba (3 modular multiplies)."""
        if a.level != b.level:
            raise ValueError(f"multiply: level {a.level} vs {b.level}")
        mc = self.ctx.mont(a.level)
        q, rinv = mc["q"], mc["r_inv"]
        if a.num_parts == 2 and b.num_parts == 2:
            c0, c1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
            d0, d1 = b.data[..., 0, :, :], b.data[..., 1, :, :]
            t0 = mont_mul(c0, d0, q, rinv)
            t2 = mont_mul(c1, d1, q, rinv)
            t1 = mod_sub(
                mod_sub(mont_mul(mod_add(c0, c1, q), mod_add(d0, d1, q), q,
                                 rinv), t0, q),
                t2, q)
            return Ciphertext(data=torch.stack([t0, t1, t2], dim=-3),
                              level=a.level, scale=a.scale * b.scale)
        ka, kb = a.num_parts, b.num_parts
        parts = []
        for k in range(ka + kb - 1):
            acc = None
            for i in range(max(0, k - kb + 1), min(ka, k + 1)):
                t = mont_mul(a.data[..., i, :, :], b.data[..., k - i, :, :],
                             q, rinv)
                acc = t if acc is None else mod_add(acc, t, q)
            parts.append(acc)
        return Ciphertext(data=torch.stack(parts, dim=-3),
                          level=a.level, scale=a.scale * b.scale)

    def square(self, a: Ciphertext) -> Ciphertext:
        if a.num_parts != 2:
            raise ValueError("square requires a 2-part input")
        mc = self.ctx.mont(a.level)
        q, rinv = mc["q"], mc["r_inv"]
        c0, c1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
        t0 = mont_mul(c0, c0, q, rinv)
        t2 = mont_mul(c1, c1, q, rinv)
        t01 = mont_mul(c0, c1, q, rinv)
        t1 = mod_add(t01, t01, q)
        return Ciphertext(data=torch.stack([t0, t1, t2], dim=-3),
                          level=a.level, scale=a.scale * a.scale)

    # ------------------------------------------------------------------
    # key switching
    # ------------------------------------------------------------------

    def _decompose(self, d: torch.Tensor, level: int) -> torch.Tensor:
        """Digit-decompose poly ``d`` ([..., ℓ+1, N] Montgomery NTT) into
        the key basis: standard-form NTT digits [..., J, R, N].

        The INTT folds in the digit-local D̂⁻¹ and the Montgomery strip;
        the lift to each digit's FOREIGN primes runs in the forward-NTT
        kernel's prologue; on a digit's own primes the lifted value is the
        input residue itself (one Shoup multiply by R⁻¹, no NTT)."""
        plan = self.ctx.keyswitch_plan(level)
        tabs = self.ctx.tables(level)
        d = d.contiguous()
        y = ntt_inv(d, tabs, strip_mont=True, extra=plan.dig_inv)
        lifted_cat = fused_ntt.ntt_fwd_lifted(
            y, plan.lift_w, plan.lift_ws, plan.lift_dig,
            plan.foreign_cat_tables)
        exts = []
        off = 0
        for di, (lo, hi) in enumerate(plan.digit_bounds):
            nf = len(plan.foreign_idx[di])
            lifted = lifted_cat[..., off:off + nf, :]
            off += nf
            direct = shoup_mul(d[..., lo:hi, :], plan.rinv[lo:hi],
                               plan.rinv_shoup[lo:hi], tabs.q[lo:hi])
            exts.append(torch.cat(
                [lifted[..., :lo, :], direct, lifted[..., lo:, :]], dim=-2))
        return torch.stack(exts, dim=-3)

    def _inner_product_raw(self, ext: torch.Tensor, level: int,
                           ksk: KSwitchKey) -> torch.Tensor:
        """Σ_j digit_j ⊙ ksk_j over the key basis (no mod-down).
        ext: [..., J, R, N] standard NTT → [..., 2, R, N] Montgomery NTT."""
        plan = self.ctx.keyswitch_plan(level)
        J = plan.num_digits
        nd = self.ctx.num_data
        if level + 1 == nd:
            sel = lambda a: a[:J]
        else:
            sel = lambda a: torch.cat(
                [a[:J, :, : level + 1], a[:J, :, nd:]], dim=2)
        return ip_kernel.inner_product(ext, sel(ksk.data), sel(ksk.shoup),
                                       plan.q)

    # ------------------------------------------------------------------
    # fused conveniences (reference hot combos)
    # ------------------------------------------------------------------

    def _relin_rescale_fused(self, ct3: Ciphertext, rk: RelinKeys) -> Ciphertext:
        """Relinearize + rescale with ONE fused divide-and-round by
        P·(dropped primes):
            out_i = round((c_i·P + Σ digit_j(c_2)·ksk_j) / (P·∏dropped))."""
        if ct3.num_parts != 3:
            raise ValueError("relin+rescale expects a 3-part ciphertext")
        level = ct3.level
        L = level + 1
        g = self.ctx.params.rescale_group
        plan: ModDownRescalePlan = self.ctx.moddown_rescale_plan(level)
        acc = self._inner_product_raw(
            self._decompose(ct3.data[..., 2, :, :], level), level, rk.key)
        c01 = ct3.data[..., :2, :, :]
        q = self.ctx.tables(level).q
        w_data = mod_add(acc[..., :L, :],
                         shoup_mul(c01, plan.p_mod, plan.p_mod_shoup, q), q)
        src = torch.cat([w_data[..., L - g: L, :], acc[..., L:, :]], dim=-2)
        u = ntt_inv(src, plan.src_tables, strip_mont=True,
                    extra=plan.fbc.inv_punit)
        r_m = _fbc_fwd_mont(u, plan.fbc, plan.dst_tables)
        q_dst = plan.dst_tables.q
        out = shoup_mul(mod_sub(w_data[..., : L - g, :], r_m, q_dst),
                        plan.pq_inv, plan.pq_inv_shoup, q_dst)
        prod = 1.0
        for qd in self.ctx.params.moduli[level - g + 1: level + 1]:
            prod *= qd
        return Ciphertext(data=out, level=level - g, scale=ct3.scale / prod)

    def multiply_relin_rescale(self, a: Ciphertext, b: Ciphertext,
                               rk: RelinKeys) -> Ciphertext:
        return self._relin_rescale_fused(self.multiply(a, b), rk)

    def square_relin_rescale(self, a: Ciphertext, rk: RelinKeys) -> Ciphertext:
        return self._relin_rescale_fused(self.square(a), rk)


def _fbc_fwd_mont(u, fbc, dst_tables):
    """Centered FBC + Montgomery forward NTT in one kernel (the converted
    planes never go to device memory)."""
    return fused_ntt.ntt_fwd_fbc(u, fbc, dst_tables, to_mont=True)
