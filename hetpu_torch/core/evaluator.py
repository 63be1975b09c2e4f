"""The homomorphic evaluator: every op of the reference's evaluator.

Counterpart of ``hetpu/core/evaluator.py``: negate, add, sub, the
plaintext ops, multiply, square, relinearize (k parts), rotate (with the
greedy power-of-two chain), conjugate, ``rotate_hoisted`` (one
decomposition, many rotations), rescale (``_div_round_last``, or with
``rescale_group=2`` the paired-prime divide ``_mod_down``), mod_switch
and the fused ``multiply_relin_rescale`` / ``square_relin_rescale`` —
the reference's hot combination (``he_linalg.cpp:556-584``), which drops
the pair in the same divide at ``rescale_group=2``.  Every op is
bit-exact with its reference twin.

On a CUDA tensor the transforms run in hand-written kernels (``ntt``,
``ntt_fwd_lifted``, ``ntt_fwd_fbc``, ``inner_product``, and with
``centered_fbc=True`` ``ntt_fwd_centered`` in place of the two fused
ones), and so do the ct·ct product (``tensor_product``; added into a
running sum, ``tensor_product_acc``), the mod-down
and rescale tails and the digits' own-prime limbs (``ks_tail``), and the
plaintext products with their sum (``plain_mul_sum``).  The key
switch's digits are built in place: the kernels read the switched part
where it lies in its ciphertext and store each digit limb once at its
place, so no copy or concatenation runs in the decomposition.  The other
elementwise steps (Galois gathers, ``add_plain``'s Shoup lift, the ops'
concatenations and stacks, mod add/sub) stay plain PyTorch.

While a torch profiler records, each stage opens its span
(:func:`..utils.profiling.span`): ``hetpu/mul.tensor`` (the tensor
product), ``hetpu/ks.decompose`` (the digit decomposition),
``hetpu/ks.inner`` (the key's selection and the inner product),
``hetpu/ks.tail`` (the fused relin + rescale divide), ``hetpu/ks.mod_down``
(the mod-down by P, and the paired rescale), ``hetpu/rescale`` (the
one-prime divide) and ``hetpu/rot.step`` (one step of a hoisted rotation,
around its gathers, ``hetpu/rot.galois`` in :func:`.galois.apply`, and its
key switch).  In ``multiply_relin_rescale`` every kernel falls under
exactly one of the first four.

``centered_fbc=True`` is the port's spelling of the reference's
``HETPU_MXU_FBC=1``: the key-switch digit lift and every α-corrected base
conversion take centered source values (:mod:`.centered_fbc`), fused with
the forward NTT that follows them.  Its lift differs from the default
lift by a multiple of the digit product (standard mod-up noise), so its
outputs equal the reference's centered path, not the default one.
"""

from __future__ import annotations

import torch

from . import cuda_lib, fused_ntt, galois, ip_kernel, ks_tail
from .centered_fbc import CenteredFbcPlan
from .ciphertext import (Ciphertext, Plaintext, check_add_compat,
                         scales_close)
from .context import Context, KeySwitchPlan, RescalePlan
from .keys import GaloisKeys, KSwitchKey, RelinKeys
from .modular import mod_add, mod_neg, mod_sub, shoup_mul
from .ntt import ntt_fwd_mont, ntt_inv
from .plain_mul import plain_mul_sum
from .tensor_product import tensor_product, tensor_product_acc
from ..utils.profiling import span


class Evaluator:
    def __init__(self, ctx: Context, centered_fbc: bool = False):
        self.ctx = ctx
        self.centered_fbc = centered_fbc

    def _centered(self, fbc) -> CenteredFbcPlan | None:
        return self.ctx.centered_fbc_plan(fbc) if self.centered_fbc else None

    # ------------------------------------------------------------------
    # linear ops
    # ------------------------------------------------------------------

    def negate(self, ct: Ciphertext) -> Ciphertext:
        return ct.with_(data=mod_neg(ct.data, self.ctx.mont(ct.level)["q"]))

    def _pad_parts(self, a: Ciphertext, b: Ciphertext):
        if a.num_parts == b.num_parts:
            return a.data, b.data
        big, small = (a, b) if a.num_parts > b.num_parts else (b, a)
        pad = torch.zeros((*small.batch_shape, big.num_parts - small.num_parts,
                           *small.data.shape[-2:]), dtype=torch.int32,
                          device=small.data.device)
        sd = torch.cat([small.data, pad], dim=-3)
        return (big.data, sd) if a.num_parts > b.num_parts else (sd, big.data)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_add_compat(a, b, "add")
        da, db = self._pad_parts(a, b)
        q = self.ctx.mont(a.level)["q"]
        return Ciphertext(data=mod_add(da, db, q), level=a.level, scale=a.scale)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        check_add_compat(a, b, "sub")
        da, db = self._pad_parts(a, b)
        q = self.ctx.mont(a.level)["q"]
        return Ciphertext(data=mod_sub(da, db, q), level=a.level, scale=a.scale)

    def _plain_part0(self, ct: Ciphertext, pt: Plaintext, op) -> Ciphertext:
        """Part 0 of ``ct`` combined with ``pt`` (lifted to Montgomery form)
        by ``op``; the other parts unchanged."""
        tabs = self.ctx.tables(ct.level)
        ptm = shoup_mul(pt.data, tabs.r, tabs.r_shoup, tabs.q)
        c0 = op(ct.data[..., 0, :, :], ptm, tabs.q)
        return ct.with_(data=torch.cat(
            [c0.unsqueeze(-3), ct.data[..., 1:, :, :]], dim=-3))

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        check_add_compat(ct, pt, "add_plain")
        return self._plain_part0(ct, pt, mod_add)

    def sub_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        check_add_compat(ct, pt, "sub_plain")
        return self._plain_part0(ct, pt, mod_sub)

    # ------------------------------------------------------------------
    # multiplication
    # ------------------------------------------------------------------

    def multiply_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        return self.multiply_plain_sum([(ct, pt)])

    def multiply_plain_sum(self, pairs) -> Ciphertext:
        """Σₖ ctₖ·ptₖ over one to three (ciphertext, plaintext) pairs whose
        ciphertexts share one level and shape and whose products' scales
        agree (the sum takes the first product's scale): one launch of the
        ``plain_mul_sum`` kernel on the card (:mod:`.plain_mul`), with a
        plaintext of one row read by every row uncopied and one of the
        ciphertext's leading axes (the coefficient FFT's stacked twiddles)
        one a row, another broadcast expanded to that form; the plain Shoup
        products and ``mod_add`` on the CPU.  The shapes are checked in
        :mod:`.plain_mul`."""
        pairs = list(pairs)
        if not pairs:
            raise ValueError("multiply_plain_sum: no terms")
        ct0, pt0 = pairs[0]
        scale = ct0.scale * pt0.scale
        for ct, pt in pairs:
            if ct.level != pt.level:
                raise ValueError(f"multiply_plain: level {ct.level} vs "
                                 f"{pt.level}")
            if ct.level != ct0.level:
                raise ValueError(f"multiply_plain_sum: a source at level "
                                 f"{ct.level} vs {ct0.level}")
            if not scales_close(ct.scale * pt.scale, scale):
                raise ValueError(f"multiply_plain_sum: product scale "
                                 f"{ct.scale * pt.scale} vs {scale}")
        q = self.ctx.tables(ct0.level).q
        d = plain_mul_sum([(ct.data.contiguous(), pt.data, pt.shoup)
                           for ct, pt in pairs], q)
        return Ciphertext(data=d, level=ct0.level, scale=scale)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """ct·ct tensor product: k-part × m-part → (k+m−1)-part; the 2×2
        case uses Karatsuba (3 modular multiplies)."""
        if a.level != b.level:
            raise ValueError(f"multiply: level {a.level} vs {b.level}")
        mc = self.ctx.mont(a.level)
        with span("mul.tensor"):
            d = tensor_product(a.data, b.data, mc["q"], mc["r_inv"],
                               mc["qinv_neg"])
        return Ciphertext(data=d, level=a.level, scale=a.scale * b.scale)

    def multiply_acc(self, acc: Ciphertext | None, a: Ciphertext,
                     b: Ciphertext) -> Ciphertext:
        """acc + a·b, the tensor product added into the running sum ``acc``
        in place (``acc`` None: a new sum holding a·b): one
        ``tensor_product_acc`` launch on the card for 2-part operands, with
        a one-row ``b`` read by every row of ``a`` uncopied."""
        if a.level != b.level:
            raise ValueError(f"multiply_acc: level {a.level} vs {b.level}")
        scale = a.scale * b.scale
        if acc is not None and (acc.level != a.level
                                or not scales_close(acc.scale, scale)):
            raise ValueError(f"multiply_acc: sum at level {acc.level}, "
                             f"scale {acc.scale} vs a product at level "
                             f"{a.level}, scale {scale}")
        mc = self.ctx.mont(a.level)
        with span("mul.tensor"):
            d = tensor_product_acc(None if acc is None else acc.data, a.data,
                                   b.data, mc["q"], mc["r_inv"],
                                   mc["qinv_neg"])
        return Ciphertext(data=d, level=a.level,
                          scale=scale if acc is None else acc.scale)

    def square(self, a: Ciphertext) -> Ciphertext:
        if a.num_parts != 2:
            raise ValueError("square requires a 2-part input")
        mc = self.ctx.mont(a.level)
        with span("mul.tensor"):
            d = tensor_product(a.data, None, mc["q"], mc["r_inv"],
                               mc["qinv_neg"])
        return Ciphertext(data=d, level=a.level, scale=a.scale * a.scale)

    # ------------------------------------------------------------------
    # key switching: relinearize / rotate / conjugate
    # ------------------------------------------------------------------

    def _decompose(self, d: torch.Tensor, level: int) -> torch.Tensor:
        """Digit-decompose poly ``d`` ([..., ℓ+1, N] Montgomery NTT) into
        the key basis: standard-form NTT digits ext [..., J, R, N], built
        in place, each of its J·R limbs a row written once.

        ``d`` is read where it lies (a part ``ct[..., p, :, :]`` of a
        ciphertext: :func:`.cuda_lib.row_stride`; another layout is copied
        first).  The INTT folds in the digit-local D̂⁻¹ and the Montgomery
        strip.  The lift of every digit to its FOREIGN primes runs in the
        forward-NTT kernel's prologue, one launch that stores each lifted
        limb at its place (``plan.ext_row``): ``ntt_fwd_lifted``, or with
        ``centered_fbc`` the centered lift (``ntt_fwd_centered``).  On a
        digit's own primes the lifted value is the input residue itself:
        one Shoup multiply by R⁻¹, no NTT (``ks_tail.own_limbs``, at
        ``plan.own_row``)."""
        with span("ks.decompose"):
            plan: KeySwitchPlan = self.ctx.keyswitch_plan(level)
            tabs = self.ctx.tables(level)
            if cuda_lib.row_stride(d) is None:
                d = d.contiguous()
            J, R = plan.num_digits, len(plan.basis_tables.primes)
            ext = torch.empty((*d.shape[:-2], J, R, d.shape[-1]),
                              dtype=torch.int32, device=d.device)
            rows = ext.view(*d.shape[:-2], J * R, d.shape[-1])
            y = ntt_inv(d, tabs, strip_mont=True, extra=plan.dig_inv)
            lift = (plan.lift_w, plan.lift_ws, plan.lift_dig)
            if self.centered_fbc:
                fused_ntt.ntt_fwd_centered_lift(
                    y, *lift, plan.q[: level + 1], plan.foreign_cat_tables,
                    out=rows, out_rows=plan.ext_row)
            else:
                fused_ntt.ntt_fwd_lifted(y, *lift, plan.foreign_cat_tables,
                                         out=rows, out_rows=plan.ext_row)
            ks_tail.own_limbs(d, rows, plan.own_row, plan.rinv,
                              plan.rinv_shoup, tabs.q)
            return ext

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
        with span("ks.inner"):
            return ip_kernel.inner_product(ext, sel(ksk.data),
                                           sel(ksk.shoup), plan.q)

    def _inner_product(self, ext: torch.Tensor, level: int, ksk: KSwitchKey):
        """Σ_j digit_j ⊙ ksk_j, then mod-down by P = ∏ specials.
        ext: [..., J, R, N] standard NTT → (p0, p1) Montgomery NTT."""
        acc = self._inner_product_raw(ext, level, ksk)
        md = self.ctx.keyswitch_plan(level).moddown
        out = _mod_down(acc, md, self.ctx.num_special, self._centered(md.fbc))
        return out[..., 0, :, :], out[..., 1, :, :]

    def _keyswitch(self, d: torch.Tensor, level: int, ksk: KSwitchKey):
        """Switch poly ``d`` ([..., ℓ+1, N] Montgomery NTT, multiplying some
        s') to the base secret.  Returns (p0, p1) Montgomery NTT."""
        return self._inner_product(self._decompose(d, level), level, ksk)

    def rotate_hoisted_iter(self, ct: Ciphertext, steps_list,
                            gk: GaloisKeys):
        """Rotate one ciphertext by MANY steps, decomposing c1 only once:
        σ commutes with the digit decomposition, so each step costs one
        gather of the decomposed digits and one key inner product.

        A generator: it yields each step's rotation as it is made, so a
        caller that consumes each one before asking for the next holds one
        step's rotation at a time (beside the one decomposition).  Each
        step runs under the span ``hetpu/rot.step``, closed before its
        rotation is yielded; a step of 0 (mod the slots) yields ``ct``."""
        if ct.num_parts != 2:
            raise ValueError("rotate_hoisted expects a 2-part ciphertext")
        n = self.ctx.params.poly_degree
        ext = self._decompose(ct.data[..., 1, :, :], ct.level)
        for steps in steps_list:
            if steps % (n // 2) == 0:
                yield ct
            else:
                yield self._hoisted_step(ct, ext,
                                         galois.rotation_elt(n, steps), gk)

    def _hoisted_step(self, ct: Ciphertext, ext: torch.Tensor, elt: int,
                      gk: GaloisKeys) -> Ciphertext:
        """One step of a hoisted rotation: the gathers of c0 and of the
        digits ``ext``, the key's inner product and mod-down, and
        (c0 + p0, p1).  A call of its own, so that the step's temporaries
        are freed before the generator yields its rotation."""
        n = self.ctx.params.poly_degree
        q = self.ctx.mont(ct.level)["q"]
        with span("rot.step"):
            c0 = galois.apply(ct.data[..., 0, :, :], n, elt)
            p0, p1 = self._inner_product(galois.apply(ext, n, elt),
                                         ct.level, gk.key_for(elt))
            d = torch.stack([mod_add(c0, p0, q), p1], dim=-3)
        return Ciphertext(data=d, level=ct.level, scale=ct.scale)

    def rotate_hoisted(self, ct: Ciphertext, steps_list,
                       gk: GaloisKeys) -> list:
        """:meth:`rotate_hoisted_iter` as a list: every step's rotation
        held at once."""
        return list(self.rotate_hoisted_iter(ct, steps_list, gk))

    def relinearize(self, ct: Ciphertext, rk: RelinKeys) -> Ciphertext:
        """Reduce a k-part ciphertext to 2 parts: each part p ≥ 2
        (multiplying s^p) is key-switched with the s^p → s key (needs
        ``create_relin_keys(count=k-2)`` for k > 3)."""
        if ct.num_parts < 3:
            raise ValueError("relinearize expects a ≥3-part ciphertext")
        q = self.ctx.mont(ct.level)["q"]
        c0, c1 = ct.data[..., 0, :, :], ct.data[..., 1, :, :]
        for p in range(2, ct.num_parts):
            p0, p1 = self._keyswitch(ct.data[..., p, :, :], ct.level,
                                     rk.key_for_power(p))
            c0, c1 = mod_add(c0, p0, q), mod_add(c1, p1, q)
        return Ciphertext(data=torch.stack([c0, c1], dim=-3),
                          level=ct.level, scale=ct.scale)

    def apply_galois(self, ct: Ciphertext, elt: int,
                     gk: GaloisKeys) -> Ciphertext:
        if ct.num_parts != 2:
            raise ValueError("apply_galois expects a 2-part ciphertext")
        n = self.ctx.params.poly_degree
        c0 = galois.apply(ct.data[..., 0, :, :], n, elt)
        c1 = galois.apply(ct.data[..., 1, :, :], n, elt)
        p0, p1 = self._keyswitch(c1, ct.level, gk.key_for(elt))
        q = self.ctx.mont(ct.level)["q"]
        d = torch.stack([mod_add(c0, p0, q), p1], dim=-3)
        return Ciphertext(data=d, level=ct.level, scale=ct.scale)

    def rotate(self, ct: Ciphertext, steps: int,
               gk: GaloisKeys) -> Ciphertext:
        """Rotate slots left by ``steps`` (negative → right), chaining
        available power-of-two keys when the exact key is missing."""
        n = self.ctx.params.poly_degree
        slots = n // 2
        steps = steps % slots
        if steps == 0:
            return ct
        e = galois.rotation_elt(n, steps)
        if gk.has(e):
            return self.apply_galois(ct, e, gk)
        remaining = steps
        bit = 1 << (slots.bit_length() - 2) if slots > 1 else 1
        out = ct
        while remaining:
            while bit > remaining:
                bit >>= 1
            e = galois.rotation_elt(n, bit)
            if not gk.has(e):
                raise KeyError(f"no galois key chain to rotate by {steps}")
            out = self.apply_galois(out, e, gk)
            remaining -= bit
        return out

    def conjugate(self, ct: Ciphertext, gk: GaloisKeys) -> Ciphertext:
        return self.apply_galois(ct, galois.conjugation_elt(
            self.ctx.params.poly_degree), gk)

    # ------------------------------------------------------------------
    # modulus chain management
    # ------------------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide-and-round by the last active prime — or prime PAIR in the
        rescale_group=2 high-precision mode: level-g, scale/∏dropped.  The
        pair takes the key-switch mod-down's divide (K1 INTT of the pair,
        then K3, or K6 with ``centered_fbc``)."""
        g = self.ctx.params.rescale_group
        if g == 1:
            d = _div_round_last(ct.data, self.ctx.rescale_plan(ct.level))
            q_last = self.ctx.params.moduli[ct.level]
            return Ciphertext(data=d, level=ct.level - 1,
                              scale=ct.scale / q_last)
        md = self.ctx.group_rescale_plan(ct.level)
        d = _mod_down(ct.data, md, g, self._centered(md.fbc))
        prod = 1.0
        for q in self.ctx.params.moduli[ct.level - g + 1: ct.level + 1]:
            prod *= q
        return Ciphertext(data=d, level=ct.level - g, scale=ct.scale / prod)

    def mod_switch(self, ct: Ciphertext) -> Ciphertext:
        """Drop the last prime without scaling."""
        if ct.level < 1:
            raise ValueError("cannot mod_switch below level 0")
        return Ciphertext(data=ct.data[..., : ct.level, :].contiguous(),
                          level=ct.level - 1, scale=ct.scale)

    def mod_switch_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        out = ct
        while out.level > level:
            out = self.mod_switch(out)
        return out

    # ------------------------------------------------------------------
    # fused conveniences (reference hot combos)
    # ------------------------------------------------------------------

    def _relin_rescale_fused(self, ct3: Ciphertext,
                             rk: RelinKeys) -> Ciphertext:
        """Relinearize + rescale with ONE fused divide-and-round by
        P·(dropped primes):
            out_i = round((c_i·P + Σ digit_j(c_2)·ksk_j) / (P·∏dropped))."""
        if ct3.num_parts != 3:
            raise ValueError("relin+rescale expects a 3-part ciphertext")
        level = ct3.level
        g = self.ctx.params.rescale_group
        plan = self.ctx.moddown_rescale_plan(level)
        acc = self._inner_product_raw(
            self._decompose(ct3.data[..., 2, :, :], level), level, rk.key)
        q = self.ctx.tables(level).q
        # w = acc + c01·P over the L data limbs: its last g are the
        # divide's sources, its first L−g the divide's operand
        with span("ks.tail"):
            src = ks_tail.tail_src(acc, ct3.data, g, plan.p_mod,
                                   plan.p_mod_shoup, q)
            u = ntt_inv(src, plan.src_tables, strip_mont=True,
                        extra=plan.fbc.inv_punit)
            r_m = _fbc_fwd_mont(u, plan.fbc, plan.dst_tables,
                                self._centered(plan.fbc))
            out = ks_tail.tail_out(acc, ct3.data, r_m, plan.p_mod,
                                   plan.p_mod_shoup, plan.pq_inv,
                                   plan.pq_inv_shoup, q)
        prod = 1.0
        for qd in self.ctx.params.moduli[level - g + 1: level + 1]:
            prod *= qd
        return Ciphertext(data=out, level=level - g, scale=ct3.scale / prod)

    def multiply_relin_rescale(self, a: Ciphertext, b: Ciphertext,
                               rk: RelinKeys) -> Ciphertext:
        return self._relin_rescale_fused(self.multiply(a, b), rk)

    def square_relin_rescale(self, a: Ciphertext,
                             rk: RelinKeys) -> Ciphertext:
        return self._relin_rescale_fused(self.square(a), rk)

    def multiply_plain_rescale(self, ct: Ciphertext,
                               pt: Plaintext) -> Ciphertext:
        return self.rescale(self.multiply_plain(ct, pt))


def _mod_down(acc: torch.Tensor, md, k: int,
              centered: CenteredFbcPlan | None = None) -> torch.Tensor:
    """Divide a key-basis accumulator [..., parts, n_data+k, N] (Montgomery
    NTT) by P = ∏ of the k special primes, landing on the data basis:
    centered FBC of the special limbs + subtract + ×P⁻¹."""
    with span("ks.mod_down"):
        sp = acc[..., -k:, :].contiguous()
        u = ntt_inv(sp, md.src_tables, strip_mont=True,
                    extra=md.fbc.inv_punit)
        r_m = _fbc_fwd_mont(u, md.fbc, md.dst_tables, centered)
        return ks_tail.sub_mul(acc, r_m, md.p_inv, md.p_inv_shoup,
                               md.dst_tables.q)


def _fbc_fwd_mont(u, fbc, dst_tables, centered: CenteredFbcPlan | None = None):
    """Centered FBC + Montgomery forward NTT in one kernel (the converted
    planes never go to device memory): ``ntt_fwd_fbc``, or, given the
    centered plan of ``fbc``, ``ntt_fwd_centered``."""
    if centered is not None:
        return fused_ntt.ntt_fwd_centered_fbc(u, centered, dst_tables,
                                              to_mont=True)
    return fused_ntt.ntt_fwd_fbc(u, fbc, dst_tables, to_mont=True)


def _div_round_last(data: torch.Tensor, plan: RescalePlan) -> torch.Tensor:
    """Divide a Montgomery-NTT poly array [..., m, N] by its last prime,
    rounding: result over the remaining m-1 primes."""
    with span("rescale"):
        last = data[..., -1:, :].contiguous()
        last_c = ntt_inv(last, plan.src_tables, strip_mont=True)
        v = ks_tail.lift_last(last_c, plan.half, plan.src_tables.q,
                              plan.dst_tables.q, plan.mu, plan.half_mod)
        vm = ntt_fwd_mont(v, plan.dst_tables)
        return ks_tail.sub_mul(data, vm, plan.src_inv, plan.src_inv_shoup,
                               plan.dst_tables.q)
