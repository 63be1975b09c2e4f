"""BFV scheme: exact integer arithmetic on encrypted data.

Counterpart of ``hetpu/core/bfv.py`` (``BfvScheme``, ``_garner_u64``), bit
for bit: the SEAL BFV path of the reference's demos (elemwise_square,
matmul, batch_matmul_bfv, matpow) and its ``invariant_noise_budget``.

* BFV ciphertexts are NTT + Montgomery resident like CKKS ones, so add,
  sub, relinearize and the rotations are the CKKS evaluator's
  (rotate_rows = galois element 5^k, rotate_columns = conjugation).
* The plaintext modulus may be a CRT product t = t₁·t₂ of ~30-bit
  NTT-friendly primes: batching encodes and decodes per factor and
  combines on the host (u64 Garner).  Without batching any t works
  (coefficient encoding).
* Multiply is the HPS RNS variant at any level: lift to an auxiliary
  basis B of 30-bit primes with B > 2·t·N·Q_ℓ, tensor in both bases,
  scale by t/Q_ℓ with two exact fast base conversions (the two-float α of
  ``rns.fbc_apply(precise=True)``), land back in Q_ℓ.
* mod_switch divides and rounds by the last prime (CKKS rescale's
  ``_div_round_last``).

On the card the transforms run in the ``ntt`` kernel (K1) over the data,
auxiliary and t-factor bases, the tensor products over both in
``tensor_product`` (K7), mod_switch's divide, relinearize's mod-down tail
and the HPS scaling's (u − r)·Q⁻¹ in ``ks_tail`` (K8), the precise-α
conversions (the multiply's four, decrypt's Q → G) in ``fbc_precise``
(K9, through ``rns.fbc_apply``), and relinearize adds K2–K4 (or K6 with
``centered_fbc``); the scaling's t·x rides in K1's inverse epilogue (the
reference runs all of these outside any Pallas kernel).  Plain Montgomery
products take R⁻¹ (``mont_mul(a, b, q, r_inv)``), the kernel −q⁻¹;
residues travel to the host through ``modular.to_u32``.

While a torch profiler records, the multiply opens its stage spans
(:func:`..utils.profiling.span`): ``hetpu/bfv.lift``,
``hetpu/bfv.convert``, ``hetpu/mul.tensor`` and ``hetpu/bfv.scale``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import galois, nt
from .ciphertext import Ciphertext, Plaintext
from .context import Context
from .encrypt import Encryptor
from .evaluator import Evaluator, _div_round_last
from .ks_tail import sub_mul
from .modular import (from_u32, mod_add, mod_sub, mont_constants, mont_mul,
                      shoup_companion, shoup_mul, shoup_precompute, to_u32)
from .ntt import build_tables, ntt_fwd, ntt_fwd_mont, ntt_inv
from .params import Scheme
from .rns import fbc_apply, make_fbc
from .tensor_product import tensor_product
from ..utils.profiling import phase, span


def _col(xs, dt=np.uint32):
    return np.array(xs, dtype=dt).reshape(-1, 1)


def _garner_u64(residues, moduli) -> np.ndarray:
    """Mixed-radix (Garner) CRT combine of per-modulus residue arrays into
    uint64 values in [0, ∏moduli).  Exact for ∏moduli < 2^63 and 31-bit
    moduli (every intermediate product < 2^62)."""
    x = np.asarray(residues[0], dtype=np.uint64)
    prod = int(moduli[0])
    x = x % np.uint64(prod)
    for i in range(1, len(moduli)):
        m = int(moduli[i])
        inv = nt.modinv(prod % m, m)
        r_i = np.asarray(residues[i], dtype=np.uint64) % np.uint64(m)
        diff = (r_i + np.uint64(m) - x % np.uint64(m)) % np.uint64(m)
        d = (diff * np.uint64(inv)) % np.uint64(m)         # digit < m
        x = x + d * np.uint64(prod)
        prod *= m
    assert prod < (1 << 63), "Garner combine exceeds u64 range"
    return x


class BfvScheme:
    """Per-context BFV machinery layered on the shared Context/Evaluator;
    tables and plans live on the context's device."""

    @phase("context")
    def __init__(self, ctx: Context):
        p = ctx.params
        if p.scheme != Scheme.BFV:
            raise ValueError("BfvScheme requires BFV params")
        self.ctx = ctx
        self.t = p.plain_modulus
        n = p.poly_degree
        self.n = n
        self.batching = p.plain_batching
        self.t_factors = tuple(p.plain_factors) or (self.t,)
        if self.batching:
            self.tables_t = {f: build_tables(n, (f,), ctx.device)
                             for f in self.t_factors}
        # slot layout: slot (row r, col c) ↔ exponent ±5^c (SEAL batching:
        # element 5^k rotates the rows, conjugation swaps them)
        half = n // 2
        _, exp_to_idx = galois._exp_vectors(n)
        slot_to_eval = np.empty(n, dtype=np.int64)
        e = 1
        for c in range(half):
            slot_to_eval[c] = exp_to_idx[e]
            slot_to_eval[half + c] = exp_to_idx[2 * n - e]
            e = e * 5 % (2 * n)
        self.slot_to_eval = slot_to_eval
        self._levels: dict[int, dict] = {}

    # ------------------------------------------------------------------
    # per-level constants (Q_ℓ changes under mod-switch)
    # ------------------------------------------------------------------

    def _lvl(self, level: int) -> dict:
        d = self._levels.get(level)
        if d is None:
            with phase("context"):
                d = self._levels[level] = self._make_lvl(level)
        return d

    def _make_lvl(self, level: int) -> dict:
        ctx = self.ctx
        n = self.n
        dev = ctx.device
        Q_primes = list(ctx.params.moduli[: level + 1])
        Q = 1
        for q in Q_primes:
            Q *= q
        # auxiliary basis B: fresh 30-bit NTT primes with B > 2·t·N·Q
        # (covers the centered tensor product N·Q²/4 < Q·B/2 and the scaled
        # value |t·x/Q| ≤ t·N·Q/4 < B/2)
        used = set(ctx.all_primes) | set(self.t_factors)
        bound = 2 * self.t * n * Q
        B_primes: list[int] = []
        Bprod = 1
        for q in nt.gen_primes(30, 64, 2 * n):
            if q in used:
                continue
            B_primes.append(q)
            Bprod *= q
            if Bprod > bound:
                break
        assert Bprod > bound, "aux basis generation exhausted"
        delta = Q // self.t
        QB = Q_primes + B_primes
        mont_B = mont_constants(B_primes)
        delta_mod_q = _col([delta % q for q in Q_primes])
        t_mod_qb = _col([self.t % r for r in QB])
        qinv_mod_b = _col([nt.modinv(Q % b, b) for b in B_primes])
        t = lambda a: from_u32(a, dev)
        d = {
            "Q": Q,
            "B_primes": B_primes,
            "tables_B": build_tables(n, B_primes, dev),
            "q_B": t(mont_B["q"]),
            "r_inv_B": t(mont_B["r_inv"]),
            "qinv_neg_B": t(mont_B["qinv_neg"]),
            "delta_mod_q": t(delta_mod_q),
            "delta_shoup": t(shoup_precompute(delta_mod_q, _col(Q_primes))),
            "t_mod_qb": t(t_mod_qb),
            "t_shoup_qb": t(shoup_precompute(t_mod_qb, _col(QB))),
            "qinv_mod_b": t(qinv_mod_b),
            "qinv_shoup_b": t(shoup_precompute(qinv_mod_b, _col(B_primes))),
            "fbc_q_to_b": make_fbc(Q_primes, B_primes, dev),
            "fbc_b_to_q": make_fbc(B_primes, Q_primes, dev),
        }
        if self.t < (1 << 61):
            # vectorized decrypt-scale-and-round basis G (see
            # decrypt_coeffs_mod_t): G > 4t so m' = round(t·x̂/Q) plus a
            # possible ±t from an α-misround on x̂ still lifts exactly
            # (|m'| ≤ 3t/2 < G/2); ∏G < 2^63 keeps the Garner combine in
            # u64
            g_primes: list[int] = []
            Gprod = 1
            for p in nt.gen_primes(31, 64, 2 * n):
                if p in used or p in B_primes:
                    continue
                g_primes.append(p)
                Gprod *= p
                if Gprod > 4 * self.t:
                    break
            assert Gprod > 4 * self.t and Gprod < (1 << 63)
            u64 = lambda xs: np.array(xs, dtype=np.uint64).reshape(-1, 1)
            d["G_primes"] = g_primes
            d["G"] = Gprod
            d["fbc_q_to_g"] = make_fbc(Q_primes, g_primes, dev)
            d["g_col"] = u64(g_primes)
            d["t_mod_g"] = u64([self.t % p for p in g_primes])
            d["qinv_mod_g"] = u64([nt.modinv(Q % p, p) for p in g_primes])
            d["t_mod_qcol"] = u64([self.t % q for q in Q_primes])
            d["q_col64"] = u64(Q_primes)
        return d

    # ------------------------------------------------------------------
    # batching encoder (SEAL BatchEncoder parity, CRT factors)
    # ------------------------------------------------------------------

    def _t_ntt(self, values: np.ndarray, f: int, inverse: bool) -> np.ndarray:
        """Forward or inverse NTT of one [N] uint32 poly over the t factor
        ``f``, on the context's device."""
        x = from_u32(values[None, :], self.ctx.device)
        fn = ntt_inv if inverse else ntt_fwd
        return to_u32(fn(x, self.tables_t[f]))[0]

    def _coeffs_mod_t_from_values(self, values) -> np.ndarray:
        """Integer slot vector (mod t) → poly coefficients mod t.
        Per-factor INTT then a u64 Garner combine (t < 2^61 for all
        presets; the result array is uint64, exact)."""
        v = np.zeros(self.n, dtype=object)
        vals = np.asarray(values).astype(object).ravel()
        v[: vals.shape[0]] = [int(x) % self.t for x in vals]
        ev = np.zeros(self.n, dtype=object)
        ev[self.slot_to_eval] = v
        res = []
        for f in self.t_factors:
            ev_f = (ev % f).astype(np.uint64).astype(np.uint32)
            res.append(self._t_ntt(ev_f, f, inverse=True))
        if self.t < (1 << 61):
            return _garner_u64(res, self.t_factors)
        coeffs = np.zeros(self.n, dtype=object)          # huge t fallback
        for f, c_f in zip(self.t_factors, res):
            fhat = self.t // f
            coef = fhat * nt.modinv(fhat % f, f) % self.t
            coeffs = (coeffs + c_f.astype(object) * coef) % self.t
        return coeffs

    @phase("encode")
    def encode(self, values, level: int | None = None) -> Plaintext:
        """Integer vector (≤ N values, mod t) → plaintext whose poly is
        lifted to the Q basis in NTT form for plain ops."""
        ctx = self.ctx
        if level is None:
            level = ctx.num_data - 1
        if self.batching:
            coeffs = self._coeffs_mod_t_from_values(values)
        else:
            # coefficient encoding: values are poly coefficients directly
            dt = np.uint64 if self.t < (1 << 62) else object
            coeffs = np.zeros(self.n, dtype=dt)
            vals = np.asarray(values).astype(object).ravel()
            coeffs[: vals.shape[0]] = [int(x) % self.t for x in vals]
        # centered lift to the Q basis (small-norm representative); |c| ≤
        # t/2 fits int64 for t < 2^62 → ctx.to_rns takes its vectorized path
        if coeffs.dtype != object and self.t < (1 << 62):
            c = np.where(coeffs > self.t // 2,
                         coeffs.astype(np.int64) - np.int64(self.t),
                         coeffs.astype(np.int64))
        else:
            coeffs = coeffs.astype(object)
            c = np.where(coeffs > self.t // 2, coeffs - self.t, coeffs)
        tabs = ctx.tables(level)
        data = ntt_fwd(from_u32(ctx.to_rns(c, level), ctx.device), tabs)
        return Plaintext(data=data, shoup=shoup_companion(data, tabs.q),
                         level=level, scale=1.0)

    def decode(self, coeffs_mod_t: np.ndarray) -> np.ndarray:
        """Poly coeffs mod t (uint64 fast path / object) → integer slot
        values (uint64 for t < 2^61, else object)."""
        if not self.batching:
            return np.asarray(coeffs_mod_t)
        c = np.asarray(coeffs_mod_t)
        fast = c.dtype != object and self.t < (1 << 61)
        if not fast:
            c = c.astype(object)
        evs = []
        for f in self.t_factors:
            c_f = ((c % np.uint64(f)) if fast else (c % f)) \
                .astype(np.uint64).astype(np.uint32)
            evs.append(self._t_ntt(c_f, f, inverse=False))
        if fast:
            out = _garner_u64(evs, self.t_factors)
        else:
            out = np.zeros(self.n, dtype=object)
            for f, ev_f in zip(self.t_factors, evs):
                fhat = self.t // f
                coef = fhat * nt.modinv(fhat % f, f) % self.t
                out = (out + ev_f.astype(object) * coef) % self.t
        return out[self.slot_to_eval]

    # ------------------------------------------------------------------
    # encrypt / decrypt
    # ------------------------------------------------------------------

    def _msg_term(self, pt: Plaintext, level: int) -> torch.Tensor:
        """Δ·m over Q in NTT + Montgomery (pt.data is the centered lift of m
        in standard NTT form)."""
        tabs = self.ctx.tables(level)
        lvl = self._lvl(level)
        m_mont = shoup_mul(pt.data, tabs.r, tabs.r_shoup, tabs.q)
        return shoup_mul(m_mont, lvl["delta_mod_q"], lvl["delta_shoup"],
                         tabs.q)

    def _with_part0(self, ct: Ciphertext, pt: Plaintext, op) -> Ciphertext:
        """``ct`` with part 0 combined with Δ·m by ``op`` (mod_add /
        mod_sub); the other parts unchanged."""
        q = self.ctx.tables(ct.level).q
        c0 = op(ct.data[..., 0, :, :], self._msg_term(pt, ct.level), q)
        return ct.with_(data=torch.cat([c0.unsqueeze(-3),
                                        ct.data[..., 1:, :, :]], dim=-3))

    @phase("encrypt")
    def encrypt(self, encryptor: Encryptor, pt: Plaintext,
                seed: bytes | None = None) -> Ciphertext:
        """Public-key (or, without one, symmetric) RLWE encryption of
        Δ·m: the CKKS encryptor on a zero plaintext, plus the scaled
        message."""
        zero = Plaintext(data=torch.zeros_like(pt.data),
                         shoup=torch.zeros_like(pt.data),
                         level=pt.level, scale=1.0)
        ct = (encryptor.encrypt(zero, seed) if encryptor.pk is not None
              else encryptor.encrypt_symmetric(zero, seed))
        return self._with_part0(ct, pt, mod_add)

    def _raw_decrypt(self, ct: Ciphertext, sk_data) -> np.ndarray:
        """Σ_k c_k·s^k, inverse NTT, Montgomery form stripped: standard
        coefficient residues [..., ℓ+1, N] (numpy uint32)."""
        mc = self.ctx.mont(ct.level)
        q, rinv = mc["q"], mc["r_inv"]
        s = sk_data[: ct.level + 1]
        acc = ct.data[..., 0, :, :]
        s_pow = s
        for k in range(1, ct.num_parts):
            acc = mod_add(acc, mont_mul(ct.data[..., k, :, :], s_pow, q, rinv),
                          q)
            s_pow = mont_mul(s_pow, s, q, rinv)
        return to_u32(ntt_inv(acc.contiguous(), self.ctx.tables(ct.level),
                              strip_mont=True))

    def decrypt_coeffs_mod_t(self, ct: Ciphertext, sk_data) -> np.ndarray:
        """round(t·x/Q) mod t per coefficient of an unbatched ciphertext.

        Fast path (t < 2^61): an RNS scale-and-round with no bigints,
            m' = (t·x̂ − r̂)/Q,   r̂ = centered(t·x mod Q):
        r̂'s Q-basis residues are one u64 multiply per limb; x̂ and r̂ land
        on the auxiliary basis G > 4t by exact (two-float-α) base
        conversion on the context's device; m' is Garner-combined in u64
        and reduced mod t.  Exact for any ciphertext with ≥ 1 bit of noise
        budget.  Otherwise the exact bigint path."""
        x = self._raw_decrypt(ct, sk_data)
        lvl = self._lvl(ct.level)
        if "G_primes" not in lvl:             # huge t: exact bigint path
            centered = self.ctx.crt_lift(x, ct.level)
            Q = lvl["Q"]
            num = centered.astype(object) * self.t
            m = np.array([(2 * v + Q) // (2 * Q) for v in num], dtype=object)
            return np.mod(m, self.t)
        x64 = x.astype(np.uint64)
        u = ((x64 * lvl["t_mod_qcol"]) % lvl["q_col64"]).astype(np.uint32)
        dev = self.ctx.device
        to_g = lambda a: to_u32(fbc_apply(from_u32(a, dev), lvl["fbc_q_to_g"],
                                          precise=True)).astype(np.uint64)
        xg, rg = to_g(x), to_g(u)
        g = lvl["g_col"]
        mg = ((xg * lvl["t_mod_g"]) % g + g - rg % g) % g
        mg = (mg * lvl["qinv_mod_g"]) % g
        mp = _garner_u64(list(mg), lvl["G_primes"])       # [0, G)
        G = lvl["G"]
        m_signed = np.where(mp > G // 2,
                            mp.astype(np.int64) - np.int64(G),
                            mp.astype(np.int64))
        return np.mod(m_signed, np.int64(self.t)).astype(np.uint64)

    def decrypt(self, ct: Ciphertext, sk_data) -> np.ndarray:
        return self.decode(self.decrypt_coeffs_mod_t(ct, sk_data))

    def invariant_noise_budget(self, ct: Ciphertext, sk_data) -> int:
        """Bits of noise headroom: log2(Q/t) − log2(2·|t·x/Q − m|_∞)
        (SEAL Decryptor::invariant_noise_budget)."""
        x = self._raw_decrypt(ct, sk_data)
        lvl = self._lvl(ct.level)
        Q = lvl["Q"]
        # noise numerator: |t·x mod Q| centered; the centered value is
        # usually ≪ Q, so the adaptive lift touches only the limbs it needs
        if "t_mod_qcol" in lvl:
            u = ((x.astype(np.uint64) * lvl["t_mod_qcol"])
                 % lvl["q_col64"]).astype(np.uint32)
            rem = self.ctx.crt_lift_auto(u, ct.level)
        else:
            centered = self.ctx.crt_lift(x, ct.level)
            tx = centered.astype(object) * self.t
            rem = np.array([((v + Q // 2) % Q) - Q // 2 for v in tx],
                           dtype=object)
        worst = max(int(abs(v)) for v in rem)
        if worst == 0:
            return int(Q.bit_length() - self.t.bit_length())
        budget = (Q.bit_length() - 1) - (worst.bit_length() + 1)
        return max(budget, 0)

    # ------------------------------------------------------------------
    # multiply (HPS, any level)
    # ------------------------------------------------------------------

    def multiply(self, a: Ciphertext, b: Ciphertext,
                 ev: Evaluator) -> Ciphertext:
        """BFV ct·ct → (ka+kb−1)-part ct: tensor over Q_ℓ ∪ B, scale by
        t/Q_ℓ.  Its stages partition it: ``bfv.lift`` (each operand's
        transforms to B), ``bfv.convert`` (each precise conversion),
        ``mul.tensor`` (the products over Q_ℓ and B) and ``bfv.scale``
        (the rest of the scale-and-round)."""
        if a.level != b.level:
            raise ValueError("level mismatch")
        lvl = a.level
        L = lvl + 1
        plans = self._lvl(lvl)
        tabs_q = self.ctx.tables(lvl)
        mc_q = self.ctx.mont(lvl)
        tables_B = plans["tables_B"]

        def convert(x, plan):
            with span("bfv.convert"):
                return fbc_apply(x, plan, precise=True)

        def to_b(ct):
            with span("bfv.lift"):
                coeffs = ntt_inv(ct.data.contiguous(), tabs_q,
                                 strip_mont=True)
                ext = convert(coeffs, plans["fbc_q_to_b"])
                return ntt_fwd_mont(ext, tables_B)       # [parts, K, N] Mont

        a_b, b_b = to_b(a), to_b(b)
        with span("mul.tensor"):
            prod_q = tensor_product(a.data, b.data, mc_q["q"],
                                    mc_q["r_inv"], mc_q["qinv_neg"])
            prod_b = tensor_product(a_b, b_b, plans["q_B"],
                                    plans["r_inv_B"], plans["qinv_neg_B"])

        with span("bfv.scale"):
            # u = t·x over Q ∪ B in the coefficient domain, standard form:
            # t rides in the inverse transform's epilogue
            uq = ntt_inv(prod_q, tabs_q, strip_mont=True,
                         extra=plans["t_mod_qb"][:L])
            ub = ntt_inv(prod_b, tables_B, strip_mont=True,
                         extra=plans["t_mod_qb"][L:])
            # r = |u|_Q lifted to B; y = (u − r)/Q over B
            r_b = convert(uq, plans["fbc_q_to_b"])
            y_b = sub_mul(ub, r_b, plans["qinv_mod_b"],
                          plans["qinv_shoup_b"], tables_B.q)
            # back to Q
            out_q = convert(y_b, plans["fbc_b_to_q"])
            return Ciphertext(data=ntt_fwd_mont(out_q, tabs_q), level=lvl,
                              scale=1.0)

    # ------------------------------------------------------------------
    # modulus switching (SEAL BFV mod_switch_to_next)
    # ------------------------------------------------------------------

    def mod_switch(self, ct: Ciphertext) -> Ciphertext:
        """Divide-and-round by the last active prime (the message is
        invariant: Δ' = Q'/t tracks Q'; adds ~|s|∞ rounding noise)."""
        if ct.level < 1:
            raise ValueError("cannot mod_switch below level 0")
        d = _div_round_last(ct.data, self.ctx.rescale_plan(ct.level))
        return Ciphertext(data=d, level=ct.level - 1, scale=1.0)

    # ------------------------------------------------------------------
    # plain ops
    # ------------------------------------------------------------------

    def add_plain(self, ct: Ciphertext, pt: Plaintext, ev: Evaluator):
        return self._with_part0(ct, pt, mod_add)

    def sub_plain(self, ct: Ciphertext, pt: Plaintext, ev: Evaluator):
        return self._with_part0(ct, pt, mod_sub)

    def multiply_plain(self, ct: Ciphertext, pt: Plaintext, ev: Evaluator):
        """ct × encoded plaintext (centered small-norm poly — no Δ)."""
        q = self.ctx.tables(ct.level).q
        d = shoup_mul(ct.data, pt.data.unsqueeze(-3), pt.shoup.unsqueeze(-3),
                      q)
        return ct.with_(data=d)
