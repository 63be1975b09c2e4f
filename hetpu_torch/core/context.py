"""HE context: precomputed tables for one parameter set, on one device.

Counterpart of ``hetpu/core/context.py``.  The plans' constants are
computed on the host with the reference's exact numpy code and then
placed on ``device`` as int32 tensors (uint32 bit patterns, see
:mod:`.modular`).  Flat NTT tables serve every N: the reference's
four-step and int8 digit-matrix tables are TPU-shaped and bit-exact with
the flat transform.

Level convention: ``level = ℓ`` means data primes ``q_0..q_ℓ`` are active
(ℓ+1 limbs).  A fresh ciphertext is at ``level = num_levels-1``.

The device defaults to ``"cuda"``; without a card that raises (there is
no fallback): pass ``device="cpu"`` for the plain PyTorch paths.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import centered_fbc, nt, rns
from .cuda_lib import RowMap
from .modular import from_u32, mont_constants, shoup_precompute
from .ntt import NttTables, build_tables
from .params import HeParams
from ..utils.profiling import phase


def _col(xs, dt=np.uint32) -> np.ndarray:
    return np.array(xs, dtype=dt).reshape(-1, 1)


@dataclass(frozen=True)
class RescalePlan:
    """Constants for dividing-and-rounding a ciphertext by its last active
    prime q_ℓ (CKKS rescale).  Shapes broadcast against [..., ℓ(+1), N]."""

    src_tables: NttTables        # the dropped prime (1 limb)
    dst_tables: NttTables        # remaining primes (ℓ limbs)
    half: torch.Tensor           # [1,1]  q_src >> 1
    half_mod: torch.Tensor       # [ℓ,1]  (q_src>>1) mod q_i
    mu: torch.Tensor             # [ℓ,1]  floor(2^32/q_i) (Barrett parity)
    src_inv: torch.Tensor        # [ℓ,1]  q_src^{-1} mod q_i
    src_inv_shoup: torch.Tensor


@dataclass(frozen=True)
class ModDownPlan:
    """Divide a key-basis accumulator by P = ∏ special primes, back to the
    active data basis (centered FBC of the special limbs)."""

    src_tables: NttTables        # the k special primes
    dst_tables: NttTables        # active data primes
    fbc: rns.FbcPlan             # specials → data
    p_inv: torch.Tensor          # [ℓ+1,1]  P^{-1} mod q_i
    p_inv_shoup: torch.Tensor


@dataclass(frozen=True)
class ModDownRescalePlan:
    """FUSED key-switch mod-down + CKKS rescale: divide the key-basis
    accumulator (plus P·(c0,c1)) by P·q_ℓ in ONE divide-and-round."""

    src_tables: NttTables        # [q_ℓ] + specials  (α+1 limbs)
    dst_tables: NttTables        # data primes q_0..q_{ℓ-1}
    fbc: rns.FbcPlan             # sources → dst
    p_mod: torch.Tensor          # [ℓ+1,1]  P mod q_i (for c·P lift)
    p_mod_shoup: torch.Tensor
    pq_inv: torch.Tensor         # [ℓ,1]  (P·q_ℓ)^{-1} mod q_i
    pq_inv_shoup: torch.Tensor


@dataclass(frozen=True)
class KeySwitchPlan:
    """Generalized hybrid key-switch constants at level ℓ with digit size
    α = #special primes (see the reference's ``KeySwitchPlan``)."""

    level: int
    alpha: int
    num_digits: int              # ceil((ℓ+1)/α)
    digit_bounds: tuple          # ((start, stop), ...) within active primes
    basis_tables: NttTables      # key basis {q_0..q_ℓ, specials}   [R, N]
    q: torch.Tensor              # [R,1]
    qinv_neg: torch.Tensor       # [R,1] Montgomery -q^{-1} mod 2^32
    dig_inv: torch.Tensor        # [ℓ+1,1]  (D_j/q_i)^{-1} mod q_i
    dig_inv_shoup: torch.Tensor
    rinv: torch.Tensor           # [ℓ+1,1]  R^{-1} mod q_i
    rinv_shoup: torch.Tensor
    foreign_idx: tuple           # (np.ndarray, ...) per digit
    foreign_tables: tuple        # (NttTables, ...) per digit's foreign basis
    foreign_cat_tables: NttTables  # all digits' foreign bases, concatenated
    dhat: torch.Tensor           # [ℓ+1,R]  (D_j/q_i) mod r
    dhat_shoup: torch.Tensor
    lift_w: torch.Tensor         # [F, α]  fused lift+NTT weights
    lift_ws: torch.Tensor        # [F, α]
    lift_dig: torch.Tensor       # [F] int32 digit index per foreign row
    # where the decompose stores its limbs in a row of digits [J, R]
    # (limb j·R + r): the F lifted rows, then each own prime i (digit
    # i // α, limb i); together every one of the J·R limbs once
    ext_row: RowMap              # [F] into J·R
    own_row: RowMap              # [ℓ+1] into J·R
    moddown: ModDownPlan


class Context:
    """All precomputed state for a parameter set on ``device``.  Per-level
    views and plans are built on first use and kept on the instance; the
    constructor and each build are the set-up phase ``context``
    (``utils.profiling.phase``)."""

    @phase("context")
    def __init__(self, params: HeParams, device="cuda"):
        self.params = params
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("Context: no CUDA device; pass "
                                   "device='cpu' for the plain PyTorch paths")
            with phase("card"):        # CUDA's init and context, if first
                torch.cuda.synchronize(self.device)
        n = params.poly_degree
        self.all_primes: tuple[int, ...] = params.moduli + params.special_moduli
        self.num_data = len(params.moduli)
        self.num_special = len(params.special_moduli)
        self.tables_full = build_tables(n, self.all_primes, self.device)
        self.mont_full = mont_constants(self.all_primes)
        self._memo: dict = {}

    def _t(self, a) -> torch.Tensor:
        return from_u32(a, self.device)

    def _cached(self, key, build):
        out = self._memo.get(key)
        if out is None:
            with phase("context"):
                out = self._memo[key] = build()
        return out

    # ------------------------------------------------------------------
    # Per-level views
    # ------------------------------------------------------------------

    def tables(self, level: int) -> NttTables:
        """NTT tables for active data primes q_0..q_level."""
        return self._cached(("tables", level), lambda: self.tables_full.slice(
            np.arange(level + 1)))

    def mont(self, level: int) -> dict:
        """Per-limb Montgomery constants of q_0..q_level as [ℓ+1, 1]
        tensors (keys of :func:`.modular.mont_constants`)."""
        return self._cached(("mont", level), lambda: {
            k: self._t(v[: level + 1]) for k, v in self.mont_full.items()})

    def keyswitch_plan(self, level: int) -> KeySwitchPlan:
        return self._cached(("ks", level), lambda: self._keyswitch_plan(level))

    def rescale_plan(self, level: int) -> RescalePlan:
        """Divide-and-round by q_level, landing on level-1."""
        if level < 1:
            raise ValueError("cannot rescale below level 0")
        return self._cached(("rs", level), lambda: self._make_rescale(
            src_idx=level, dst_idx=np.arange(level),
            src_prime=self.params.moduli[level],
            dst_primes=self.params.moduli[: level]))

    def centered_fbc_plan(self, fbc: rns.FbcPlan
                          ) -> centered_fbc.CenteredFbcPlan:
        """Centered form of one of this context's FBC plans (the memo
        keeps ``fbc`` alive, so its id stays its own)."""
        return self._cached(("cfbc", id(fbc)), lambda: (
            fbc, centered_fbc.fbc_plan(fbc)))[1]

    def moddown_rescale_plan(self, level: int) -> ModDownRescalePlan:
        return self._cached(("mdr", level),
                            lambda: self._moddown_rescale_plan(level))

    def group_rescale_plan(self, level: int) -> ModDownPlan:
        """Paired-prime rescale: divide-and-round by q_{ℓ-1}·q_ℓ (the
        rescale_group=2 high-precision mode), the key-switch mod-down's
        centered-FBC divide with the dropped pair as its sources."""
        return self._cached(("grs", level),
                            lambda: self._group_rescale_plan(level))

    def _group_rescale_plan(self, level: int) -> ModDownPlan:
        g = self.params.rescale_group
        if level - g + 1 < self.params.num_anchor:
            raise ValueError("cannot rescale into the anchor primes")
        src = list(self.params.moduli[level - g + 1: level + 1])
        dst = list(self.params.moduli[: level - g + 1])
        P = 1
        for p in src:
            P *= p
        p_inv = _col([nt.modinv(P % q, q) for q in dst])
        return ModDownPlan(
            src_tables=self.tables_full.slice(
                np.arange(level - g + 1, level + 1)),
            dst_tables=self.tables_full.slice(np.arange(level - g + 1)),
            fbc=rns.make_fbc(src, dst, self.device),
            p_inv=self._t(p_inv),
            p_inv_shoup=self._t(shoup_precompute(p_inv, _col(dst))),
        )

    def _keyswitch_plan(self, level: int) -> KeySwitchPlan:
        """Generalized hybrid key-switch constants at level ℓ."""
        alpha = self.num_special
        k = self.num_special
        n_data = level + 1
        J = -(-n_data // alpha)
        active = list(self.params.moduli[: n_data])
        specials = list(self.params.special_moduli)
        basis_index = np.concatenate(
            [np.arange(n_data),
             np.arange(self.num_data, self.num_data + k)])
        basis_primes = active + specials
        R = len(basis_primes)
        bounds = tuple((j * alpha, min((j + 1) * alpha, n_data))
                       for j in range(J))
        dig_inv = np.zeros((n_data, 1), dtype=np.uint32)
        rinv = _col([nt.modinv((1 << 32) % q, q) for q in active])
        dhat = np.zeros((n_data, R), dtype=np.uint32)
        for (lo, hi) in bounds:
            D = 1
            for i in range(lo, hi):
                D *= active[i]
            for i in range(lo, hi):
                qi = active[i]
                dig_inv[i, 0] = nt.modinv((D // qi) % qi, qi)
                for rj, r in enumerate(basis_primes):
                    dhat[i, rj] = (D // qi) % r
        dhat_shoup = np.zeros_like(dhat)
        for rj, r in enumerate(basis_primes):
            dhat_shoup[:, rj] = ((dhat[:, rj].astype(np.uint64) << np.uint64(32))
                                 // np.uint64(r)).astype(np.uint32)
        P = 1
        for p in specials:
            P *= p
        p_inv = _col([nt.modinv(P % q, q) for q in active])
        moddown = ModDownPlan(
            src_tables=self.tables_full.slice(
                np.arange(self.num_data, self.num_data + k)),
            dst_tables=self.tables_full.slice(np.arange(n_data)),
            fbc=rns.make_fbc(specials, active, self.device),
            p_inv=self._t(p_inv),
            p_inv_shoup=self._t(shoup_precompute(p_inv, _col(active))),
        )
        basis_tables = self.tables_full.slice(basis_index)
        foreign_idx = tuple(
            np.concatenate([np.arange(lo), np.arange(hi, R)])
            for (lo, hi) in bounds)
        # fused-lift weights over the concatenated foreign basis
        F = sum(len(f) for f in foreign_idx)
        lift_w = np.zeros((F, alpha), dtype=np.uint32)
        lift_dig = np.zeros(F, dtype=np.int32)
        row = 0
        for d, (lo, hi) in enumerate(bounds):
            for f in foreign_idx[d]:
                lift_dig[row] = d
                for i in range(hi - lo):
                    lift_w[row, i] = dhat[lo + i, f]
                row += 1
        lift_ws = np.zeros_like(lift_w)
        row = 0
        for d in range(J):
            for f in foreign_idx[d]:
                r = basis_primes[int(f)]
                lift_ws[row] = ((lift_w[row].astype(np.uint64) << np.uint64(32))
                                // np.uint64(r)).astype(np.uint32)
                row += 1
        ext_row = np.concatenate([j * R + f for j, f in
                                  enumerate(foreign_idx)])
        own_row = np.arange(n_data) // alpha * R + np.arange(n_data)
        if not np.array_equal(np.sort(np.concatenate([ext_row, own_row])),
                              np.arange(J * R)):
            raise ValueError(f"keyswitch_plan({level}): the digit rows do "
                             f"not cover the {J}·{R} limbs once each")
        return KeySwitchPlan(
            level=level,
            alpha=alpha,
            num_digits=J,
            digit_bounds=bounds,
            basis_tables=basis_tables,
            foreign_idx=foreign_idx,
            foreign_tables=tuple(basis_tables.slice(f) for f in foreign_idx),
            foreign_cat_tables=basis_tables.slice(np.concatenate(foreign_idx)),
            q=self._t(_col(basis_primes)),
            qinv_neg=self._t(_col([((1 << 32) - nt.modinv(r, 1 << 32))
                                   % (1 << 32) for r in basis_primes])),
            dig_inv=self._t(dig_inv),
            dig_inv_shoup=self._t(shoup_precompute(dig_inv, _col(active))),
            rinv=self._t(rinv),
            rinv_shoup=self._t(shoup_precompute(rinv, _col(active))),
            dhat=self._t(dhat),
            dhat_shoup=self._t(dhat_shoup),
            lift_w=self._t(lift_w),
            lift_ws=self._t(lift_ws),
            lift_dig=torch.from_numpy(lift_dig).to(self.device),
            ext_row=RowMap(torch.from_numpy(ext_row.astype(np.int32)).to(
                self.device), J * R),
            own_row=RowMap(torch.from_numpy(own_row.astype(np.int32)).to(
                self.device), J * R),
            moddown=moddown,
        )

    def _make_rescale(self, src_idx, dst_idx, src_prime,
                      dst_primes) -> RescalePlan:
        half = src_prime >> 1
        src_inv = _col([nt.modinv(src_prime % q, q) for q in dst_primes])
        return RescalePlan(
            src_tables=self.tables_full.slice(np.array([src_idx])),
            dst_tables=self.tables_full.slice(dst_idx),
            half=self._t(_col([half])),
            half_mod=self._t(_col([half % q for q in dst_primes])),
            mu=self._t(_col([(1 << 32) // q for q in dst_primes])),
            src_inv=self._t(src_inv),
            src_inv_shoup=self._t(shoup_precompute(src_inv, _col(dst_primes))),
        )

    def _moddown_rescale_plan(self, level: int) -> ModDownRescalePlan:
        """Fused divide-and-round by P·q_level (·q_{level-1} when
        rescale_group=2), landing on level-group."""
        g = self.params.rescale_group
        floor = self.params.num_anchor if g > 1 else 1
        if level - g + 1 < floor:
            raise ValueError("cannot rescale below the chain floor")
        k = self.num_special
        dropped = list(self.params.moduli[level - g + 1: level + 1])
        specials = list(self.params.special_moduli)
        dst = list(self.params.moduli[: level - g + 1])
        src_idx = np.concatenate(
            [np.arange(level - g + 1, level + 1),
             np.arange(self.num_data, self.num_data + k)])
        P = 1
        for p in specials:
            P *= p
        PQ = P
        for q in dropped:
            PQ *= q
        active = list(self.params.moduli[: level + 1])
        p_mod = _col([P % q for q in active])
        pq_inv = _col([nt.modinv(PQ % q, q) for q in dst])
        return ModDownRescalePlan(
            src_tables=self.tables_full.slice(src_idx),
            dst_tables=self.tables_full.slice(np.arange(level - g + 1)),
            fbc=rns.make_fbc(dropped + specials, dst, self.device),
            p_mod=self._t(p_mod),
            p_mod_shoup=self._t(shoup_precompute(p_mod, _col(active))),
            pq_inv=self._t(pq_inv),
            pq_inv_shoup=self._t(shoup_precompute(pq_inv, _col(dst))),
        )

    # ------------------------------------------------------------------
    # Exact CRT helpers (host side, Python ints)
    # ------------------------------------------------------------------

    def q_at(self, level: int) -> int:
        x = 1
        for q in self.params.moduli[: level + 1]:
            x *= q
        return x

    def crt_lift(self, residues: np.ndarray, level: int) -> np.ndarray:
        """[ℓ+1, N] uint32 standard-form residues → object array of centered
        Python ints in (-Q/2, Q/2]."""
        primes = self.params.moduli[: level + 1]
        Q = self.q_at(level)
        acc = np.zeros(residues.shape[-1], dtype=object)
        for i, q in enumerate(primes):
            qhat = Q // q
            coef = qhat * nt.modinv(qhat % q, q) % Q
            acc = (acc + residues[i].astype(object) * coef) % Q
        return np.where(acc > Q // 2, acc - Q, acc)

    def _lift_k(self, residues: np.ndarray, primes, k: int):
        """Centered CRT lift over the first k limbs (object ints).
        Returns (out, Qk)."""
        Qk = 1
        for q in primes[:k]:
            Qk *= q
        acc = np.zeros(residues.shape[-1], dtype=object)
        for i in range(k):
            q = primes[i]
            qhat = Qk // q
            coef = qhat * nt.modinv(qhat % q, q) % Qk
            acc = (acc + residues[i].astype(object) * coef) % Qk
        return np.where(acc > Qk // 2, acc - Qk, acc), Qk

    def _lift_consistent(self, out: np.ndarray, residues: np.ndarray,
                         primes, k: int, spares: int) -> bool:
        """True iff the k-limb lift reproduces the next ``spares`` limbs'
        residues (per-spare false-accept ~2^-31; two spares give a ≥2^60
        guard band)."""
        for spare in range(k, min(k + spares, len(primes))):
            qc = int(primes[spare])
            if not np.array_equal((out % qc).astype(np.int64),
                                  residues[spare].astype(np.int64)):
                return False
        return True

    def crt_lift_auto(self, residues: np.ndarray, level: int) -> np.ndarray:
        """Centered lift of values of UNKNOWN (typically small) magnitude:
        escalates the limb count geometrically, validating each attempt
        against two spare limbs, falling back to the exact full lift (the
        BFV noise-budget probe, where the noise is usually ≪ Q)."""
        primes = self.params.moduli[: level + 1]
        k = 2
        while k + 2 <= len(primes):
            out, _ = self._lift_k(residues, primes, k)
            if self._lift_consistent(out, residues, primes, k, 2):
                return out
            k *= 2
        return self.crt_lift(residues, level)

    def crt_lift_small(self, residues: np.ndarray, level: int,
                       bound_bits: int) -> np.ndarray:
        """Centered lift of values KNOWN to be < 2^bound_bits in magnitude
        (a decrypted CKKS coefficient ≈ scale·|m| + noise ≪ Q): CRT over
        only the first k limbs with product > 2^{bound+2}, checked against
        the next two limbs; falls back to the full lift on a mismatch."""
        primes = self.params.moduli[: level + 1]
        k, prod = 0, 1
        while k < len(primes) and prod.bit_length() <= bound_bits + 2:
            prod *= primes[k]
            k += 1
        if k < len(primes):
            out, _ = self._lift_k(residues, primes, k)
            if self._lift_consistent(out, residues, primes, k, 2):
                return out
        return self.crt_lift(residues, level)

    def to_rns(self, coeffs: np.ndarray, level: int) -> np.ndarray:
        """Int array (possibly negative; int64 or object) → [ℓ+1, N] uint32."""
        primes = self.params.moduli[: level + 1]
        out = np.empty((len(primes), coeffs.shape[-1]), dtype=np.uint32)
        if coeffs.dtype != object:
            c = coeffs.astype(np.int64)
            for i, q in enumerate(primes):
                out[i] = (c % np.int64(q)).astype(np.uint32)
            return out
        c = coeffs.astype(object)
        for i, q in enumerate(primes):
            out[i] = (c % q).astype(np.uint64).astype(np.uint32)
        return out
