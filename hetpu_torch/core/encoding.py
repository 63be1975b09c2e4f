"""CKKS canonical-embedding encoder/decoder.

Counterpart of ``hetpu/core/encoding.py``: the same float64 numpy FFT on
the host (so decoded values agree with the reference to rounding), then
the forward NTT and the Shoup companions on the context's device.

Slot order.  Slot s ↔ exponent 5^s mod 2N, conjugate pair at -5^s — the
convention the galois rotation tables share.
"""

from __future__ import annotations

import numpy as np

from .ciphertext import Plaintext
from .context import Context
from .modular import from_u32, shoup_companion
from .ntt import ntt_fwd
from .params import Scheme


class CkksEncoder:
    def __init__(self, ctx: Context):
        if ctx.params.scheme != Scheme.CKKS:
            raise ValueError("CkksEncoder requires CKKS params")
        self.ctx = ctx
        n = ctx.params.poly_degree
        self.n = n
        self.slots = n // 2
        k = np.arange(n)
        self.zeta_pow = np.exp(1j * np.pi * k / n)        # ζ^k
        self.zeta_neg = np.conj(self.zeta_pow)            # ζ^{-k}
        # slot s ↔ evaluation index j = (5^s mod 2N - 1)/2 ; conj at -5^s
        two_n = 2 * n
        e = 1
        slot_j = np.empty(self.slots, dtype=np.int64)
        conj_j = np.empty(self.slots, dtype=np.int64)
        for s in range(self.slots):
            slot_j[s] = (e - 1) // 2
            conj_j[s] = (two_n - e - 1) // 2
            e = e * 5 % two_n
        self.slot_j = slot_j
        self.conj_j = conj_j

    @property
    def slot_count(self) -> int:
        return self.slots

    # ------------------------------------------------------------------
    def coeffs_from_values(self, values) -> np.ndarray:
        """Complex slot values (scalar or ≤slots vector) → real float64
        coefficient vector (unscaled)."""
        z = np.asarray(values, dtype=np.complex128)
        if z.ndim == 0:
            # constant slots ⇔ m(x) = Re(c) + Im(c)·x^{N/2} exactly
            m = np.zeros(self.n)
            m[0] = z.real
            m[self.n // 2] = z.imag
            return m
        if z.ndim != 1 or z.shape[0] > self.slots:
            raise ValueError(f"expected ≤{self.slots} values, got {z.shape}")
        if z.shape[0] < self.slots:
            z = np.concatenate([z, np.zeros(self.slots - z.shape[0], z.dtype)])
        v = np.zeros(self.n, dtype=np.complex128)
        v[self.slot_j] = z
        v[self.conj_j] = np.conj(z)
        a = np.fft.fft(v) / self.n
        m = a * self.zeta_neg
        return m.real  # imaginary part is fp round-off by construction

    def values_from_coeffs(self, coeffs: np.ndarray) -> np.ndarray:
        """Real coefficient vector → complex slot values (unscaled)."""
        a = coeffs.astype(np.complex128) * self.zeta_pow
        v = self.n * np.fft.ifft(a)
        return v[self.slot_j]

    # ------------------------------------------------------------------
    def encode(self, values, level: int | None = None,
               scale: float | None = None) -> Plaintext:
        """Encode complex values into an NTT-domain plaintext with Shoup
        companions, on the context's device."""
        ctx = self.ctx
        if level is None:
            level = ctx.num_data - 1
        if scale is None:
            scale = ctx.params.scale
        m = self.coeffs_from_values(values) * scale
        amax = np.abs(m).max() if m.size else 0.0
        if amax >= 2**62:
            ints = np.array([round(x) for x in m], dtype=object)
        else:
            ints = np.rint(m).astype(np.int64)
        res = from_u32(ctx.to_rns(ints, level), ctx.device)
        tabs = ctx.tables(level)
        data = ntt_fwd(res, tabs)
        return Plaintext(data=data, shoup=shoup_companion(data, tabs.q),
                         level=level, scale=float(scale))

    def decode(self, coeff_residues: np.ndarray, level: int,
               scale: float) -> np.ndarray:
        """[ℓ+1, N] standard-form coefficient residues → complex slots, via
        the small-value CRT lift (a decrypted coefficient ≈ scale·|m| +
        noise ≪ Q)."""
        bound = int(np.log2(scale)) + 34        # |m|≤2^16, noise ≤ 2^18
        centered = self.ctx.crt_lift_small(np.asarray(coeff_residues),
                                           level, bound)
        m = centered.astype(np.float64) / scale
        return self.values_from_coeffs(m)
