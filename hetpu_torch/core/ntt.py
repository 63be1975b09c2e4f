"""Negacyclic NTT/INTT over RNS limb-planar tensors [..., L, N].

Counterpart of ``hetpu/core/ntt.py`` (flat tables and butterflies) and of
the transform computed by the JAX package's Pallas NTT kernels
(``hetpu/core/mxu_ntt.py`` ``_pallas_call``; ``hetpu/core/pallas_ntt.py``
``_fwd_call`` / ``_inv_call``).  The four-step and int8-digit-matrix forms
there are shaped by the TPU and are bit-exact with this flat transform;
the CUDA kernel here (``csrc/ntt.cu``) works from the flat twiddles.

  * forward = Cooley-Tukey, natural → bit-reversed order; inverse =
    Gentleman-Sande, bit-reversed → natural, no explicit permutation;
  * ψ powers folded into the twiddle tables ⇒ the negacyclic wrap is free;
  * one per-limb epilogue constant: ×R (``to_mont``), ×N⁻¹, ×N⁻¹R⁻¹
    (``strip_mont``) or ×N⁻¹R⁻¹·extra.

Dispatch: a CUDA tensor launches the ``ntt`` kernel, a CPU tensor takes
the plain int64 butterflies (:func:`ntt_fwd_plain`, :func:`ntt_inv_plain`).
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from functools import lru_cache

import numpy as np
import torch

from . import cuda_lib, nt
from .modular import add_i64, from_u32, shoup_precompute, sub_i64, u32


@dataclass(frozen=True)
class NttTables:
    """Per-RNS-basis twiddle tables as int32 tensors on one device.

    Shapes: w_* are [L, N]; the n_inv / r constants and q are [L, 1].
    ``n_inv_rinv`` = N⁻¹·R⁻¹ mod q lets the inverse transform strip
    Montgomery form for free; ``r`` = R mod q re-enters it."""

    n: int
    primes: tuple[int, ...]
    q: torch.Tensor
    fwd_w: torch.Tensor          # ψ^{br(i)}
    fwd_w_shoup: torch.Tensor
    inv_w: torch.Tensor          # ψ^{-br(i)}
    inv_w_shoup: torch.Tensor
    n_inv: torch.Tensor
    n_inv_shoup: torch.Tensor
    n_inv_rinv: torch.Tensor
    n_inv_rinv_shoup: torch.Tensor
    r: torch.Tensor
    r_shoup: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.q.device

    def slice(self, idx) -> "NttTables":
        """Sub-basis: select primes by index list/array (duplicates allowed)."""
        idx = [int(i) for i in np.asarray(idx).reshape(-1)]
        index = torch.tensor(idx, dtype=torch.long, device=self.device)
        kw = {f.name: getattr(self, f.name).index_select(0, index)
              for f in fields(self) if f.name not in ("n", "primes")}
        return NttTables(n=self.n, primes=tuple(self.primes[i] for i in idx),
                         **kw)


@lru_cache(maxsize=None)
def host_tables(n: int, primes: tuple[int, ...]) -> dict[str, np.ndarray]:
    """The reference's ``build_tables`` arrays (numpy uint32), cached by
    (n, primes): contexts on several devices share one host build."""
    logn = n.bit_length() - 1
    L = len(primes)
    R = 1 << 32
    fwd = np.zeros((L, n), dtype=np.uint32)
    inv = np.zeros((L, n), dtype=np.uint32)
    n_inv = np.zeros((L, 1), dtype=np.uint32)
    n_inv_rinv = np.zeros((L, 1), dtype=np.uint32)
    r_col = np.zeros((L, 1), dtype=np.uint32)
    br = np.array([nt.bit_reverse(i, logn) for i in range(n)])
    for li, q in enumerate(primes):
        psi = nt.root_of_unity(2 * n, q)
        psi_inv = nt.modinv(psi, q)
        pw = np.empty(n, dtype=object)
        ipw = np.empty(n, dtype=object)
        x = ix = 1
        for i in range(n):
            pw[i] = x
            ipw[i] = ix
            x = x * psi % q
            ix = ix * psi_inv % q
        fwd[li] = pw[br].astype(np.uint64).astype(np.uint32)
        inv[li] = ipw[br].astype(np.uint64).astype(np.uint32)
        n_inv[li, 0] = nt.modinv(n, q)
        n_inv_rinv[li, 0] = nt.modinv(n, q) * nt.modinv(R % q, q) % q
        r_col[li, 0] = R % q
    qcol = np.array(primes, dtype=np.uint32).reshape(-1, 1)
    out = dict(q=qcol, fwd_w=fwd, inv_w=inv, n_inv=n_inv,
               n_inv_rinv=n_inv_rinv, r=r_col)
    for k in ("fwd_w", "inv_w", "n_inv", "n_inv_rinv", "r"):
        out[f"{k}_shoup"] = shoup_precompute(out[k], qcol)
    for a in out.values():
        a.setflags(write=False)
    return out


def build_tables(n: int, primes, device="cpu") -> NttTables:
    primes = tuple(int(p) for p in primes)
    h = host_tables(n, primes)
    return NttTables(n=n, primes=primes,
                     **{k: from_u32(v, device) for k, v in h.items()})


# ----------------------------------------------------------------------
# Plain PyTorch transforms (int64; the CPU path and the kernel's twin)
# ----------------------------------------------------------------------

def _epilogue_plain(x, c1, c2, q):
    """x·c1(·c2) mod q with per-limb constants (x int64 [..., L, N])."""
    if c1 is not None:
        x = x * u32(c1).reshape(-1, 1) % q
    if c2 is not None:
        x = x * u32(c2).reshape(-1, 1) % q
    return x


def ntt_fwd_plain(a: torch.Tensor, t: NttTables, *,
                  to_mont: bool = False) -> torch.Tensor:
    """Forward NTT, int32 [..., L, N] natural order → bit-reversed
    evaluations (×R mod q with ``to_mont``)."""
    n = t.n
    L = len(t.primes)
    lead = a.shape[:-2]
    q3 = u32(t.q).reshape(L, 1, 1)
    x = a.to(torch.int64)
    m, half = 1, n // 2
    while m < n:
        x = x.reshape(*lead, L, m, 2, half)
        w = u32(t.fwd_w[:, m: 2 * m]).reshape(L, m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :] * w % q3
        x = torch.stack([add_i64(u, v, q3), sub_i64(u, v, q3)], dim=-2)
        m *= 2
        half //= 2
    x = x.reshape(*lead, L, n)
    x = _epilogue_plain(x, t.r if to_mont else None, None, u32(t.q))
    return x.to(torch.int32)


def ntt_inv_plain(a: torch.Tensor, t: NttTables, *, strip_mont: bool = False,
                  extra=None) -> torch.Tensor:
    """Inverse NTT, bit-reversed evaluations → natural coefficients with
    the N⁻¹ (or N⁻¹R⁻¹ with ``strip_mont``, times ``extra``) epilogue."""
    c1, c2 = _inv_constants(t, strip_mont, extra)
    n = t.n
    L = len(t.primes)
    lead = a.shape[:-2]
    q3 = u32(t.q).reshape(L, 1, 1)
    x = a.to(torch.int64)
    m, half = n // 2, 1
    while m >= 1:
        x = x.reshape(*lead, L, m, 2, half)
        w = u32(t.inv_w[:, m: 2 * m]).reshape(L, m, 1)
        u = x[..., 0, :]
        v = x[..., 1, :]
        d = sub_i64(u, v, q3) * w % q3
        x = torch.stack([add_i64(u, v, q3), d], dim=-2)
        m //= 2
        half *= 2
    x = _epilogue_plain(x.reshape(*lead, L, n), c1, c2, u32(t.q))
    return x.to(torch.int32)


def _inv_constants(t: NttTables, strip_mont: bool, extra):
    if extra is not None and not strip_mont:
        raise ValueError("extra requires strip_mont=True")
    return (t.n_inv_rinv if strip_mont else t.n_inv), extra


# ----------------------------------------------------------------------
# Dispatching wrappers (CUDA kernel ``ntt`` on the card)
# ----------------------------------------------------------------------

MIN_LOGN, MAX_LOGN = 10, 15     # the kernel keeps one plane in shared memory


def check_plane_shape(name: str, x: torch.Tensor, n: int,
                      rows_dim: int) -> int:
    """Validate x as [..., rows_dim, n] with n in the kernel's range;
    return log2 n."""
    if x.dim() < 2 or tuple(x.shape[-2:]) != (rows_dim, n):
        raise ValueError(f"{name}: shape {tuple(x.shape)} does not match "
                         f"[..., {rows_dim}, {n}]")
    logn = n.bit_length() - 1
    if not MIN_LOGN <= logn <= MAX_LOGN:
        raise ValueError(f"{name}: the CUDA kernel takes N = 2^{MIN_LOGN}.."
                         f"2^{MAX_LOGN}, got N = {n}")
    return logn


def _ntt_cuda(a, t: NttTables, *, inverse: bool, c1, c2) -> torch.Tensor:
    L = len(t.primes)
    cuda_lib.on_card(a, t.q)
    consts = [c for c in (c1, c2) if c is not None]
    cuda_lib.check_i32("ntt", a, t.q, *consts)
    for c in consts:
        if c.numel() != L:
            raise ValueError(f"ntt: epilogue constant has {c.numel()} "
                             f"entries for {L} limbs")
    logn = check_plane_shape("ntt", a, t.n, L)
    out = torch.empty_like(a)
    rows = a.numel() // (L * t.n)
    if rows == 0:
        return out
    w, ws = (t.inv_w, t.inv_w_shoup) if inverse else (t.fwd_w, t.fwd_w_shoup)
    p = cuda_lib.ptr
    cuda_lib.launch("ntt", "hetpu_ntt", a.device, p(a), p(out), rows, L,
                    logn, p(w), p(ws), p(t.q), p(c1), p(c2), int(inverse))
    return out


def ntt_fwd(a: torch.Tensor, t: NttTables, *,
            to_mont: bool = False) -> torch.Tensor:
    """Forward NTT (see :func:`ntt_fwd_plain`); the ``ntt`` kernel on a
    CUDA tensor."""
    if cuda_lib.on_card(a):
        return _ntt_cuda(a, t, inverse=False, c1=t.r if to_mont else None,
                         c2=None)
    return ntt_fwd_plain(a, t, to_mont=to_mont)


def ntt_fwd_mont(a: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Forward NTT of standard-form coefficients → Montgomery-form
    evaluations (×R folded into the epilogue)."""
    return ntt_fwd(a, t, to_mont=True)


def ntt_inv(a: torch.Tensor, t: NttTables, *, strip_mont: bool = False,
            extra=None) -> torch.Tensor:
    """Inverse NTT (see :func:`ntt_inv_plain`); the ``ntt`` kernel on a
    CUDA tensor."""
    if cuda_lib.on_card(a):
        c1, c2 = _inv_constants(t, strip_mont, extra)
        return _ntt_cuda(a, t, inverse=True, c1=c1, c2=c2)
    return ntt_inv_plain(a, t, strip_mont=strip_mont, extra=extra)
