"""Fused NTT entry points of the key-switch path.

Counterpart of the public API of ``hetpu/core/mxu_ntt.py`` (``ntt_fwd``
``:802``, ``ntt_fwd_lifted`` ``:919``, ``ntt_fwd_fbc`` ``:962``,
``ntt_inv`` ``:1000``) with the same signatures.  The JAX package
computes these on the TPU's matrix unit with int8 digit matrices; there
is no such unit here, hence the new name.  The transforms are the flat
ones of :mod:`.ntt`; the fused prologues run in CUDA kernels
(``csrc/fused_ntt.cu``) so the lifted / converted planes never travel
through device memory:

  * ``ntt_fwd_lifted`` — kernel ``ntt_fwd_lifted``: key-switch digit lift
    Σ_{i<α} y[dig_f·α+i]·lift_w[f,i] mod q_f, then the forward NTT;
  * ``ntt_fwd_fbc`` — kernel ``ntt_fwd_fbc``: centered fast base
    conversion (f32 α, see :mod:`.rns`), then the forward NTT ×R.

A CPU tensor takes the plain twin (``*_plain``); a CUDA tensor launches
the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_lib, rns
from .modular import add_i64, u32
from .ntt import NttTables, check_plane_shape, ntt_fwd, ntt_fwd_plain, ntt_inv

__all__ = ["ntt_fwd", "ntt_inv", "ntt_fwd_lifted", "ntt_fwd_lifted_plain",
           "ntt_fwd_fbc", "ntt_fwd_fbc_plain"]


# ----------------------------------------------------------------------
# digit lift + forward NTT
# ----------------------------------------------------------------------

def _lift_index(lift_dig: torch.Tensor, A: int, Ly: int) -> torch.Tensor:
    """[F, A] source plane of each lift term: dig_f·α+i, clamped to the
    last plane (the padded terms of a short digit have lift_w = 0)."""
    idx = lift_dig.to(torch.int64)[:, None] * A + torch.arange(
        A, device=lift_dig.device)[None, :]
    return idx.clamp(max=Ly - 1)


def ntt_fwd_lifted_plain(y, lift_w, lift_ws, lift_dig, t: NttTables, *,
                         to_mont: bool = False) -> torch.Tensor:
    """Plain twin of the ``ntt_fwd_lifted`` kernel: y int32 [..., Ly, N]
    standard-form planes → [..., F, N] over the foreign basis ``t``."""
    F, A = lift_w.shape
    Ly, N = y.shape[-2:]
    idx = _lift_index(lift_dig, A, Ly)
    yg = u32(y.index_select(-2, idx.reshape(-1)))
    yg = yg.reshape(*y.shape[:-2], F, A, N)
    q = u32(t.q)                                           # [F, 1]
    acc = None
    for i in range(A):
        term = yg[..., :, i, :] * u32(lift_w[:, i: i + 1]) % q
        acc = term if acc is None else add_i64(acc, term, q)
    return ntt_fwd_plain(acc.to(torch.int32), t, to_mont=to_mont)


def ntt_fwd_lifted(y, lift_w, lift_ws, lift_dig, t: NttTables, *,
                   to_mont: bool = False) -> torch.Tensor:
    """Fused digit lift + forward NTT over the concatenated-foreign key
    basis: out[..., f, :] = ntt_fwd(Σ_i y[..., dig_f·α+i, :]·lift_w[f, i])
    row f.  y: [..., Ly, N] standard-form planes (the decompose INTT
    output); lift_w/lift_ws [F, α]; lift_dig int32 [F]."""
    if not cuda_lib.on_card(y, lift_w, lift_ws, lift_dig, t.q):
        return ntt_fwd_lifted_plain(y, lift_w, lift_ws, lift_dig, t,
                                    to_mont=to_mont)
    F, A = lift_w.shape
    cuda_lib.check_i32("ntt_fwd_lifted", y, lift_w, lift_ws, lift_dig, t.q)
    if len(t.primes) != F or lift_ws.shape != lift_w.shape \
            or lift_dig.shape != (F,):
        raise ValueError("ntt_fwd_lifted: lift_w/lift_ws [F, A], lift_dig "
                         "[F] and tables of F primes expected")
    Ly = y.shape[-2]
    logn = check_plane_shape("ntt_fwd_lifted", y, t.n, Ly)
    rows = y.numel() // (Ly * t.n)
    out = torch.empty((*y.shape[:-2], F, t.n), dtype=torch.int32,
                      device=y.device)
    if rows == 0:
        return out
    p = cuda_lib.ptr
    cuda_lib.launch("ntt_fwd_lifted", "hetpu_ntt_fwd_lifted", y.device,
                    p(y), p(out), rows, Ly, F, A, logn, p(lift_w), p(lift_ws),
                    p(lift_dig), p(t.fwd_w), p(t.fwd_w_shoup), p(t.q),
                    p(t.r) if to_mont else None)
    return out


# ----------------------------------------------------------------------
# centered FBC + forward NTT
# ----------------------------------------------------------------------

def ntt_fwd_fbc_plain(u, fbc: rns.FbcPlan, t: NttTables, *,
                      to_mont: bool = True) -> torch.Tensor:
    """Plain twin of the ``ntt_fwd_fbc`` kernel."""
    r_q = rns.fbc_apply(u, fbc, correct=True, premul=False)
    return ntt_fwd_plain(r_q, t, to_mont=to_mont)


def ntt_fwd_fbc(u, fbc: rns.FbcPlan, t: NttTables, *,
                to_mont: bool = True) -> torch.Tensor:
    """Fused centered fast base conversion + forward NTT (the key-switch
    mod-down / fused-rescale tail): equal to
    ``ntt_fwd(fbc_apply(u, fbc, correct=True, premul=False), t, to_mont)``.
    u: int32 [..., A, N] source planes already carrying P̂⁻¹."""
    if not cuda_lib.on_card(u, fbc.r, t.q):
        return ntt_fwd_fbc_plain(u, fbc, t, to_mont=to_mont)
    A = u.shape[-2]
    F = len(t.primes)
    cuda_lib.check_i32("ntt_fwd_fbc", u, fbc.phat_mod_r, fbc.phat_shoup,
                       fbc.ptot_mod_r, fbc.ptot_shoup, t.q)
    if fbc.phat_mod_r.shape != (A, F) or fbc.p_recip.dtype != torch.float32:
        raise ValueError(f"ntt_fwd_fbc: plan converts "
                         f"{tuple(fbc.phat_mod_r.shape)}, input has {A} "
                         f"source rows and tables {F} targets")
    logn = check_plane_shape("ntt_fwd_fbc", u, t.n, A)
    rows = u.numel() // (A * t.n)
    out = torch.empty((*u.shape[:-2], F, t.n), dtype=torch.int32,
                      device=u.device)
    if rows == 0:
        return out
    p = cuda_lib.ptr
    recip = fbc.p_recip.contiguous()
    cuda_lib.launch("ntt_fwd_fbc", "hetpu_ntt_fwd_fbc", u.device,
                    p(u), p(out), rows, A, F, logn, p(fbc.phat_mod_r),
                    p(fbc.phat_shoup), p(recip), p(fbc.ptot_mod_r),
                    p(fbc.ptot_shoup), p(t.fwd_w), p(t.fwd_w_shoup), p(t.q),
                    p(t.r) if to_mont else None)
    return out
