"""Fused NTT entry points of the key-switch path.

Counterpart of the public API of ``hetpu/core/mxu_ntt.py`` (``ntt_fwd``
``:802``, ``ntt_fwd_lifted`` ``:919``, ``ntt_fwd_fbc`` ``:962``,
``ntt_inv`` ``:1000``) with the same signatures, and of hetpu's centered
path (``mxu_fbc`` then the forward NTT, ``HETPU_MXU_FBC=1``).  The JAX
package computes these on the TPU's matrix unit with int8 digit matrices;
there is no such unit here, hence the new name.  The transforms are the
flat ones of :mod:`.ntt`; the fused prologues run in CUDA kernels
(``csrc/fused_ntt.cu``) as the first pass's column loader of the
register passes of the ``ntt`` kernel (:mod:`.ntt_passes`), so the
lifted / converted planes never travel through device memory and each
CTA of a cluster builds only the columns its threads hold:

  * ``ntt_fwd_lifted`` — kernel ``ntt_fwd_lifted``: key-switch digit lift
    Σ_{i<α} y[dig_f·α+i]·lift_w[f,i] mod q_f, then the forward NTT;
  * ``ntt_fwd_fbc`` — kernel ``ntt_fwd_fbc``: centered fast base
    conversion (f32 α, see :mod:`.rns`), then the forward NTT ×R;
  * ``ntt_fwd_centered_lift`` / ``ntt_fwd_centered_fbc`` — kernel
    ``ntt_fwd_centered``: the same on CENTERED source values
    (:mod:`.centered_fbc`), the lift of every digit in one launch, the
    conversion with a signed α.

Every wrapper checks dtype and contiguity on either device; then a CPU
tensor takes the plain twin (``*_plain``) and a CUDA tensor launches the
kernel or raises.  The two lifts take an optional ``out`` [..., M, N] and
``out_rows`` (a :class:`.cuda_lib.RowMap` of F rows into M limbs): output
row f is then stored at limb ``out_rows.rows[f]`` of ``out``'s row, so the
evaluator's key-switch digits [..., J, R, N] are built in place
(``KeySwitchPlan.ext_row``).
"""

from __future__ import annotations

import torch

from . import centered_fbc, cuda_lib, rns
from .modular import add_i64, u32
from .ntt import NttTables, check_plane_shape, ntt_fwd, ntt_fwd_plain, ntt_inv

__all__ = ["ntt_fwd", "ntt_inv", "ntt_fwd_lifted", "ntt_fwd_lifted_plain",
           "ntt_fwd_fbc", "ntt_fwd_fbc_plain", "ntt_fwd_centered_lift",
           "ntt_fwd_centered_lift_plain", "ntt_fwd_centered_fbc",
           "ntt_fwd_centered_fbc_plain"]


# ----------------------------------------------------------------------
# digit lift + forward NTT
# ----------------------------------------------------------------------

def _lift_index(lift_dig: torch.Tensor, A: int, Ly: int) -> torch.Tensor:
    """[F, A] source plane of each lift term: dig_f·α+i, clamped to the
    last plane (the padded terms of a short digit have lift_w = 0)."""
    idx = lift_dig.to(torch.int64)[:, None] * A + torch.arange(
        A, device=lift_dig.device)[None, :]
    return idx.clamp(max=Ly - 1)


def _lift_plain(y, lift_w, lift_dig, q_src, t: NttTables, *,
                to_mont: bool) -> torch.Tensor:
    """Σ_i v(y[..., dig_f·α+i, :])·lift_w[f, i] mod q_f, then the flat
    forward NTT; v(y) = y, or with ``q_src`` (the prime of each source
    plane) the centered y − q_s when y > q_s/2."""
    F, A = lift_w.shape
    Ly, N = y.shape[-2:]
    idx = _lift_index(lift_dig, A, Ly)
    yg = u32(y.index_select(-2, idx.reshape(-1)))
    yg = yg.reshape(*y.shape[:-2], F, A, N)
    if q_src is not None:
        qs = u32(q_src).reshape(-1)[idx][..., None]           # [F, A, 1]
        yg = torch.where(yg > qs // 2, yg - qs, yg)
    q = u32(t.q)                                           # [F, 1]
    acc = None
    for i in range(A):
        term = yg[..., :, i, :] * u32(lift_w[:, i: i + 1]) % q
        acc = term if acc is None else add_i64(acc, term, q)
    return ntt_fwd_plain(acc.to(torch.int32), t, to_mont=to_mont)


def _placed(res, out, out_rows):
    """``res`` [..., F, N], or ``out`` with row f of ``res`` at limb
    ``out_rows.rows[f]`` (the plain twins' store, ``index_copy_``)."""
    if out is None and out_rows is None:
        return res
    cuda_lib.check_map("lift", out, out_rows, res.shape[:-2],
                       res.shape[-2], res.shape[-1], res.device)
    return out.index_copy_(-2, out_rows.rows.to(torch.int64), res)


def _out_limbs(name, y, F, n, out, out_rows) -> int:
    """The limbs M of an output row: F without ``out``, else ``out``'s
    [..., M, N] (y's leading axes) that ``out_rows`` maps F rows into."""
    if out is None and out_rows is None:
        return F
    return cuda_lib.check_map(name, out, out_rows, y.shape[:-2], F, n,
                              y.device)


def _rows(out_rows):
    return None if out_rows is None else out_rows.rows


def _new_out(y, F, n, out):
    return out if out is not None else torch.empty(
        (*y.shape[:-2], F, n), dtype=torch.int32, device=y.device)


def ntt_fwd_lifted_plain(y, lift_w, lift_ws, lift_dig, t: NttTables, *,
                         to_mont: bool = False, out=None,
                         out_rows=None) -> torch.Tensor:
    """Plain twin of the ``ntt_fwd_lifted`` kernel: y int32 [..., Ly, N]
    standard-form planes → [..., F, N] over the foreign basis ``t`` (or
    into ``out`` at ``out_rows``)."""
    return _placed(_lift_plain(y, lift_w, lift_dig, None, t,
                               to_mont=to_mont), out, out_rows)


def ntt_fwd_lifted(y, lift_w, lift_ws, lift_dig, t: NttTables, *,
                   to_mont: bool = False, out=None,
                   out_rows=None) -> torch.Tensor:
    """Fused digit lift + forward NTT over the concatenated-foreign key
    basis: out[..., f, :] = ntt_fwd(Σ_i y[..., dig_f·α+i, :]·lift_w[f, i])
    row f, in one launch of all planes (a plane over
    :func:`ntt_passes.cluster_size` CTAs, fixed by N).  y: [..., Ly, N]
    standard-form planes (the decompose INTT output); lift_w/lift_ws
    [F, α]; lift_dig int32 [F].  With ``out`` [..., M, N] and ``out_rows``
    (a :class:`.cuda_lib.RowMap` of F rows into M limbs), row f is stored
    at limb ``out_rows.rows[f]`` of ``out`` and ``out`` is returned."""
    cuda_lib.check_i32("ntt_fwd_lifted", y, lift_w, lift_ws, lift_dig, t.q)
    F, A = lift_w.shape
    M = _out_limbs("ntt_fwd_lifted", y, F, t.n, out, out_rows)
    if not cuda_lib.on_card(y, lift_w, lift_ws, lift_dig, t.q):
        return ntt_fwd_lifted_plain(y, lift_w, lift_ws, lift_dig, t,
                                    to_mont=to_mont, out=out,
                                    out_rows=out_rows)
    if len(t.primes) != F or lift_ws.shape != lift_w.shape \
            or lift_dig.shape != (F,):
        raise ValueError("ntt_fwd_lifted: lift_w/lift_ws [F, A], lift_dig "
                         "[F] and tables of F primes expected")
    Ly = y.shape[-2]
    logn = check_plane_shape("ntt_fwd_lifted", y, t.n, Ly)
    rows = y.numel() // (Ly * t.n)
    out = _new_out(y, F, t.n, out)
    cuda_lib.check_aligned("ntt_fwd_lifted", out)
    if rows == 0:
        return out
    p = cuda_lib.ptr
    cuda_lib.launch("ntt_fwd_lifted", "hetpu_ntt_fwd_lifted", y.device,
                    p(y), p(out), rows, Ly, F, A, logn, p(lift_w), p(lift_ws),
                    p(lift_dig), p(t.fwd_pass_w), p(t.fwd_pass_w_shoup),
                    p(t.q), p(t.r) if to_mont else None,
                    p(_rows(out_rows)), M,
                    nbytes=cuda_lib.plane_bytes(t.n, rows * Ly, rows * F))
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
    cuda_lib.check_i32("ntt_fwd_fbc", u, fbc.phat_mod_r, fbc.phat_shoup,
                       fbc.ptot_mod_r, fbc.ptot_shoup, t.q)
    if not cuda_lib.on_card(u, fbc.r, t.q):
        return ntt_fwd_fbc_plain(u, fbc, t, to_mont=to_mont)
    return _fbc_cuda(u, fbc, t, to_mont=to_mont)


def _fbc_cuda(u, fbc: rns.FbcPlan, t: NttTables, *,
              to_mont: bool) -> torch.Tensor:
    """Launch the ``ntt_fwd_fbc`` kernel (an output plane over
    :func:`ntt_passes.cluster_size` CTAs, fixed by N)."""
    A = u.shape[-2]
    F = len(t.primes)
    if fbc.phat_mod_r.shape != (A, F) or fbc.p_recip.dtype != torch.float32:
        raise ValueError(f"ntt_fwd_fbc: plan converts "
                         f"{tuple(fbc.phat_mod_r.shape)}, input has {A} "
                         f"source rows and tables {F} targets")
    logn = check_plane_shape("ntt_fwd_fbc", u, t.n, A)
    rows = u.numel() // (A * t.n)
    out = torch.empty((*u.shape[:-2], F, t.n), dtype=torch.int32,
                      device=u.device)
    cuda_lib.check_aligned("ntt_fwd_fbc", out)
    if rows == 0:
        return out
    p = cuda_lib.ptr
    recip = fbc.p_recip.contiguous()
    cuda_lib.launch("ntt_fwd_fbc", "hetpu_ntt_fwd_fbc", u.device,
                    p(u), p(out), rows, A, F, logn, p(fbc.phat_mod_r),
                    p(fbc.phat_shoup), p(recip), p(fbc.ptot_mod_r),
                    p(fbc.ptot_shoup), p(t.fwd_pass_w),
                    p(t.fwd_pass_w_shoup), p(t.q),
                    p(t.r) if to_mont else None,
                    nbytes=cuda_lib.plane_bytes(t.n, rows * A, rows * F))
    return out


# ----------------------------------------------------------------------
# centered digit lift / centered FBC + forward NTT (K5's path form)
# ----------------------------------------------------------------------

def ntt_fwd_centered_lift_plain(y, lift_w, lift_ws, lift_dig, q_src,
                                t: NttTables, *, to_mont: bool = False,
                                out=None, out_rows=None) -> torch.Tensor:
    """Plain twin of :func:`ntt_fwd_centered_lift`: the signed sum of the
    centered source values, then the flat forward NTT."""
    return _placed(_lift_plain(y, lift_w, lift_dig, q_src, t,
                               to_mont=to_mont), out, out_rows)


def ntt_fwd_centered_lift(y, lift_w, lift_ws, lift_dig, q_src,
                          t: NttTables, *, to_mont: bool = False, out=None,
                          out_rows=None) -> torch.Tensor:
    """Centered digit lift of every digit + forward NTT over the
    concatenated-foreign key basis ``t``, one ``ntt_fwd_centered``
    launch: :func:`ntt_fwd_lifted` with each source residue y taken as
    y − q_s when y > q_s/2.  ``q_src`` int32 [Ly] or [Ly, 1]: the prime of
    each source plane.  With a key-switch plan's ``lift_w`` / ``lift_ws``
    / ``lift_dig`` (the transposed C of the digits' centered lift plans)
    this equals ``ntt_fwd(cat_d(lift_plan(ks, d).apply(y[..., lo_d:hi_d,
    :])), t)``; ``out`` and ``out_rows`` as :func:`ntt_fwd_lifted`'s."""
    cuda_lib.check_i32("ntt_fwd_centered", y, lift_w, lift_ws, lift_dig,
                       q_src)
    Ly = y.shape[-2] if y.dim() >= 2 else -1
    if q_src.numel() != Ly:
        raise ValueError(f"ntt_fwd_centered: shape {tuple(y.shape)} for "
                         f"{q_src.numel()} source primes")
    F, A = lift_w.shape
    M = _out_limbs("ntt_fwd_centered", y, F, t.n, out, out_rows)
    if not cuda_lib.on_card(y, lift_w, lift_ws, lift_dig, q_src, t.q):
        return ntt_fwd_centered_lift_plain(y, lift_w, lift_ws, lift_dig,
                                           q_src, t, to_mont=to_mont,
                                           out=out, out_rows=out_rows)
    if len(t.primes) != F or lift_ws.shape != lift_w.shape \
            or lift_dig.shape != (F,):
        raise ValueError("ntt_fwd_centered: lift_w/lift_ws [F, A], lift_dig "
                         "[F] and tables of F primes expected")
    return _centered_cuda(y, t, A, lift_w, lift_ws, (A, 1), lift_dig, q_src,
                          (None,) * 3, to_mont, out, M, out_rows)


def ntt_fwd_centered_fbc_plain(u, plan: centered_fbc.CenteredFbcPlan,
                               t: NttTables, *,
                               to_mont: bool = True) -> torch.Tensor:
    """Plain twin of :func:`ntt_fwd_centered_fbc`."""
    return ntt_fwd_plain(plan.apply_plain(u), t, to_mont=to_mont)


def ntt_fwd_centered_fbc(u, plan: centered_fbc.CenteredFbcPlan,
                         t: NttTables, *, to_mont: bool = True) -> torch.Tensor:
    """Centered fast base conversion + forward NTT (the centered mod-down
    and fused-rescale tail), one ``ntt_fwd_centered`` launch: equal to
    ``ntt_fwd(plan.apply(u), t, to_mont=to_mont)``.  u: int32 [..., S, N];
    ``t`` the tables of the plan's F destination primes.  A plan with a
    folded ``extra`` is refused (no path builds one)."""
    cuda_lib.check_i32("ntt_fwd_centered", u)
    if plan.has_extra:
        raise ValueError("ntt_fwd_centered: a plan with extra is not fused")
    if u.dim() < 2 or u.shape[-2] != plan.S or len(t.primes) != plan.F:
        raise ValueError(f"ntt_fwd_centered: shape {tuple(u.shape)} and "
                         f"{len(t.primes)} tables for a plan of "
                         f"{plan.S} → {plan.F} primes")
    if not cuda_lib.on_card(u, plan.q_dst, t.q):
        return ntt_fwd_centered_fbc_plain(u, plan, t, to_mont=to_mont)
    alpha = ((plan.recip, plan.p_mod, plan.p_mod_shoup) if plan.has_alpha
             else (None,) * 3)
    return _centered_cuda(u, t, plan.S, plan.c, plan.c_shoup, (1, plan.F),
                          None, plan.q_src, alpha, to_mont, None, plan.F,
                          None)


def _centered_cuda(y, t: NttTables, A: int, w, ws, strides, dig, q_src,
                   alpha, to_mont: bool, out, M: int,
                   out_rows) -> torch.Tensor:
    """Launch the ``ntt_fwd_centered`` kernel into ``out`` (M limbs a row;
    row f at limb ``out_rows.rows[f]``; a new [..., F, N] without):
    W[f, i] at w[f·strides[0] + i·strides[1]]; source plane dig_f·A + i
    (i without ``dig``); ``alpha``: (recip, P mod q_f, its Shoup
    companions) of the α row, or three Nones."""
    F = len(t.primes)
    Ly = y.shape[-2]
    logn = check_plane_shape("ntt_fwd_centered", y, t.n, Ly)
    rows = y.numel() // (Ly * t.n)
    out = _new_out(y, F, t.n, out)
    cuda_lib.check_aligned("ntt_fwd_centered", out)
    if rows == 0:
        return out
    p = cuda_lib.ptr
    cuda_lib.launch("ntt_fwd_centered", "hetpu_ntt_fwd_centered", y.device,
                    p(y), p(out), rows, Ly, F, A, logn, p(w), p(ws),
                    *strides, p(dig), p(q_src), *map(p, alpha),
                    p(t.fwd_pass_w), p(t.fwd_pass_w_shoup), p(t.q),
                    p(t.r) if to_mont else None, p(_rows(out_rows)), M,
                    nbytes=cuda_lib.plane_bytes(t.n, rows * Ly, rows * F))
    return out
