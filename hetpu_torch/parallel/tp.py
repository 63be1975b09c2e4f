"""Limb-axis (tensor-parallel) sharded key switching.

Counterpart of ``hetpu/parallel/tp.py`` (``build_tp_plan`` :119, the key
slices :265-300, ``_tp_kernel`` :303-383, ``tp_relinearize`` :393,
``tp_apply_galois`` :410, ``tp_rotate`` :430).  Each of the ``tp`` ranks
owns a contiguous slice of L/tp data limbs; the α special limbs are
replicated.  One key switch, on each rank:

  1. the INTT of the rank's limbs of the switched polynomial: the ``ntt``
     kernel with N⁻¹R⁻¹ and the digit-local D̂⁻¹ in its epilogue;
  2. the partial digit lift Σ_i y_i·D̂_i over the LOCAL sources to every
     key-basis target (plain PyTorch, as hetpu computes it outside any
     Pallas kernel), then ONE :func:`mod_all_reduce` of [J, R, N] — the
     only exchange;
  3. the rank's rows (its data limbs and the specials) through the
     forward ``ntt`` kernel; the digit-own rows come from the NTT-domain
     input (the evaluator's R⁻¹ shortcut);
  4. the key inner product against the rank's key slice (``inner_product``);
  5. the mod-down by P: the specials' INTT (``ntt`` with the P̂⁻¹ epilogue),
     then the conversion to the rank's data primes with the forward NTT
     and ×R fused (``ntt_fwd_fbc`` on the destination-sliced plan), the
     subtract and ×P⁻¹.

Every step reorders only modular additions, and the f32 α of step 5 is
the same fma chain as the single-rank conversion, so the result equals
``Evaluator.relinearize`` / ``apply_galois`` bit for bit (and hetpu's tp).
The rank's output limbs are gathered (``all_gather``), so each rank
returns the whole ciphertext.  Like hetpu's tp path, this one takes the
default (uncentered) lift and conversion whatever the evaluator's
``centered_fbc``.  Plans, per-rank constants and key slices are cached on
the context; the key-slice cache is an LRU of 32 entries.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..core import galois
from ..core.ciphertext import Ciphertext
from ..core.context import ModDownPlan
from ..core.evaluator import _mod_down
from ..core.ip_kernel import inner_product
from ..core.modular import mod_add, shoup_mul, u32
from ..core.ntt import NttTables, ntt_fwd, ntt_inv
from . import mod_all_reduce
from .peer import all_gather

_TP_KEY_CACHE_MAX = 32


@dataclass
class TpKeySwitchPlan:
    """Host-side plan of one (level, tp): the limb split and the masked
    digit-lift matrix C[j, i, r] = D̂_i mod q_r where i is in digit j and r
    outside it (the digit-own rows use the R⁻¹ shortcut)."""

    tp: int
    level: int
    L: int
    Lloc: int
    alpha: int
    J: int
    C: np.ndarray                # [J, L, R] uint32
    digit_of: np.ndarray         # [L] digit of each data limb


@dataclass(frozen=True)
class TpShard:
    """One rank's constants on its device."""

    lo: int
    hi: int
    t_loc: NttTables             # the rank's data primes
    dig_inv: torch.Tensor        # [Lloc, 1]
    rinv: torch.Tensor           # [Lloc, 1]
    rinv_shoup: torch.Tensor
    C: torch.Tensor              # [J, Lloc, R] (int32 bit patterns)
    q_R: torch.Tensor            # [R, 1] key-basis primes
    row_idx: torch.Tensor        # [Lloc+α] rows of the key basis kept
    t_rows: NttTables            # the rank's data primes + the specials
    mask: torch.Tensor           # [J, Lloc+α, 1] digit-own rows
    moddown: ModDownPlan         # specials → the rank's data primes


def build_tp_plan(ctx, level: int, tp: int) -> TpKeySwitchPlan:
    """Cached per (ctx, level, tp)."""
    cache = ctx.__dict__.setdefault("_tp_plans", {})
    key = (level, tp)
    if key not in cache:
        cache[key] = _build_tp_plan(ctx, level, tp)
    return cache[key]


def _build_tp_plan(ctx, level: int, tp: int) -> TpKeySwitchPlan:
    plan = ctx.keyswitch_plan(level)
    L = level + 1
    if L % tp:
        raise ValueError(f"L={L} data limbs not divisible by tp={tp}")
    J = plan.num_digits
    R = L + ctx.num_special
    dhat = u32(plan.dhat).cpu().numpy().astype(np.uint32)       # [L, R]
    C = np.zeros((J, L, R), dtype=np.uint32)
    digit_of = np.zeros(L, dtype=np.int64)
    for j, (lo, hi) in enumerate(plan.digit_bounds):
        digit_of[lo:hi] = j
        outside = np.ones(R, dtype=bool)
        outside[lo:hi] = False
        C[j, lo:hi] = np.where(outside, dhat[lo:hi], 0)
    return TpKeySwitchPlan(tp=tp, level=level, L=L, Lloc=L // tp,
                           alpha=ctx.num_special, J=J, C=C,
                           digit_of=digit_of)


def _tp_shard(ctx, level: int, tp: int, d: int) -> TpShard:
    """Rank d's constants, cached per (level, tp, d) on the context."""
    cache = ctx.__dict__.setdefault("_tp_consts", {})
    key = (level, tp, d)
    if key in cache:
        return cache[key]
    plan = build_tp_plan(ctx, level, tp)
    ks = ctx.keyswitch_plan(level)
    md = ks.moddown
    Lloc, alpha = plan.Lloc, plan.alpha
    lo, hi = d * Lloc, (d + 1) * Lloc
    specials = np.arange(ctx.num_data, ctx.num_data + alpha)
    mask = np.zeros((plan.J, Lloc + alpha, 1), dtype=bool)
    mask[plan.digit_of[lo:hi], np.arange(Lloc), 0] = True
    cut = lambda a: a[:, lo:hi].contiguous()
    fbc = replace(md.fbc, phat_mod_r=cut(md.fbc.phat_mod_r),
                  phat_shoup=cut(md.fbc.phat_shoup),
                  ptot_mod_r=md.fbc.ptot_mod_r[lo:hi].contiguous(),
                  ptot_shoup=md.fbc.ptot_shoup[lo:hi].contiguous(),
                  r=md.fbc.r[lo:hi].contiguous())
    t_loc = ctx.tables_full.slice(np.arange(lo, hi))
    shard = TpShard(
        lo=lo, hi=hi, t_loc=t_loc,
        dig_inv=ks.dig_inv[lo:hi].contiguous(),
        rinv=ks.rinv[lo:hi], rinv_shoup=ks.rinv_shoup[lo:hi],
        C=torch.from_numpy(plan.C[:, lo:hi].view(np.int32).copy()).to(
            ctx.device),
        q_R=ks.q,
        row_idx=torch.from_numpy(np.concatenate(
            [np.arange(lo, hi), np.arange(plan.L, plan.L + alpha)])).to(
                ctx.device),
        t_rows=ctx.tables_full.slice(np.concatenate(
            [np.arange(lo, hi), specials])),
        mask=torch.from_numpy(mask).to(ctx.device),
        moddown=replace(md, dst_tables=t_loc, fbc=fbc,
                        p_inv=md.p_inv[lo:hi].contiguous(),
                        p_inv_shoup=md.p_inv_shoup[lo:hi].contiguous()))
    cache[key] = shard
    return shard


def _tp_key_slices(ctx, ksk, level: int, tp: int, d: int):
    """Rank d's key slice [J, 2, Lloc+α, N] (and its Shoup half), cached by
    key identity (the cache holds the key, so its id is not reused);
    least recently used out beyond 32 entries."""
    cache = ctx.__dict__.setdefault("_tp_keys", {})
    key = (id(ksk), level, tp, d)
    hit = cache.get(key)
    if hit is not None and hit[0] is ksk:
        cache[key] = cache.pop(key)            # LRU touch
        return hit[1], hit[2]
    while len(cache) >= _TP_KEY_CACHE_MAX:
        cache.pop(next(iter(cache)))
    plan = build_tp_plan(ctx, level, tp)
    lo, hi = d * plan.Lloc, (d + 1) * plan.Lloc
    nd = ctx.num_data
    sel = lambda a: torch.cat([a[:plan.J, :, lo:hi], a[:plan.J, :, nd:]],
                              dim=2).contiguous()
    out = (ksk, sel(ksk.data), sel(ksk.shoup))
    cache[key] = out
    return out[1], out[2]


def _tp_call(sess, dpoly: torch.Tensor, c01: torch.Tensor, ksk, level: int,
             mesh, axis: str) -> torch.Tensor:
    """c01 + keyswitch(dpoly) on the limb-sharded basis; dpoly [..., L, N]
    and c01 [..., 2, L, N] global Montgomery-NTT (every rank passes the
    same); returns the gathered [..., 2, L, N]."""
    ctx = sess.ctx
    tp, d = mesh.shape[axis], mesh.axis_index(axis)
    sh = _tp_shard(ctx, level, tp, d)
    key_d, key_s = _tp_key_slices(ctx, ksk, level, tp, d)
    c2 = dpoly[..., sh.lo:sh.hi, :].contiguous()
    # 1. local INTT, D̂⁻¹ folded into the epilogue
    y = ntt_inv(c2, sh.t_loc, strip_mont=True, extra=sh.dig_inv)
    # 2. partial lift over the local sources, then the one exchange
    qR = u32(sh.q_R)
    part = None
    for i in range(y.shape[-2]):
        t = u32(y[..., i, None, None, :]) * u32(sh.C[:, i, :, None]) % qR
        part = t if part is None else (part + t) % qR
    part = mod_all_reduce(part.to(torch.int32), sh.q_R, mesh, axis)
    # 3. the rank's rows to the NTT domain; digit-own rows by R⁻¹
    rows = part.index_select(-2, sh.row_idx).contiguous()
    ext = ntt_fwd(rows, sh.t_rows)
    direct = shoup_mul(c2, sh.rinv, sh.rinv_shoup, sh.t_loc.q)
    pad = direct.new_zeros((*direct.shape[:-2], ctx.num_special,
                            direct.shape[-1]))
    direct = torch.cat([direct, pad], dim=-2).unsqueeze(-3)
    ext = torch.where(sh.mask, direct, ext).contiguous()
    # 4. key inner product on the rank's key slice
    acc = inner_product(ext, key_d, key_s, sh.t_rows.q)
    # 5. mod-down by P onto the rank's data primes
    p01 = _mod_down(acc, sh.moddown, ctx.num_special)
    out = mod_add(c01[..., sh.lo:sh.hi, :], p01, sh.t_loc.q)
    return all_gather(out.contiguous(), mesh, axis, dim=-2)


def tp_relinearize(sess, ct3: Ciphertext, mesh,
                   axis: str = "tp") -> Ciphertext:
    """Relinearize a 3-part ciphertext with the key basis sharded over
    ``mesh[axis]``; bit-identical to ``Evaluator.relinearize``."""
    if ct3.num_parts != 3:
        raise ValueError(
            f"tp_relinearize expects a 3-part ciphertext, got "
            f"{ct3.num_parts} parts (relinearize deferred chains with "
            "Evaluator.relinearize first)")
    out = _tp_call(sess, ct3.data[..., 2, :, :], ct3.data[..., :2, :, :],
                   sess.rk.key, ct3.level, mesh, axis)
    return Ciphertext(data=out, level=ct3.level, scale=ct3.scale)


def tp_apply_galois(sess, ct: Ciphertext, elt: int, mesh,
                    axis: str = "tp") -> Ciphertext:
    """Galois automorphism + key switch with the key basis sharded over
    ``mesh[axis]``: the tp form of ``Evaluator.apply_galois``, bit-exact.
    The permutation is a gather along N, local to every rank."""
    if ct.num_parts != 2:
        raise ValueError("tp_apply_galois expects a 2-part ciphertext")
    n = sess.ctx.params.poly_degree
    c0 = galois.apply(ct.data[..., 0, :, :], n, elt)
    c1 = galois.apply(ct.data[..., 1, :, :], n, elt)
    c01 = torch.stack([c0, torch.zeros_like(c1)], dim=-3)
    out = _tp_call(sess, c1, c01, sess.gk.key_for(elt), ct.level, mesh, axis)
    return Ciphertext(data=out, level=ct.level, scale=ct.scale)


def tp_rotate(sess, ct: Ciphertext, steps: int, mesh,
              axis: str = "tp") -> Ciphertext:
    """Slot rotation through :func:`tp_apply_galois` (exact key)."""
    n = sess.ctx.params.poly_degree
    steps = steps % (n // 2)
    if steps == 0:
        return ct
    return tp_apply_galois(sess, ct, galois.rotation_elt(n, steps), mesh,
                           axis)
