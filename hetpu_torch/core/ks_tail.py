"""The elementwise tails of the key switch's mod-down and of the rescale,
and the own-prime limbs of its digit decomposition.

Counterpart of the Shoup, Barrett and modular add/subtract steps of
hetpu's ``_relin_rescale_fused`` (``hetpu/core/evaluator.py:410``),
``_mod_down`` (``:455``) and ``_div_round_last`` (``:482``), which XLA
fuses into loops under the evaluator's ``jax.jit``.  Eager PyTorch would
make each Shoup product an int64 pass over device memory, so a CUDA
tensor launches the ``ks_tail`` kernel (``csrc/ks_tail.cu``, one template,
one entry point a function here) and a CPU tensor takes the function's
``*_plain`` twin, the reference's steps as written:

* :func:`tail_src` — the source limbs of the fused relin + rescale's
  divide, straight from the inner product and the ciphertext;
* :func:`tail_out` — its divide: (acc + c01·P − r)·(P·q_ℓ)⁻¹ over the
  remaining limbs, the sum never stored;
* :func:`sub_mul` — (x − r)·w, the divide of ``_mod_down`` and of
  ``_div_round_last``;
* :func:`lift_last` — ``_div_round_last``'s one-limb middle: the rounded
  last limb on every remaining prime;
* :func:`own_limbs` — the decompose's limbs on each digit's own primes
  (d·R⁻¹, hetpu's ``shoup_mul`` in ``_decompose``), stored at their
  places in the digits [..., J, R, N].

Per-limb constants are [L, 1] columns (as the context's plans hold them);
the kernel reads its operands' slices in place.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .modular import barrett_reduce_u32, mod_add, mod_sub, shoup_mul


# ----------------------------------------------------------------------
# the plain twins (the CPU path)
# ----------------------------------------------------------------------

def tail_src_plain(acc, ct, g, p_mod, p_mod_shoup, q):
    """acc [..., 2, L+k, N] (the inner product over the level's limbs and
    the k specials), ct [..., ≥2, L, N] (c01 = its parts 0, 1), the
    level's [L, 1] constants → [..., 2, g+k, N]: acc + c01·P on the last g
    data limbs, then acc's special limbs."""
    L = ct.shape[-2]
    s = slice(L - g, L)
    w = mod_add(acc[..., s, :],
                shoup_mul(ct[..., :2, s, :], p_mod[s], p_mod_shoup[s], q[s]),
                q[s])
    return torch.cat([w, acc[..., L:, :]], dim=-2)


def tail_out_plain(acc, ct, r, p_mod, p_mod_shoup, w, w_shoup, q):
    """(acc + c01·P − r)·w over the first Lo = r.shape[-2] limbs: acc and
    ct as :func:`tail_src_plain`, r [..., 2, Lo, N], w and its companion
    [Lo, 1], p_mod and q the level's [L, 1]."""
    s = slice(0, r.shape[-2])
    qs = q[s]
    a = mod_add(acc[..., s, :],
                shoup_mul(ct[..., :2, s, :], p_mod[s], p_mod_shoup[s], qs),
                qs)
    return shoup_mul(mod_sub(a, r, qs), w, w_shoup, qs)


def sub_mul_plain(x, r, w, w_shoup, q):
    """(x − r)·w mod q over x's first Lo = r.shape[-2] limbs: x [..., m, N],
    r [..., Lo, N], the constants [Lo, 1]."""
    return shoup_mul(mod_sub(x[..., : r.shape[-2], :], r, q), w, w_shoup, q)


def lift_last_plain(last, half, q_src, q, mu, half_mod):
    """last [..., 1, N] (standard form mod q_src) → [..., Lo, N]:
    ((last + half) mod q_src mod q_l − half mod q_l) mod q_l, with half =
    q_src >> 1 and q_src [1, 1], the others [Lo, 1]."""
    v = barrett_reduce_u32(mod_add(last, half, q_src), q, mu)
    return mod_sub(v, half_mod, q)


def own_limbs_plain(d, out, out_rows, w, w_shoup, q):
    """d [..., L, N], out [..., M, N], out_rows a
    :class:`.cuda_lib.RowMap` of L rows into M limbs, the constants [L, 1]:
    out[..., out_rows.rows[l], :] = d[..., l, :]·w_l mod q_l, in place;
    returns out."""
    cuda_lib.check_map("own_limbs", out, out_rows, d.shape[:-2],
                       d.shape[-2], d.shape[-1], d.device)
    return out.index_copy_(-2, out_rows.rows.to(torch.int64),
                           shoup_mul(d, w, w_shoup, q))


# ----------------------------------------------------------------------
# the kernel's entry points
# ----------------------------------------------------------------------

def _check(name, *tensors):
    cuda_lib.check_i32(name, *tensors)
    n = tensors[0].shape[-1]
    if n % 4:
        raise ValueError(f"{name}: N = {n} is not a multiple of 4")


def _consts(name, n, *cols):
    out = []
    for c in cols:
        c = c.contiguous()
        if c.numel() != n or c.dtype != torch.int32:
            raise ValueError(f"{name}: constant {tuple(c.shape)} "
                             f"{c.dtype}, expected {n} int32")
        out.append(c)
    return out


def _pair(name, acc, ct):
    """acc [..., 2, R, N] and ct [..., parts, L, N] with the same leading
    axes, both contiguous: (acc, ct, L, R)."""
    acc, ct = acc.contiguous(), ct.contiguous()
    _check(name, acc, ct)
    if acc.dim() < 3 or ct.dim() != acc.dim() or acc.shape[-3] != 2 \
            or ct.shape[-3] < 2 or acc.shape[:-3] != ct.shape[:-3] \
            or acc.shape[-1] != ct.shape[-1] \
            or acc.shape[-2] < ct.shape[-2]:
        raise ValueError(f"{name}: acc {tuple(acc.shape)} and ct "
                         f"{tuple(ct.shape)} do not match")
    return acc, ct, ct.shape[-2], acc.shape[-2]


def tail_src(acc, ct, g, p_mod, p_mod_shoup, q):
    """:func:`tail_src_plain`'s function; ``ks_tail`` on a CUDA tensor."""
    if not cuda_lib.on_card(acc, ct, p_mod, p_mod_shoup, q):
        return tail_src_plain(acc, ct, g, p_mod, p_mod_shoup, q)
    acc, ct, L, R = _pair("tail_src", acc, ct)
    if not 1 <= g <= L:
        raise ValueError(f"tail_src: g = {g} of {L} limbs")
    cq, pm, pms = _consts("tail_src", g, q[L - g: L], p_mod[L - g: L],
                          p_mod_shoup[L - g: L])
    Lo, N = R - L + g, acc.shape[-1]
    out = torch.empty((*acc.shape[:-2], Lo, N), dtype=torch.int32,
                      device=acc.device)
    rows = out.numel() // (Lo * N)
    if rows:
        cuda_lib.check_aligned("tail_src", acc, ct, out)
        p = cuda_lib.ptr
        cuda_lib.launch("ks_tail", "hetpu_ks_tail_src", acc.device,
                        p(acc), 2, R, p(ct), ct.shape[-3], L, p(out), rows,
                        2, Lo, g, L - g, N, p(cq), p(pm), p(pms),
                        nbytes=cuda_lib.plane_bytes(N, rows * Lo, rows * g,
                                                    rows * Lo))
    return out


def tail_out(acc, ct, r, p_mod, p_mod_shoup, w, w_shoup, q):
    """:func:`tail_out_plain`'s function; ``ks_tail`` on a CUDA tensor."""
    if not cuda_lib.on_card(acc, ct, r, p_mod, p_mod_shoup, w, w_shoup, q):
        return tail_out_plain(acc, ct, r, p_mod, p_mod_shoup, w, w_shoup, q)
    acc, ct, L, R = _pair("tail_out", acc, ct)
    r = r.contiguous()
    _check("tail_out", r)
    Lo, N = r.shape[-2], r.shape[-1]
    if r.shape[:-2] != acc.shape[:-2] or not 1 <= Lo <= L:
        raise ValueError(f"tail_out: r {tuple(r.shape)} does not match acc "
                         f"{tuple(acc.shape)}")
    cq, pm, pms, cw, cws = _consts("tail_out", Lo, q[:Lo], p_mod[:Lo],
                                   p_mod_shoup[:Lo], w, w_shoup)
    out = torch.empty_like(r)
    rows = out.numel() // (Lo * N)
    if rows:
        cuda_lib.check_aligned("tail_out", acc, ct, r, out)
        p = cuda_lib.ptr
        cuda_lib.launch("ks_tail", "hetpu_ks_tail_out", acc.device,
                        p(acc), 2, R, p(ct), ct.shape[-3], L, p(r), p(out),
                        rows, 2, Lo, N, p(cq), p(pm), p(pms), p(cw), p(cws),
                        nbytes=cuda_lib.plane_bytes(N, *[rows * Lo] * 4))
    return out


def sub_mul(x, r, w, w_shoup, q):
    """:func:`sub_mul_plain`'s function; ``ks_tail`` on a CUDA tensor."""
    if not cuda_lib.on_card(x, r, w, w_shoup, q):
        return sub_mul_plain(x, r, w, w_shoup, q)
    x, r = x.contiguous(), r.contiguous()
    _check("sub_mul", x, r)
    m, (Lo, N) = x.shape[-2], r.shape[-2:]
    if x.shape[:-2] != r.shape[:-2] or x.shape[-1] != N or Lo > m:
        raise ValueError(f"sub_mul: x {tuple(x.shape)} and r "
                         f"{tuple(r.shape)} do not match")
    cq, cw, cws = _consts("sub_mul", Lo, q, w, w_shoup)
    out = torch.empty_like(r)
    rows = out.numel() // (Lo * N)
    if rows:
        cuda_lib.check_aligned("sub_mul", x, r, out)
        p = cuda_lib.ptr
        cuda_lib.launch("ks_tail", "hetpu_ks_tail_sub_mul", x.device, p(x),
                        m, p(r), p(out), rows, Lo, N, p(cq), p(cw), p(cws),
                        nbytes=cuda_lib.plane_bytes(N, *[rows * Lo] * 3))
    return out


def lift_last(last, half, q_src, q, mu, half_mod):
    """:func:`lift_last_plain`'s function; ``ks_tail`` on a CUDA tensor."""
    if not cuda_lib.on_card(last, half, q_src, q, mu, half_mod):
        return lift_last_plain(last, half, q_src, q, mu, half_mod)
    last = last.contiguous()
    _check("lift_last", last)
    if last.dim() < 2 or last.shape[-2] != 1:
        raise ValueError(f"lift_last: last {tuple(last.shape)} is not "
                         f"[..., 1, N]")
    Lo, N = q.numel(), last.shape[-1]
    ch, cs = _consts("lift_last", 1, half, q_src)
    cq, cmu, chm = _consts("lift_last", Lo, q, mu, half_mod)
    out = torch.empty((*last.shape[:-2], Lo, N), dtype=torch.int32,
                      device=last.device)
    rows = last.numel() // N
    if rows:
        cuda_lib.check_aligned("lift_last", last, out)
        p = cuda_lib.ptr
        cuda_lib.launch("ks_tail", "hetpu_ks_tail_lift_last", last.device,
                        p(last), p(out), rows, Lo, N, p(ch), p(cs), p(cq),
                        p(cmu), p(chm),
                        nbytes=cuda_lib.plane_bytes(N, rows, rows * Lo))
    return out


def own_limbs(d, out, out_rows, w, w_shoup, q):
    """:func:`own_limbs_plain`'s function; ``ks_tail`` on a CUDA tensor,
    which reads d where it lies (rows one stride apart,
    :func:`.cuda_lib.row_stride`) and writes only out's limbs
    ``out_rows.rows``."""
    if not cuda_lib.on_card(d, out, w, w_shoup, q):
        return own_limbs_plain(d, out, out_rows, w, w_shoup, q)
    stride = cuda_lib.check_rows("own_limbs", d)
    L, N = d.shape[-2:]
    M = cuda_lib.check_map("own_limbs", out, out_rows, d.shape[:-2], L, N,
                           d.device)
    _check("own_limbs", out)
    cq, cw, cws = _consts("own_limbs", L, q, w, w_shoup)
    rows = d.numel() // (L * N)
    if rows:
        cuda_lib.check_aligned("own_limbs", d, out)
        p = cuda_lib.ptr
        cuda_lib.launch("ks_tail", "hetpu_ks_tail_own_limbs", d.device,
                        p(d), stride, p(out), rows, L, N, p(out_rows.rows), M,
                        p(cq), p(cw), p(cws),
                        nbytes=cuda_lib.plane_bytes(N, rows * L, rows * L))
    return out


# ----------------------------------------------------------------------
# the kernel's arithmetic, step by step in int64 (the CPU tests hold it
# against the reference's 16-bit-emulated shoup_mul and Barrett)
# ----------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def _mullo(a, b):
    """a·b mod 2^32 of values < 2^32 without leaving int64."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & _MASK32


def _mulhi(a, b):
    """⌊a·b / 2^32⌋ of values < 2^32 without leaving int64."""
    return ((a >> 16) * b + (((a & 0xFFFF) * b) >> 16)) >> 16


def shoup_u32(x, w, w_shoup, q):
    """x·w mod q as ``csrc/ntt_common.cuh`` ``shoup_mul`` computes it:
    q̂ = hi(x·w′), r = x·w − q̂·q mod 2^32 (in [0, 2q)), r = min(r, r − q
    mod 2^32).  int64 tensors of values < 2^32 in, int64 out."""
    r = (_mullo(x, w) - _mullo(_mulhi(x, w_shoup), q)) & _MASK32
    return torch.minimum(r, (r - q) & _MASK32)


def barrett_u32(x, q, mu):
    """x mod q as ``csrc/ks_tail.cu`` ``barrett`` computes it:
    r = x − hi(x·μ)·q mod 2^32 (in [0, 2q)), r = min(r, r − q mod 2^32)."""
    r = (x - _mullo(_mulhi(x, mu), q)) & _MASK32
    return torch.minimum(r, (r - q) & _MASK32)
