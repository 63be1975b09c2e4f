"""The pass schedule of the ``ntt`` and ``ntt_fwd_fbc`` kernels.

The kernels (``csrc/ntt_passes.cuh``) run the negacyclic NTT of one
N = 2^logn plane as ⌈logn / 3⌉ register passes: each thread holds E = 8
residues and runs three butterfly stages on them in registers, and the
plane goes through shared memory only between passes.  A plane may be
split over a thread-block cluster of C CTAs (C ≤ 8), each holding N/C
residues, one thread per E of them; only the first pass of the forward
transform and the last of the inverse (the stages of stride ≥ N/8) read
or write another CTA's shared memory.  The kernels launch C =
:func:`cluster_size` (N); the schedule, and its plain twins, hold for any
C of :data:`CLUSTERS` with N/C ≥ :data:`MIN_CTA`.

Forward (Cooley-Tukey, natural → bit-reversed order):
  * pass 0: stages 0..2; thread v (of N/8) holds x[v + j·N/8], j < 8,
    read straight from device memory (K3: converted column by column);
  * pass p = 1..P-2: stages 3p..3p+2; group g of size 2^(logn-3p),
    t = 2^(logn-3p-3): thread v holds g·2^(logn-3p) + k + j·t with
    g = v // t, k = v % t;
  * pass P-1: the last ``odd_stages`` stages; thread v holds the eight
    contiguous residues 8v + j, stored with two 16-byte stores.
Inverse (Gentleman-Sande, bit-reversed → natural) mirrors it: pass 0 runs
the ``odd_stages`` stages of half 1, 2, .. on 8v + j (16-byte loads);
pass p ≥ 1 has half h0 = 2^(odd + 3(p-1)) and superblock G = v // h0:
thread v holds G·8h0 + k + j·h0; the last pass (h0 = N/8) writes each
x[v + j·N/8] to device memory.

Twiddles: every thread reads one record of E twiddles (and E Shoup
companions) a pass: the device-memory passes' records with 16-byte loads
issued with the plane's, the records of the passes in between copied into
shared memory (cp.async) at the start.  The table
of one limb is the flat ``fwd_w`` / ``inv_w`` of :mod:`.ntt` reordered
(:func:`fwd_table_index`, :func:`inv_table_index`): block b holds 8^b
records of E slots, the last block N/8 records; forward pass p < P-1
reads block p (record g), its last pass block P-1 (record v); inverse
pass p reads block P-1-p.  Sub-stage u of a pass of ``rp`` stages reads
slots [2^(3-rp+u), 2^(4-rp+u)) forward, [2^(2-u), 2^(3-u)) inverse.

Shared memory holds local residue i at :func:`swizzle` (i): a XOR of
bits 3..7 into bits 0..4, which keeps every pass's accesses free of bank
conflicts.

The plain twins (:func:`ntt_fwd_passes_plain`, :func:`ntt_inv_passes_plain`,
:func:`ntt_fwd_fbc_passes_plain`, :func:`ntt_fwd_lifted_passes_plain`,
:func:`ntt_fwd_centered_passes_plain`) walk the reordered table pass by
pass and cluster rank by rank exactly as the kernels index it, the fused
kernels' prologue (``csrc/fused_ntt.cu`` ``LiftLoad``) building pass 0's
columns; the tests hold them against the flat transforms.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from .modular import add_i64, sub_i64, u32
from .rns import fma_f32

if TYPE_CHECKING:
    from .ntt import NttTables
    from .rns import FbcPlan

LOG_E = 3
E = 1 << LOG_E                 # residues a thread holds
CLUSTERS = (1, 2, 4, 8)        # CTAs the schedule may split a plane over
MIN_CTA = 256                  # residues a CTA holds at least: 32 threads


def passes(logn: int) -> int:
    return -(-logn // LOG_E)


def odd_stages(logn: int) -> int:
    """Stages of the forward transform's last pass (the inverse's first)."""
    return logn - LOG_E * (passes(logn) - 1)


def block_offset(b: int) -> int:
    """First slot of table block b (blocks of 8^b' records before it)."""
    return E * (8 ** b - 1) // 7


def table_size(logn: int) -> int:
    return block_offset(passes(logn) - 1) + (1 << logn)


def swizzle(i):
    """Shared-memory slot of local residue i (int or integer tensor)."""
    return i ^ ((i >> LOG_E) & 31)


def cluster_size(logn: int) -> int:
    """CTAs a plane that the kernels launch (``cluster_ctas`` of
    ``csrc/ntt_passes.cuh``, the same rule): as many as keep 64 threads a
    CTA, at most 8, so C = 2, 4, 8 at logn 10, 11, ≥ 12.  Smaller CTAs pack
    the SMs more finely; C = 8 was the fastest at every plane count of the
    bench_n14 path, 16 to 288 (PERF.md)."""
    return min(CLUSTERS[-1], (1 << logn) // (E * 64))


# ----------------------------------------------------------------------
# reordered twiddle tables (index into the flat [L, N] tables)
# ----------------------------------------------------------------------

_LG = np.array([0] + [h.bit_length() - 1 for h in range(1, E)])
_H = np.arange(E)


def fwd_table_index(logn: int) -> np.ndarray:
    """[table_size] flat ``fwd_w`` index of every slot (0 where unused)."""
    n = 1 << logn
    P, rl = passes(logn), odd_stages(logn)
    idx = np.zeros(table_size(logn), np.int64)
    for p in range(P - 1):                 # full passes: record g of 8^p
        s = LOG_E * p
        g = np.arange(8 ** p)[:, None]
        u = _LG[None, 1:]
        rec = (1 << (s + u)) + g * (1 << u) + (_H[None, 1:] - (1 << u))
        off = block_offset(p)
        idx[off: off + rec.shape[0] * E].reshape(-1, E)[:, 1:] = rec
    s, lo = logn - rl, 1 << (LOG_E - rl)    # last pass: record v of N/8
    v = np.arange(n // E)[:, None]
    u = _LG[None, lo:] - (LOG_E - rl)
    base = 1 << (LOG_E - rl + u)
    rec = (1 << (s + u)) + v * base + (_H[None, lo:] - base)
    idx[block_offset(P - 1):].reshape(-1, E)[:, lo:] = rec
    return idx


def inv_table_index(logn: int) -> np.ndarray:
    """[table_size] flat ``inv_w`` index of every slot (0 where unused)."""
    n = 1 << logn
    P, rf = passes(logn), odd_stages(logn)
    idx = np.zeros(table_size(logn), np.int64)

    def fill(b, count, lo, lh0):
        u = (LOG_E - 1) - _LG[None, lo:]
        base = 1 << (LOG_E - 1 - u)
        rec = (n >> (lh0 + 1 + u)) + np.arange(count)[:, None] * base \
            + (_H[None, lo:] - base)
        off = block_offset(b)
        idx[off: off + count * E].reshape(-1, E)[:, lo:] = rec

    fill(P - 1, n // E, 1 << (LOG_E - rf), 0)          # pass 0, half 1..
    for p in range(1, P):                               # full passes
        fill(P - 1 - p, 8 ** (P - 1 - p), 1, rf + LOG_E * (p - 1))
    return idx


# ----------------------------------------------------------------------
# plain twins of the kernels' pass schedule
# ----------------------------------------------------------------------

def _fwd_regs(x: torch.Tensor, tw: torch.Tensor, rp: int, q) -> torch.Tensor:
    """``rp`` Cooley-Tukey stages on the E residues of each thread
    (x [..., V, E] int64, tw [L, V, E] its records)."""
    x = list(x.unbind(-1))
    for u in range(rp):
        hb = rp - 1 - u
        for j in range(E):
            if (j >> hb) & 1:
                continue
            w = tw[..., (1 << (LOG_E - rp + u)) + (j >> (hb + 1))]
            a, b = x[j], x[j + (1 << hb)] * w % q
            x[j], x[j + (1 << hb)] = add_i64(a, b, q), sub_i64(a, b, q)
    return torch.stack(x, -1)


def _inv_regs(x: torch.Tensor, tw: torch.Tensor, rp: int, q) -> torch.Tensor:
    """``rp`` Gentleman-Sande stages of half 1, 2, .. in registers."""
    x = list(x.unbind(-1))
    for u in range(rp):
        for j in range(E):
            if (j >> u) & 1:
                continue
            w = tw[..., (1 << (LOG_E - 1 - u)) + (j >> (u + 1))]
            a, b = x[j], x[j + (1 << u)]
            x[j], x[j + (1 << u)] = add_i64(a, b, q), sub_i64(a, b, q) * w % q
    return torch.stack(x, -1)


def _check(n: int, cluster: int) -> tuple[int, int, int]:
    logn = n.bit_length() - 1
    if cluster not in CLUSTERS or n // cluster < MIN_CTA:
        raise ValueError(f"cluster {cluster}: the schedule splits a plane "
                         f"over C in {CLUSTERS} CTAs of ≥ {MIN_CTA} residues")
    m = n // cluster
    return logn, m, m // E


def _records(tab: torch.Tensor, first, rec: torch.Tensor) -> torch.Tensor:
    """[L, V, E] records ``rec`` [V] of the table block starting at slot
    ``first``."""
    return tab[:, first + rec[:, None] * E + torch.arange(E)]


def _epilogue(x, c1, c2, q):
    if c1 is not None:
        x = x * u32(c1).reshape(-1, 1) % q
    if c2 is not None:
        x = x * u32(c2).reshape(-1, 1) % q
    return x


def ntt_fwd_passes_plain(a: torch.Tensor, t: "NttTables", *, cluster: int,
                         to_mont: bool = False, load=None) -> torch.Tensor:
    """The forward kernel's schedule: equal to ``ntt.ntt_fwd_plain``.
    ``load(idx)`` gives pass 0's residues [R, L, *idx.shape] for column
    indices ``idx`` (default: gathered from ``a``, int32 [..., L, N])."""
    n, L = t.n, len(t.primes)
    logn, m, vc = _check(n, cluster)
    P, rl = passes(logn), odd_stages(logn)
    q = u32(t.q)
    w = u32(t.fwd_pass_w)
    jj = torch.arange(E)
    if load is None:
        x = a.to(torch.int64).reshape(-1, L, n)
        load = lambda idx: x[:, :, idx]
    smem = None
    sw = swizzle(torch.arange(m))
    # pass 0: stages 0..2 from device memory into the owners' shared memory
    for c in range(cluster):
        v = c * vc + torch.arange(vc)
        idx = v[:, None] + jj * (n // E)
        r = _fwd_regs(load(idx), _records(w, 0, v * 0), LOG_E, q)
        if smem is None:
            smem = torch.zeros((r.shape[0], L, cluster, m), dtype=torch.int64)
        smem[:, :, idx // m, sw[idx % m]] = r
    for p in range(1, P - 1):                 # CTA-local full passes
        lb = logn - LOG_E * p
        lt = lb - LOG_E
        for c in range(cluster):
            v = c * vc + torch.arange(vc)
            g, k = v >> lt, v & ((1 << lt) - 1)
            pos = sw[((g << lb) + k - c * m)[:, None] + (jj << lt)]
            smem[:, :, c, pos] = _fwd_regs(
                smem[:, :, c, pos], _records(w, block_offset(p), g), LOG_E, q)
    out = torch.empty((smem.shape[0], L, n), dtype=torch.int64)
    for c in range(cluster):                  # last pass: 8 contiguous
        v = c * vc + torch.arange(vc)
        pos = sw[(torch.arange(vc) * E)[:, None] + jj]
        out[:, :, v[:, None] * E + jj] = _fwd_regs(
            smem[:, :, c, pos], _records(w, block_offset(P - 1), v), rl, q)
    out = _epilogue(out, t.r if to_mont else None, None, q)
    return out.reshape(*a.shape[:-2], L, n).to(torch.int32)


def ntt_inv_passes_plain(a: torch.Tensor, t: "NttTables", *, cluster: int,
                         strip_mont: bool = False, extra=None) -> torch.Tensor:
    """The inverse kernel's schedule: equal to ``ntt.ntt_inv_plain``."""
    n, L = t.n, len(t.primes)
    logn, m, vc = _check(n, cluster)
    P, rf = passes(logn), odd_stages(logn)
    q = u32(t.q)
    w = u32(t.inv_pass_w)
    jj = torch.arange(E)
    x = a.to(torch.int64).reshape(-1, L, n)
    smem = torch.zeros((x.shape[0], L, cluster, m), dtype=torch.int64)
    sw = swizzle(torch.arange(m))
    for c in range(cluster):                  # pass 0: 8 contiguous
        v = c * vc + torch.arange(vc)
        pos = sw[(torch.arange(vc) * E)[:, None] + jj]
        smem[:, :, c, pos] = _inv_regs(
            x[:, :, v[:, None] * E + jj],
            _records(w, block_offset(P - 1), v), rf, q)
    for p in range(1, P - 1):                 # CTA-local full passes
        lh0 = rf + LOG_E * (p - 1)
        for c in range(cluster):
            v = c * vc + torch.arange(vc)
            G, k = v >> lh0, v & ((1 << lh0) - 1)
            pos = sw[((G << (lh0 + LOG_E)) + k - c * m)[:, None]
                     + (jj << lh0)]
            smem[:, :, c, pos] = _inv_regs(
                smem[:, :, c, pos], _records(w, block_offset(P - 1 - p), G),
                LOG_E, q)
    out = torch.empty_like(x)
    for c in range(cluster):                  # last pass: the owners' smem
        v = c * vc + torch.arange(vc)
        idx = v[:, None] + jj * (n // E)
        out[:, :, idx] = _inv_regs(smem[:, :, idx // m, sw[idx % m]],
                                   _records(w, 0, v * 0), LOG_E, q)
    c1 = t.n_inv_rinv if strip_mont else t.n_inv
    out = _epilogue(out, c1, extra, q)
    return out.reshape(a.shape).to(torch.int32)


def ntt_fwd_fbc_passes_plain(u: torch.Tensor, fbc: "FbcPlan", t: "NttTables",
                             *, cluster: int,
                             to_mont: bool = True) -> torch.Tensor:
    """The ``ntt_fwd_fbc`` kernel's schedule: each CTA converts only the
    columns its threads hold in pass 0 (the default form with α of the
    fused kernels' loader); equal to ``fused_ntt.ntt_fwd_fbc_plain``."""
    return _lift_passes(u, fbc.phat_mod_r.T, t, cluster=cluster,
                        to_mont=to_mont, recip=fbc.p_recip,
                        p_mod=fbc.ptot_mod_r)


def _lift_passes(y: torch.Tensor, w: torch.Tensor, t: "NttTables", *,
                 cluster: int, to_mont: bool, dig=None, q_src=None,
                 recip=None, p_mod=None) -> torch.Tensor:
    """Forward passes whose pass 0 builds its columns as ``LiftLoad``:
    output plane f of a row is Σ_{i<A} w[f, i]·v(y[s]) − α·p_mod[f] mod
    q_f, source plane s = min(dig_f·A + i, Ly − 1) (dig_f = 0 without
    ``dig``); v(y) = y, or with ``q_src`` (the prime of each source plane)
    the centered y − q_s when y > q_s/2; with ``recip`` (f32 1/q of each
    plane) α = round(fma chain of f32(v)·recip over i ascending), signed.
    y: int32 [..., Ly, N]; w: [F, A]."""
    Ly, n = y.shape[-2:]
    F, A = w.shape
    yr = y.reshape(-1, Ly, n)
    src = (torch.zeros(F, dtype=torch.int64) if dig is None
           else dig.to(torch.int64) * A)
    s = (src[:, None] + torch.arange(A)).clamp(max=Ly - 1)      # [F, A]
    wt = u32(w)[..., None]
    q = u32(t.q).reshape(F, 1)

    def load(idx):
        cols = idx.reshape(-1)
        v = yr[:, :, cols].to(torch.int64)[:, s]                 # [R,F,A,M]
        if q_src is not None:
            qs = u32(q_src).reshape(-1)[s][..., None]
            v = torch.where(v > qs // 2, v - qs, v)
        x = (v * wt % q[..., None]).sum(-2) % q                  # [R,F,M]
        if recip is not None:
            rc = recip.reshape(-1)[s]                            # [F, A]
            al = torch.zeros(x.shape, dtype=torch.float32)
            for i in range(A):
                al = fma_f32(v[:, :, i].to(torch.int32).to(torch.float32),
                             rc[:, i: i + 1], al)
            alpha = torch.round(al).to(torch.int64)
            x = (x - alpha * u32(p_mod).reshape(F, 1)) % q
        return x.reshape(yr.shape[0], F, *idx.shape)

    out = ntt_fwd_passes_plain(
        torch.empty((yr.shape[0], F, n), dtype=torch.int32), t,
        cluster=cluster, to_mont=to_mont, load=load)
    return out.reshape(*y.shape[:-2], F, n)


def ntt_fwd_lifted_passes_plain(y: torch.Tensor, lift_w: torch.Tensor,
                                lift_dig: torch.Tensor, t: "NttTables", *,
                                cluster: int,
                                to_mont: bool = False) -> torch.Tensor:
    """The ``ntt_fwd_lifted`` kernel's schedule: pass 0 lifts the columns
    each thread holds (source planes dig_f·α + i, clamped); equal to
    ``fused_ntt.ntt_fwd_lifted_plain``."""
    return _lift_passes(y, lift_w, t, cluster=cluster, to_mont=to_mont,
                        dig=lift_dig)


def ntt_fwd_centered_passes_plain(y: torch.Tensor, w: torch.Tensor,
                                  t: "NttTables", *, cluster: int, q_src,
                                  dig=None, recip=None, p_mod=None,
                                  to_mont: bool = False) -> torch.Tensor:
    """The ``ntt_fwd_centered`` kernel's schedule, on its arguments: the
    centered lift (w = ``lift_w``, ``dig`` = ``lift_dig``, q_src the
    level's primes) or the centered conversion (w = C transposed to
    [F, S], q_src, recip and p_mod of a :class:`~.centered_fbc.
    CenteredFbcPlan`).  Equal to ``fused_ntt.ntt_fwd_centered_lift_plain``
    / ``ntt_fwd_centered_fbc_plain``."""
    return _lift_passes(y, w, t, cluster=cluster, to_mont=to_mont, dig=dig,
                        q_src=q_src, recip=recip, p_mod=p_mod)
