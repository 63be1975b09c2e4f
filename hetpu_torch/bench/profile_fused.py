"""Phase-level breakdown of ``multiply_relin_rescale`` (port of
``scripts/profile_fused.py``).

At bench_n14 (seed 0x21…, galois [1]) B=32, each piece of the op is a
chain of K=16 steps, the best of REPS=3 windows (:func:`..bench.best_of`)
with the script's flat sampled fold (:func:`..bench.fold8`): the full op,
the Karatsuba multiply, the digit decomposition and its pieces (INTT, the
Shoup lift loop over each digit's foreign primes, the forward NTT over
them), the raw key inner product, the mod-down + rescale tail and its
pieces (INTT of the sources, the base conversion, the Montgomery forward
NTT), and two baselines (``x % q``, one Shoup pass).

The pieces are the port's public functions, called as the script calls
hetpu's: the lift loop and the per-digit forward NTT run plain PyTorch ops
and K1 ``ntt`` where the op runs the fused K2 ``ntt_fwd_lifted``; the
tail's conversion runs the plain ``rns.fbc_apply`` where the op runs K3
``ntt_fwd_fbc``.  That split is the script's point.  Constants the script
indexes with numpy arrays are gathered into device tensors before the
steps, so each step captures in a CUDA graph.

Prints, for each chain, the harness's line (chained and eager ms, kernels
a replay, bytes grown, and the bytes bound of its input, the ciphertexts
and keys it reads and its output) and then hetpu's line: ms a call and
µs an op.
"""

from __future__ import annotations

import torch

from . import (Chain, best_of, device_name, entry, fold8, headline, meta,
               report, write_record)
from ..core import rns
from ..core.modular import mod_add, mod_sub, shoup_mul
from ..core.ntt import ntt_fwd, ntt_fwd_mont, ntt_inv
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "bench_n14", "test_dnum"
SEED = b"\x21" * 32
B, K, REPS = 32, 16, 3
SMALL_B, SMALL_K = 2, 3


def lift_constants(plan) -> list:
    """Per digit: (its first and last source prime, the foreign primes'
    q [F,1], and for each source prime i its d̂_i and Shoup companions
    over them [F,1]), gathered on the plan's device."""
    out = []
    for di, (lo, hi) in enumerate(plan.digit_bounds):
        idx = torch.as_tensor(plan.foreign_idx[di], dtype=torch.long,
                              device=plan.q.device)
        out.append((lo, hi, plan.q[idx],
                    [(plan.dhat[i][idx][:, None],
                      plan.dhat_shoup[i][idx][:, None])
                     for i in range(lo, hi)]))
    return out


def chains(sess: Session, batch: int):
    """Yield (label, Chain) in profile_fused.py's order, on its inputs
    (``:54-76``): two encryptions from rng(0), each stacked ``batch``
    times, at the top level."""
    ev, ctx = sess.ev, sess.ctx
    lvl = len(ctx.params.moduli) - 1
    L = lvl + 1
    N = ctx.params.poly_degree
    tabs = ctx.tables(lvl)
    plan = ctx.keyswitch_plan(lvl)
    mdr = ctx.moddown_rescale_plan(lvl)
    J, R = plan.num_digits, len(plan.basis_tables.primes)
    print(f"N={N} L={L} J={J} R={R} B={batch} alpha={plan.alpha}",
          flush=True)

    a, b = headline.operands(sess, batch)
    m3 = ev.multiply(a, b)
    c2 = m3.data[..., 2, :, :].contiguous()           # [B, L, N]
    ext = ev._decompose(c2, lvl)                      # [B, J, R, N]
    accip = ev._inner_product_raw(ext, lvl, sess.rk.key)   # [B, 2, R, N]
    q = tabs.q

    key = (sess.rk.key.data, sess.rk.key.shoup)

    def c(label, fn, x0, *operands):
        return label, Chain(fn, x0, fold8, label, operands)

    yield c("FULL multiply_relin_rescale", lambda d: ev.multiply_relin_rescale(
        a.with_(data=d), b, sess.rk).data, a.data, b.data, *key)
    yield c("multiply (karatsuba)", lambda d: ev.multiply(
        a.with_(data=d), b).data, a.data, b.data)
    yield c("decompose total", lambda d: ev._decompose(d % q, lvl), c2)
    yield c("  intt L planes", lambda d: ntt_inv(
        d % q, tabs, strip_mont=True, extra=plan.dig_inv), c2)

    y0 = ntt_inv(c2, tabs, strip_mont=True, extra=plan.dig_inv)
    digits = lift_constants(plan)

    def lift_only(y):
        exts = []
        for lo, hi, qf, ws in digits:
            acc = None
            for i, (w, w_shoup) in zip(range(lo, hi), ws):
                term = shoup_mul(y[..., i:i + 1, :], w, w_shoup, qf)
                acc = term if acc is None else mod_add(acc, term, qf)
            exts.append(acc)
        return torch.cat(exts, dim=-2)

    yield c("  fbc lift (shoup loop)", lift_only, y0)
    lifted0 = lift_only(y0)

    def fwd_foreign(lf):
        outs = []
        o = 0
        for di in range(J):
            t = plan.foreign_tables[di]
            f = len(t.primes)
            outs.append(ntt_fwd(lf[..., o:o + f, :] % t.q, t))
            o += f
        return torch.cat(outs, dim=-2)

    yield c("  ntt_fwd foreign (19 planes)", fwd_foreign, lifted0)
    yield c("inner_product_raw", lambda d: ev._inner_product_raw(
        d % plan.q, lvl, sess.rk.key), ext, *key)

    def tail(acc):
        acc = acc % plan.q
        c01 = m3.data[..., :2, :, :]
        w_data = mod_add(
            acc[..., :L, :],
            shoup_mul(c01, mdr.p_mod, mdr.p_mod_shoup, tabs.q), tabs.q)
        src = torch.cat([w_data[..., L - 1: L, :], acc[..., L:, :]], dim=-2)
        u = ntt_inv(src, mdr.src_tables, strip_mont=True,
                    extra=mdr.fbc.inv_punit)
        r_q = rns.fbc_apply(u, mdr.fbc, correct=True, premul=False)
        r_m = ntt_fwd_mont(r_q, mdr.dst_tables)
        q_dst = mdr.dst_tables.q
        return shoup_mul(mod_sub(w_data[..., : L - 1, :], r_m, q_dst),
                         mdr.pq_inv, mdr.pq_inv_shoup, q_dst)

    yield c("moddown+rescale tail", tail, accip, m3.data[..., :2, :, :])

    src0 = torch.cat([accip[..., L - 1: L, :], accip[..., L:, :]], dim=-2)
    yield c("  intt src (12 planes)", lambda d: ntt_inv(
        d % mdr.src_tables.q, mdr.src_tables, strip_mont=True,
        extra=mdr.fbc.inv_punit), src0)
    u0 = ntt_inv(src0, mdr.src_tables, strip_mont=True,
                 extra=mdr.fbc.inv_punit)
    yield c("  fbc moddown (6->8 x2)", lambda d: rns.fbc_apply(
        d % mdr.fbc.p, mdr.fbc, correct=True, premul=False), u0)
    rq0 = rns.fbc_apply(u0, mdr.fbc, correct=True, premul=False)
    yield c("  ntt_fwd_mont (16 planes)", lambda d: ntt_fwd_mont(
        d % mdr.dst_tables.q, mdr.dst_tables), rq0)

    yield c("baseline: x % q [B,L,N]", lambda d: d % q, c2)
    yield c("baseline: shoup [B,L,N]", lambda d: shoup_mul(
        d % q, tabs.r, tabs.r_shoup, q), c2)


def run(small: bool, device: str, out=None) -> dict:
    """Time every chain and print its two lines; writes the record
    (label → :func:`..bench.entry`) and returns it."""
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=[1], device=device)
    batch, k = (SMALL_B, SMALL_K) if small else (B, K)
    record = meta(device)
    for label, c in chains(sess, batch):
        r = best_of(c, k, REPS)
        report(r, program="profile_fused", chain=label, batch=batch, K=k,
               reps=REPS, device=device_name(device))
        dt = r["seconds"]
        print(f"{label:44s} {dt*1e3:8.3f} ms/call  {dt/batch*1e6:7.1f} us/op",
              flush=True)
        record[label] = entry(r)
    write_record("profile_fused_small" if small else "profile_fused", record,
                 out)
    return record
