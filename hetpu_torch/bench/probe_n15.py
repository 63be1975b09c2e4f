"""The N=2^15 single-ciphertext op, in pieces (port of
``scripts/probe_n15.py`` and ``scripts/probe_n15b.py``; subcommands
``probe_n15`` and ``probe_n15b``).

At ckks_deep_hi (N=2^15, 25 data primes, J=7, R=29; seed 0x77…, galois
[1, 2, 4]), each chain the best of 3 windows (:func:`..bench.best_of`)
with the scripts' flat sampled fold (:func:`..bench.fold8`):

* ``probe_n15``: the bare forward NTT at rows 2 and 16, the op at B 1, 4
  and 8 (K=8 at B=1, else 32), and the multiply, the decomposition, the
  raw key inner product and the fused relinearize + rescale at B=1 (the
  script's tail lambda, ``:108-111``, kept as written: its input ignores
  the tag);
* ``probe_n15b``: the op at B=1 as one eager call waited for (best of 6 on
  the host clock, hetpu's ``direct``), then K=8 chains of the multiply,
  the decomposition, the inner product, the mod-down + rescale tail, the
  decomposition's INTT and its forward NTT over the concatenated foreign
  primes.

Prints the harness's line, then hetpu's (with the first eager step's
seconds where the script printed its compile time), and at the end the
record: hetpu's keys (label → ms) with the device and the card's
nvidia-smi line, written to ``build/hetpu_torch/<subcommand>.json``.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from . import (Chain, best_of, device_name, fold8, meta, report,
               write_record)
from ..core import rns
from ..core.modular import mod_add, mod_sub, shoup_mul
from ..core.ntt import ntt_fwd, ntt_fwd_mont, ntt_inv
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "ckks_deep_hi", "test_dnum"
SEED = b"\x77" * 32
GALOIS = [1, 2, 4]
REPS, DIRECT_REPS = 3, 6
K_N15, K_N15B, K_B1 = 32, 8, 8
BATCHES, SMALL_BATCHES = (1, 4, 8), (1, 2)
SMALL_K = 3


def setup(sess: Session):
    """The scripts' top level, plans and two encryptions from rng(0)."""
    ctx = sess.ctx
    lvl = len(ctx.params.moduli) - 1
    plan = ctx.keyswitch_plan(lvl)
    print(f"N={ctx.params.poly_degree} L={lvl + 1} J={plan.num_digits} "
          f"R={len(plan.basis_tables.primes)}", flush=True)
    rng = np.random.default_rng(0)
    base = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    b_ct = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    return lvl, ctx.tables(lvl), plan, base, b_ct


def _c(label, fn, x0, k, batch=None):
    return label, Chain(fn, x0, fold8, label), k, batch


def chains_n15(sess: Session, k: int = K_N15, k_b1: int = K_B1,
               batches=BATCHES):
    """Yield (label, Chain, K, B of an op chain or None) in probe_n15.py's
    order and inputs (``:58-111``)."""
    ev = sess.ev
    lvl, tabs, plan, base, b_ct = setup(sess)
    q = tabs.q
    x2 = base.data % q                        # [2, L, N]  rows=2
    x16 = torch.stack([x2] * 8)               # [8, 2, L, N] rows=16
    yield _c("ntt_fwd rows=2  [2,L,N]", lambda d: ntt_fwd(d % q, tabs), x2, k)
    yield _c("ntt_fwd rows=16 [8,2,L,N]", lambda d: ntt_fwd(d % q, tabs),
             x16, k)
    for B in batches:
        if B == 1:
            a, b = base, b_ct
        else:
            a = base.with_(data=torch.stack([base.data] * B))
            b = b_ct.with_(data=torch.stack([b_ct.data] * B))
        yield _c(f"fused mult_relin_rescale B={B}",
                 lambda d, a=a, b=b: ev.multiply_relin_rescale(
                     a.with_(data=d), b, sess.rk).data, a.data,
                 k_b1 if B == 1 else k, B)

    m3 = ev.multiply(base, b_ct)
    c2 = m3.data[..., 2, :, :]
    yield _c("multiply B=1", lambda d: ev.multiply(
        base.with_(data=d), b_ct).data, base.data, k)
    yield _c("decompose B=1", lambda d: ev._decompose(d % q, lvl), c2, k)
    ext = ev._decompose(c2, lvl)
    qr = plan.q
    yield _c("inner_product_raw B=1", lambda d: ev._inner_product_raw(
        d % qr, lvl, sess.rk.key), ext, k)
    yield _c("relin+rescale tail B=1", lambda d: ev._relin_rescale_fused(
        m3.with_(data=torch.stack([m3.data[..., p, :, :] for p in range(3)],
                                  dim=-3) ^ (d[..., :1, :, :] * 0)),
        sess.rk).data, m3.data, k)


def n15b(sess: Session, k: int = K_N15B):
    """probe_n15b.py's ``direct`` call of the op at B=1, a function of no
    argument (``:78-80``), and a generator of (label, Chain, K, None) in
    the script's order and inputs (``:82-126``), on one pair of
    encryptions."""
    state = setup(sess)
    _, _, _, base, b_ct = state
    return (lambda: sess.ev.multiply_relin_rescale(base, b_ct, sess.rk).data,
            _chains_n15b(sess, k, state))


def _chains_n15b(sess: Session, k: int, state):
    ev, ctx = sess.ev, sess.ctx
    lvl, tabs, plan, base, b_ct = state
    q = tabs.q
    m3 = ev.multiply(base, b_ct)
    c2 = m3.data[..., 2, :, :].contiguous()
    yield _c("multiply B=1", lambda d: ev.multiply(
        base.with_(data=d), b_ct).data, base.data, k)
    yield _c("decompose B=1", lambda d: ev._decompose(d % q, lvl), c2, k)
    ext = ev._decompose(c2, lvl)
    qr = plan.q
    yield _c("inner_product_raw B=1", lambda d: ev._inner_product_raw(
        d % qr, lvl, sess.rk.key), ext, k)
    accip = ev._inner_product_raw(ext, lvl, sess.rk.key)
    mdr = ctx.moddown_rescale_plan(lvl)
    L = lvl + 1
    g = ctx.params.rescale_group

    def tail(acc):
        acc = acc % qr
        c01 = m3.data[..., :2, :, :]
        w_data = mod_add(
            acc[..., :L, :],
            shoup_mul(c01, mdr.p_mod, mdr.p_mod_shoup, tabs.q), tabs.q)
        src = torch.cat([w_data[..., L - g: L, :], acc[..., L:, :]], dim=-2)
        u = ntt_inv(src, mdr.src_tables, strip_mont=True,
                    extra=mdr.fbc.inv_punit)
        r_q = rns.fbc_apply(u, mdr.fbc, correct=True, premul=False)
        r_m = ntt_fwd_mont(r_q, mdr.dst_tables)
        q_dst = mdr.dst_tables.q
        return shoup_mul(mod_sub(w_data[..., : L - g, :], r_m, q_dst),
                         mdr.pq_inv, mdr.pq_inv_shoup, q_dst)

    yield _c("moddown+rescale tail B=1", tail, accip, k)
    yield _c("  intt 25 planes", lambda d: ntt_inv(
        d % q, tabs, strip_mont=True, extra=plan.dig_inv), c2, k)
    y0 = ntt_inv(c2, tabs, strip_mont=True, extra=plan.dig_inv)
    cat = plan.foreign_cat_tables
    xcat = torch.cat([y0[..., :1, :]] * len(cat.primes), dim=-2)
    yield _c("  ntt_fwd foreign-cat planes", lambda d: ntt_fwd(
        d % cat.q, cat), xcat, k)


def direct(name: str, fn, results: dict, reps: int = DIRECT_REPS):
    """hetpu's ``direct`` (``probe_n15b.py:50-60``): one call, then the
    best of ``reps`` calls, each waited for, on the host clock; returns
    the last output."""
    out = fn()
    sync = torch.cuda.synchronize if out.is_cuda else (lambda: None)
    sync()
    best = 1e9
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    print(f"{name:44s} {best*1e3:9.3f} ms/dispatch", flush=True)
    results[name + " (dispatch)"] = best * 1e3
    return out


def run(program: str, small: bool, device: str, out=None) -> dict:
    """``probe_n15`` or ``probe_n15b``: time every chain and print its
    lines, then the record (hetpu's keys, the device and the card), which
    is written and returned."""
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=GALOIS, device=device)
    results = {}
    if program == "probe_n15":
        items = (chains_n15(sess, SMALL_K, SMALL_K, SMALL_BATCHES) if small
                 else chains_n15(sess))
    else:
        op, items = n15b(sess, SMALL_K if small else K_N15B)
        direct("FULL fused op B=1", op, results)
    for label, c, k, batch in items:
        r = best_of(c, k, REPS)
        report(r, program=program, chain=label, K=k, reps=REPS,
               first_step_s=r["first_seconds"], device=device_name(device))
        dt = r["seconds"]
        print(f"{label:44s} {dt*1e3:9.3f} ms/call   "
              f"(compile {r['first_seconds']:.1f}s)", flush=True)
        if batch is not None:
            print(f"   -> {dt/batch*1e3:.2f} ms/op", flush=True)
        results[label] = dt * 1e3
    record = {**results, **meta(device)}
    write_record(f"{program}_small" if small else program, record, out)
    print(json.dumps(results), flush=True)
    return record
