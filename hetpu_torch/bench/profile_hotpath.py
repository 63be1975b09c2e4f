"""Where the time goes in ``multiply_relin_rescale``, step by step (port of
``scripts/profile_hotpath.py``).

At bench_n14 (seed 0x21…, galois [1]) B=32: the full op, the multiply,
relinearize, a 2-part rescale, the decomposition, the inner product with
its mod-down, and the NTT forward and inverse over [B, L, N] and forward
over the key basis [B, J, R, N].  Each step folds ``out[..., :1, :1, :8]``
(all of out below 3 dimensions) into the next input
(:func:`..bench.fold_rows8`).

The script dispatches every step from the host: its number is the eager
ms a step over 10 steps on the host clock (``iters=10``), printed in
hetpu's line.  The harness's line before it also gives the same step
chained from a CUDA graph.  The last line is hetpu's ``breakdown:``
(eager ms).
"""

from __future__ import annotations

import torch

from . import (Chain, device_name, entry, fold_rows8, headline, meta, report,
               timed, write_record)
from ..core.ntt import ntt_fwd, ntt_inv
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "bench_n14", "test_dnum"
SEED = b"\x21" * 32
BATCH, ITERS = 32, 10
SMALL_BATCH, SMALL_ITERS = 2, 3
REPS = 2                      # chained replays: ITERS·REPS


def chains(sess: Session, batch: int):
    """Yield (label, Chain) in profile_hotpath.py's order, on its inputs
    (``:33-47``, ``:72-91``)."""
    ev = sess.ev
    a, b = headline.operands(sess, batch)
    m3 = ev.multiply(a, b)                 # 3-part ct at top level
    lvl = a.level
    L = lvl + 1
    n = sess.ctx.params.poly_degree
    print(f"level={lvl} L={L} N={n} batch={batch}", flush=True)
    plan = sess.ctx.keyswitch_plan(lvl)
    print("digits J =", plan.num_digits, " key basis R =",
          tuple(plan.q.shape), flush=True)

    def c(label, fn, x0):
        return label, Chain(fn, x0, fold_rows8, label)

    yield c("multiply_relin_rescale", lambda d: ev.multiply_relin_rescale(
        a.with_(data=d), b, sess.rk).data, a.data)
    yield c("multiply", lambda d: ev.multiply(a.with_(data=d), b).data,
            a.data)
    yield c("relinearize", lambda d: ev.relinearize(
        m3.with_(data=d), sess.rk).data, m3.data)
    yield c("rescale(2part)", lambda d: ev.rescale(a.with_(data=d)).data,
            a.data)
    c2 = m3.data[..., 2, :, :]
    yield c("  decompose (INTT+FBC+NTT)", lambda d: ev._decompose(d, lvl),
            c2)
    ext = ev._decompose(c2, lvl)
    yield c("  inner_product (+moddown)", lambda d: torch.stack(
        ev._inner_product(d, lvl, sess.rk.key), -3), ext)
    tabs = sess.ctx.tables(lvl)
    x = a.data[..., 0, :, :]               # [B, L, N]
    yield c(f"  ntt_fwd  [B,{L},N]", lambda d: ntt_fwd(d, tabs), x)
    yield c(f"  ntt_inv  [B,{L},N]", lambda d: ntt_inv(
        d, tabs, strip_mont=True), x)
    kb = plan.basis_tables
    R = len(kb.primes)
    J = plan.num_digits
    y = (x[..., :1, :].repeat(1, J * R, 1)[..., :J * R, :]
         .reshape(batch, J, R, n) % kb.primes[0])
    yield c(f"  ntt_fwd key basis [B,{J},{R},N]", lambda d: ntt_fwd(d, kb),
            y)


def run(small: bool, device: str, out=None) -> dict:
    """Time every step and print its two lines, then the breakdown;
    writes the record (label → :func:`..bench.entry`) and returns it."""
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=[1], device=device)
    batch, iters = (SMALL_BATCH, SMALL_ITERS) if small else (BATCH, ITERS)
    record = meta(device)
    for label, c in chains(sess, batch):
        r = timed(c, iters, REPS)
        report(r, program="profile_hotpath", chain=label, batch=batch,
               K=iters, reps=REPS, device=device_name(device))
        print(f"{label:34s} {r['eager_seconds']*1e3:9.3f} ms/iter", flush=True)
        record[label] = entry(r)
    ms = [record[k]["eager_ms"] for k in (
        "multiply", "relinearize", "rescale(2part)",
        "  decompose (INTT+FBC+NTT)", "  inner_product (+moddown)")]
    print("\nbreakdown: mul %.2f relin %.2f rescale %.2f | dec %.2f ip %.2f"
          % tuple(ms), flush=True)
    write_record("profile_hotpath_small" if small else "profile_hotpath",
                 record, out)
    return record
