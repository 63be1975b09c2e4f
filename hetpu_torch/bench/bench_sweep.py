"""The headline op over (B, K) in one process (port of
``scripts/bench_sweep.py``): ``multiply_relin_rescale`` at bench_n14
(seed 0x21…, galois [1]) for B ∈ {32, 64} × K ∈ {8, 32, 96}, each the
best of 3 calls (:func:`..bench.best_of`) with the script's fold of
``out[..., :1, :1, :8]`` (:func:`..bench.fold_rows8`).

A call is one window of K replays of the captured step, each call from a
zero tag, as the script's.  Prints the harness's line, then hetpu's line
``B= K= call= ms per-step= ms ops/s=`` with the eager K-step call beside
it (host clock).
"""

from __future__ import annotations

import numpy as np
import torch

from . import (Chain, best_of, device_name, entry, fold_rows8, meta, report,
               write_record)
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "bench_n14", "test_dnum"
SEED = b"\x21" * 32
BATCHES, KS, REPS = (32, 64), (8, 32, 96), 3
SMALL_BATCHES, SMALL_KS = (2,), (3,)


def operands(sess: Session):
    """bench_sweep.py's two encryptions from rng(0) (``:13-16``)."""
    rng = np.random.default_rng(0)
    return (sess.encrypt(rng.uniform(-1, 1, sess.slots)),
            sess.encrypt(rng.uniform(-1, 1, sess.slots)))


def chain(sess: Session, base, b_ct, batch: int) -> Chain:
    """The script's step (``:23-30``) at ``batch``."""
    a = base.with_(data=torch.stack([base.data] * batch))
    b = b_ct.with_(data=torch.stack([b_ct.data] * batch))
    return Chain(lambda d: sess.ev.multiply_relin_rescale(
        a.with_(data=d), b, sess.rk).data, a.data, fold_rows8,
        f"multiply_relin_rescale B={batch}")


def run(small: bool, device: str, out=None, ks=None) -> dict:
    """Time every (B, K) and print its lines; writes the record
    (``B=<batch> K=<k>`` → :func:`..bench.entry`) and returns it.  ``ks``
    replaces the K values."""
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=[1], device=device)
    batches, kvals = (SMALL_BATCHES, SMALL_KS) if small else (BATCHES, KS)
    base, b_ct = operands(sess)
    record = meta(device)
    for batch in batches:
        for k in ks or kvals:
            r = best_of(chain(sess, base, b_ct, batch), k, REPS)
            report(r, program="bench_sweep", batch=batch, K=k, reps=REPS,
                   device=device_name(device))
            best = r["seconds"] * k
            print(f"B={batch:3d} K={k:3d} call={best*1e3:8.1f} ms "
                  f"per-step={best/k*1e3:7.2f} ms "
                  f"ops/s={batch*k/best:8.0f} "
                  f"eager call={r['eager_seconds']*k*1e3:8.1f} ms",
                  flush=True)
            record[f"B={batch} K={k}"] = entry(r)
    write_record("bench_sweep_small" if small else "bench_sweep", record, out)
    return record
