"""Chained per-part profile of ``multiply_relin_rescale`` and the full op's
batch sensitivity (port of ``scripts/op_parts_chain.py``).

At bench_n14 (seed 0x21…, galois [1]): the full op at B=32 and B=64 (two
new encryptions from the one rng(0) for each batch), and at B=32 its four
parts: the multiply, the decomposition of part 0 of the 3-part product,
the raw key inner product and the fused relinearize + rescale from the
3-part product.  Each chain runs K=16 steps REPS=3 times in one window
(:func:`..bench.timed`) with the script's fold of ``y[..., :1, :8]``
(:func:`..bench.fold_parts8`).  Prints the harness's line (with the
bytes bound of the input, the ciphertexts and keys read and the output),
then hetpu's: ms a step and µs an op.
"""

from __future__ import annotations

import numpy as np
import torch

from . import (Chain, device_name, entry, fold_parts8, meta, report, timed,
               write_record)
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "bench_n14", "test_dnum"
SEED = b"\x21" * 32
BATCHES, K, REPS = (32, 64), 16, 3
SMALL_BATCHES, SMALL_K = (2,), 3


def chains(sess: Session, batches=BATCHES):
    """Yield (label, Chain, B) in op_parts_chain.py's order and draws
    (``:38-67``); the parts at the first batch."""
    rng = np.random.default_rng(0)
    for B in batches:
        base = sess.encrypt(rng.uniform(-1, 1, sess.slots))
        bct = sess.encrypt(rng.uniform(-1, 1, sess.slots))
        print(f"--- BATCH={B}", flush=True)
        yield from parts(sess, base, bct, B, B == batches[0])


def parts(sess: Session, base, bct, B: int, all_parts: bool):
    """The chains of one batch (``:45-67``): the full op, and with
    ``all_parts`` its four parts."""
    ev = sess.ev
    a = base.with_(data=torch.stack([base.data] * B))
    b = bct.with_(data=torch.stack([bct.data] * B))
    m3 = ev.multiply(a, b)
    lvl = a.level

    key = (sess.rk.key.data, sess.rk.key.shoup)

    def c(label, fn, x0, *operands):
        return label, Chain(fn, x0, fold_parts8, label, operands), B

    yield c("full multiply_relin_rescale", lambda d: ev.
            multiply_relin_rescale(a.with_(data=d), b, sess.rk).data, a.data,
            b.data, *key)
    if not all_parts:
        return
    yield c("multiply only", lambda d: ev.multiply(a.with_(data=d), b).data,
            a.data, b.data)
    c2 = m3.data[..., 2, :, :]
    yield c("decompose", lambda d: ev._decompose(d[..., 0, :, :], lvl),
            m3.data)
    ext = ev._decompose(c2, lvl)
    yield c("inner_product_raw", lambda d: ev._inner_product_raw(
        d, lvl, sess.rk.key), ext, *key)
    yield c("relin+rescale fused (from 3part)", lambda d: ev.
            _relin_rescale_fused(m3.with_(data=d), sess.rk).data, m3.data,
            *key)


def run(small: bool, device: str, out=None) -> dict:
    """Time every chain and print its lines; writes the record
    (``B=<batch> <label>`` → :func:`..bench.entry`) and returns it."""
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=[1], device=device)
    batches, k = (SMALL_BATCHES, SMALL_K) if small else (BATCHES, K)
    record = meta(device)
    for label, c, B in chains(sess, batches):
        r = timed(c, k, REPS)
        report(r, program="op_parts_chain", chain=label, batch=B, K=k,
               reps=REPS, device=device_name(device))
        dt = r["seconds"]
        print(f"{label:38s} {dt*1e3:8.3f} ms/step  {dt/B*1e6:8.2f} us/op",
              flush=True)
        record[f"B={B} {label}"] = entry(r)
    write_record("op_parts_chain_small" if small else "op_parts_chain",
                 record, out)
    return record
