"""Secondary benchmark metrics (port of ``scripts/bench_secondary.py``;
BASELINE.md: "enc matvec/s, NTT limb-ops/s"), in bench.py's chained
harness with hetpu's sampled fold (:func:`..bench.fold8`):

* ``ckks_rotate_n14_ops_per_s``: ``rotate(·, 1)``, the Galois key switch
  of the diagonal matmul's hot loop, K = 256;
* ``ckks_rotate_hoisted8_n14_ops_per_s``: ``rotate_hoisted`` over steps
  1..128 in powers of two (one shared digit decomposition, 8 key inner
  products; reference ``he_linalg.cpp:977-1003``), the last output folded,
  K = 64, 8 rotations a call;
* ``ntt_fwd_n14_limb_planes_per_s``: ``ntt_fwd_mont(d % q)`` over every
  prime of the key basis, [B, L, N], K = 256.

bench_n14 with the full ±2^i rotation keyset (seed 0x22…), B = 8.  Prints
one line a metric after a line with its chained and eager figures.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import Chain, device_name, fold8, report, timed
from ..core.modular import from_u32
from ..core.ntt import ntt_fwd_mont
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "bench_n14", "test_dnum"
SEED = b"\x22" * 32
BATCH, SMALL_BATCH = 8, 2
HOIST_STEPS = [1, 2, 4, 8, 16, 32, 64, 128]      # in the ±2^i keyset
# chained steps a rep (two reps), as bench_secondary.py
K = {"ckks_rotate_n14_ops_per_s": 256,
     "ckks_rotate_hoisted8_n14_ops_per_s": 64,
     "ntt_fwd_n14_limb_planes_per_s": 256}
SMALL_K = 3


def rotate(sess: Session, a) -> Chain:
    """``rotate(·, 1)`` of a (its data XOR the tag)."""
    return Chain(lambda d: sess.ev.rotate(a.with_(data=d), 1, sess.gk).data,
                 a.data, fold8, "rotate")


def rotate_hoisted(sess: Session, a) -> Chain:
    """``rotate_hoisted`` of a over :data:`HOIST_STEPS`, the last output
    folded."""
    return Chain(lambda d: sess.ev.rotate_hoisted(
        a.with_(data=d), HOIST_STEPS, sess.gk)[-1].data, a.data, fold8,
        "rotate_hoisted")


def ntt(sess: Session, x) -> Chain:
    """``ntt_fwd_mont(x % q)`` over every prime of the key basis."""
    tabs = sess.ctx.tables_full
    return Chain(lambda d: ntt_fwd_mont(d % tabs.q, tabs), x, fold8,
                 "ntt_fwd_mont")


def chains(sess: Session, batch: int, rng) -> dict:
    """The three chains in bench_secondary.py's order and draws from
    ``rng`` (one encryption, then the NTT's residues): metric → (chain,
    ops a step, unit)."""
    ct = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    a = ct.with_(data=torch.stack([ct.data] * batch))
    primes = sess.ctx.tables_full.primes
    n = sess.ctx.params.poly_degree
    x = np.stack([rng.integers(0, p, n, dtype=np.uint32) for p in primes])
    xb = from_u32(np.stack([x] * batch), sess.ctx.device)
    return {"ckks_rotate_n14_ops_per_s": (rotate(sess, a), batch, "ops/s"),
            "ckks_rotate_hoisted8_n14_ops_per_s":
                (rotate_hoisted(sess, a), batch * len(HOIST_STEPS), "ops/s"),
            "ntt_fwd_n14_limb_planes_per_s":
                (ntt(sess, xb), batch * len(primes), "planes/s")}


def measure(sess: Session, batch: int, rng, small: bool) -> dict:
    """Time each chain and print its two lines; returns metric → value."""
    dev = device_name(sess.ctx.device.type)
    out = {}
    for metric, (c, ops, unit) in chains(sess, batch, rng).items():
        k = SMALL_K if small else K[metric]
        r = timed(c, k)
        report(r, program="secondary", chain=c.name, batch=batch, K=k,
               reps=2, device=dev)
        out[metric] = ops / r["seconds"]
        print(json.dumps({"metric": metric, "value": out[metric],
                          "unit": unit, "device": dev}), flush=True)
    return out


def run(small: bool, device: str) -> dict:
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          device=device)
    return measure(sess, SMALL_BATCH if small else BATCH,
                   np.random.default_rng(0), small)
