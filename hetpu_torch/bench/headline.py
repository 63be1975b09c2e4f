"""Headline benchmark (port of ``bench.py``): CKKS ct·ct multiply +
relinearize + rescale throughput at N=2^14, the BASELINE.md north-star
metric (reference machinery: ``math_operations.cpp:338-354``).

Two encryptions from ``rng(0)``, each stacked B times, on the
``cached_session(preset, seed=0x21…, galois_steps=[1])`` keys; K·reps
steps of the chain, every output element folded into the next step's
input (:func:`..bench.fold_into`), replayed from one captured step on the
card (:func:`..bench.timed`).  Prints a line with the eager figure and the
run's settings, then hetpu's metric line with value = B·K·reps / seconds
and the device that ran it.
hetpu's ``vs_baseline`` (a TPU target of 10k ops/s a v5p chip) is not
printed: it is no number of this card's.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import Chain, device_name, fold_into, report, timed
from ..session import Session
from ..utils.keycache import cached_session

METRIC = "ckks_mult_relin_rescale_n14_ops_per_s"
SEED = b"\x21" * 32
# bench.py's preset variants (same metric): α=5 (default), α=4, and α=4
# with primes < 2^30, which on the TPU selected an approximate mulhi;
# the port's arithmetic is exact on every preset
PRESETS = ("bench_n14", "bench_n14_a4", "bench_n14_fast")
SMALL_PRESET = "test_dnum"


def operands(sess: Session, batch: int):
    """bench.py's operands: two encryptions from rng(0), each stacked
    ``batch`` times."""
    rng = np.random.default_rng(0)
    base = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    b_ct = sess.encrypt(rng.uniform(-1, 1, sess.slots))
    return (base.with_(data=torch.stack([base.data] * batch)),
            b_ct.with_(data=torch.stack([b_ct.data] * batch)))


def chain(sess: Session, a, b) -> Chain:
    """bench.py's step (``:69-77``): multiply_relin_rescale of a (its data
    XOR the tag) by b, the whole output folded into the tag."""
    return Chain(lambda d: sess.ev.multiply_relin_rescale(
        a.with_(data=d), b, sess.rk).data, a.data, fold_into,
        "multiply_relin_rescale")


def run(preset: str, batch: int, K: int, reps: int, device: str) -> dict:
    """Time the chain and print the two lines; returns the metric line."""
    sess = cached_session(preset, seed=SEED, galois_steps=[1], device=device)
    r = timed(chain(sess, *operands(sess, batch)), K, reps)
    report(r, program="headline", preset=preset, batch=batch, K=K,
           reps=reps, device=device_name(device),
           eager_ops_per_s=batch / r["eager_seconds"])
    seconds = r["seconds"] * r["steps"]
    line = {"metric": METRIC, "value": batch * K * reps / seconds,
            "unit": "ops/s", "device": device_name(device)}
    print(json.dumps(line), flush=True)
    return {**line, "run": r}
