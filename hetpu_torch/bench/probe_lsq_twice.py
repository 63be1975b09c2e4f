"""The least-squares fit twice in one process (port of
``scripts/probe_lsq_twice.py``): the first run's wall time against the
warm second run's.

``least_squares_2d`` at ckks_deep_hi (seed 0x77…, galois [1, 2, 4]) on 5
points drawn from one rng(0) for both runs (so the second run fits new
points), ``inv_iters`` 6; each run is timed on the host clock from the
fit's call to both coefficients decrypted.  In the port the first run
also builds every per-level plan and table the fit reaches and, on the
card, loads the kernel library, built first unless it is already on
disk; ``first_run_includes`` says which.  The record has hetpu's four
keys (unrounded), the device and the card.
"""

from __future__ import annotations

import json
import time

import numpy as np

from . import meta, write_record
from ..core import cuda_lib
from ..models.least_squares import least_squares_2d
from ..session import Session
from ..utils.keycache import cached_session

PRESET, SMALL_PRESET = "ckks_deep_hi", "test_deep"
SEED = b"\x77" * 32
GALOIS = [1, 2, 4]
N_POINTS, INV_ITERS = 5, 6
MAX_ERR = 2.0 ** -10             # the fit's bound (chip_smoke.py phase 14)


def points(sess: Session, rng):
    """The script's draws (``:19-25``): x, y and the zero-padded slot
    vectors."""
    x = rng.uniform(0.5, 2.0, N_POINTS)
    y = 0.7 * x + 0.3 + rng.normal(0, 0.02, N_POINTS)
    px, py = np.zeros(sess.slots), np.zeros(sess.slots)
    px[:N_POINTS], py[:N_POINTS] = x, y
    return x, y, px, py


def run_once(sess: Session, rng) -> tuple[float, float]:
    """One fit (``:18-35``): (seconds, the larger error of a and b against
    the closed form)."""
    x, y, px, py = points(sess, rng)
    sx, sxx = x.sum(), (x * x).sum()
    D = N_POINTS * sxx - sx * sx
    t0 = time.perf_counter()
    ct_a, ct_b = least_squares_2d(sess, sess.encrypt(px), sess.encrypt(py),
                                  N_POINTS, inv_guess=1.0 / D,
                                  inv_iters=INV_ITERS)
    a = sess.decrypt(ct_a).real[0]          # forces the whole pipeline
    b = sess.decrypt(ct_b).real[0]
    dt = time.perf_counter() - t0
    sy, sxy = y.sum(), (x * y).sum()
    ea, eb = (N_POINTS * sxy - sx * sy) / D, (sxx * sy - sx * sxy) / D
    return dt, float(max(abs(a - ea), abs(b - eb)))


def run(small: bool, device: str, out=None) -> dict:
    """Fit twice, print hetpu's two lines and the record; writes it and
    returns it."""
    includes = {"per_level_plans_and_tables": True,
                "library_built_on_disk": (cuda_lib.library_path().exists()
                                          if device == "cuda" else None)}
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=GALOIS, device=device)
    rng = np.random.default_rng(0)
    t1, e1 = run_once(sess, rng)
    print(f"first run:  {t1:.3f}s err={e1:.2e}", flush=True)
    t2, e2 = run_once(sess, rng)
    print(f"second run: {t2:.3f}s err={e2:.2e}", flush=True)
    record = {"first_run_s": t1, "warm_process_s": t2,
              "first_call_overhead_s": t1 - t2, "max_err": max(e1, e2),
              "first_run_includes": includes, **meta(device)}
    write_record("probe_lsq_twice_small" if small else "probe_lsq_twice",
                 record, out)
    print(json.dumps(record), flush=True)
    return record
