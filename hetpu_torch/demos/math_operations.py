"""Primitive-op latency sweep (reference ``src/demos/math_operations.cpp``;
counterpart of ``hetpu/demos/math_operations.py``): times pt-ct add, ct-ct
add, pt-ct mult, ct-ct mult, relinearization and rescale as a function of
modulus-chain depth.  The reference sweeps chain_levels 2..26 at N=2^15
with 26 hand-written modulus ladders (:21-247, :614-619); here one
generator parameterizes the chain (SURVEY.md §2c asks for this)."""

from __future__ import annotations

import numpy as np

from .. import bench
from ..core.params import chain_sweep
from ..session import Session
from ..utils.timer import Timer


def _operands(sess: Session):
    """hetpu's operands: two encryptions and one encoding from rng(0)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, sess.slots)
    y = rng.uniform(-1, 1, sess.slots)
    return sess.encrypt(x), sess.encrypt(y), sess.encode(y)


def bench_he_all(sess: Session, reps: int = 5) -> dict:
    """Seconds per call of each op: ``reps`` eager calls after one untimed
    call (hetpu's jit compile), the clock read once the device is done."""
    ct1, ct2, pt = _operands(sess)
    ev = sess.ev
    cases = {
        "pt_ct_add": lambda: ev.add_plain(ct1, pt),
        "ct_ct_add": lambda: ev.add(ct1, ct2),
        "pt_ct_mult": lambda: ev.multiply_plain(ct1, pt),
        "ct_ct_mult": lambda: ev.multiply(ct1, ct2),
        "relin": lambda: ev.relinearize(ev.multiply(ct1, ct2), sess.rk),
        "rescale": lambda: ev.rescale(ev.multiply_plain(ct1, pt)),
    }
    out = {}
    for name, fn in cases.items():
        t = Timer()
        t.tocr(block_on=fn().data)           # warm-up, finished untimed
        t.tic()
        for _ in range(reps):
            r = fn()
        out[name] = t.tocr(block_on=r.data) / reps
    return out


def chained_cases(sess: Session) -> dict:
    """hetpu's chained cases: op name → (the op on its first operand's
    data, that data)."""
    ct1, ct2, pt = _operands(sess)
    ev = sess.ev
    m3 = ev.multiply(ct1, ct2)
    pm = ev.multiply_plain(ct1, pt)
    return {
        "pt_ct_add": (lambda d: ev.add_plain(ct1.with_(data=d), pt).data,
                      ct1.data),
        "ct_ct_add": (lambda d: ev.add(ct1.with_(data=d), ct2).data,
                      ct1.data),
        "pt_ct_mult": (lambda d: ev.multiply_plain(ct1.with_(data=d),
                                                   pt).data, ct1.data),
        "ct_ct_mult": (lambda d: ev.multiply(ct1.with_(data=d), ct2).data,
                       ct1.data),
        "relin": (lambda d: ev.relinearize(m3.with_(data=d), sess.rk).data,
                  m3.data),
        "rescale": (lambda d: ev.rescale(pm.with_(data=d)).data, pm.data),
    }


def bench_he_all_chained(sess: Session, K: int = 64, reps: int = 2) -> dict:
    """Seconds per step of each op chained K·reps times, each step's input
    XOR-tagged by the fold of the previous step's output (hetpu's
    ``lax.scan`` chain, bench.py's honest-timing shape), through the
    bench harness (:func:`..bench.timed`): on the card one step replayed
    from a CUDA graph, so the per-launch host cost is gone and the
    level-scaling curve is the device's (reference sweep
    ``math_operations.cpp:614-619``); on the CPU eager steps on the host
    clock.  An op that cannot be captured raises, naming the op.  The
    tagged outputs are for timing only: the tag may turn a residue q-1
    into q."""
    return {name: bench.timed(bench.Chain(fn, data.clone(), name=name), K,
                              reps, eager=False)["seconds"]
            for name, (fn, data) in chained_cases(sess).items()}


def demo_bench_all(small=False, device="cuda"):
    n = 1 << (13 if small else 15)
    max_levels = 6 if small else 26
    print(f"chain-level sweep at N={n} (reference :614-619)")
    for lv, params in chain_sweep(n, 2, max_levels,
                                  sec_level=0 if small else 128):
        sess = Session.create(params, galois_steps=[1], device=device)
        times = bench_he_all(sess)
        row = " ".join(f"{k}={v*1e3:.3f}ms" for k, v in times.items())
        print(f"levels={lv:2d}  {row}")
        del sess                              # free this level's keys first


def demo_bench_rot(small=False, device="cuda"):
    """Rotation smoke test (reference bench_he_rot :512-593)."""
    sess = Session.create("test_deep" if small else "ckks_deep",
                          galois_steps=[1, 2, 4], device=device)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, sess.slots)
    ct = sess.encrypt(x)
    t = Timer()
    t.tocr(block_on=sess.ev.rotate(ct, 1, sess.gk).data)   # warm-up
    t.tic()
    out = sess.ev.rotate(ct, 1, sess.gk)
    t.toc("HE rotate(1) time", block_on=out.data)
    got = sess.decrypt(out).real[:4]
    print("rot =", got, "\nexpected =", np.roll(x, -1)[:4])


DEMOS = {"bench_all": demo_bench_all, "bench_rot": demo_bench_rot}
