"""The benchmark surface of the reference as one record (port of
``scripts/bench_workloads.py``): hetpu's six sections, with its section
names and keys.

  keygen     sk/pk/relin/galois phase times       matrix_operations.cpp:858-874
  workloads  every matrix_operations demo's Timer stages
  fft        the fft and bfft demos' Timer stages  fft.cpp:102-104,204-206
  sweep      op latencies vs chain level, chained  math_operations.cpp:614-619
  secondary  rotation / hoisted-rotation ops/s, NTT planes/s, enc matvec/s
  baseline   BASELINE.json configs 3-5: matmul128, bfft1024x64, the
             sharded inference pipeline

Each section is written into the record (a JSON file, merged) as soon as
it finishes; ``--only SECTION`` runs one.  The record's ``meta`` names
the device and, on the card, its name and power limit as nvidia-smi
prints them.  Demo stages come from the demos' own Timer events through
the ``HETPU_METRICS`` sink (:mod:`..utils.metrics`), the numbers a user
sees on stdout.  A section that fails raises: nothing is recorded for it
and the program exits non-zero.

``small`` runs the test presets, short chains and reduced sizes (listed
in ``meta.small_sizes``); keys that name a preset name the one that ran.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from . import (OUT_DIR, Chain, card_line, device_name, fold8, report,
               secondary, timed)
from ..core.context import Context
from ..core.keys import KeyGenerator
from ..core.params import chain_sweep, preset
from ..utils.keycache import cached_session
from ..utils.timer import Timer

KEYGEN_PRESETS = {"bench_n14": "test_dnum", "ckks_deep_hi": "test_deep"}
DEMOS = ("op", "elemwise_square", "matmul", "matpow", "batch_matmul_bfv",
         "batch_matmul_ckks", "sum_elems", "least_squares_2d",
         "batched_matmul_ckks")
SWEEP_LEVELS = (2, 6, 10, 14, 18, 22, 26)
SWEEP_K, SWEEP_REPS = 64, 2            # bench_he_all_chained's defaults
MATVEC_D, MATVEC_K = 64, 16
SMALL_K = 2
# the small run's presets and sizes, where they differ from the full run's
SMALL_SIZES = {"sweep": "N=2^13, levels 2 and 6, K=2, reps 1",
               "secondary": "test_dnum B=2 K=3; matvec at test_tiny, K=2",
               "baseline": "test_dnum: matmul 16x16, bfft 64 x4, "
                           "pipeline B=8"}


def default_out(small: bool) -> Path:
    return OUT_DIR / ("bench_workloads_small.json" if small
                      else "bench_workloads.json")


def merge(out: Path, section: str, payload, device: str, small: bool):
    data = json.loads(out.read_text()) if out.exists() else {}
    data.setdefault("meta", {}).update({
        "platform": "gpu" if device == "cuda" else "cpu",
        "device": device_name(device), "card": card_line(device),
        "small": small, "recorded": time.strftime("%Y-%m-%d %H:%M:%S")})
    if small:
        data["meta"]["small_sizes"] = SMALL_SIZES
    data[section] = payload
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(data, indent=1, sort_keys=True) + "\n")
    print(f"[bench_workloads] wrote section {section!r} to {out}",
          flush=True)


def run_demo_with_timers(fn, *args) -> dict:
    """Run a demo, capturing its Timer events → {label: seconds}, plus
    the demo's wall seconds as ``total_wall_s``."""
    with tempfile.NamedTemporaryFile("r", suffix=".jsonl") as f:
        old = os.environ.get("HETPU_METRICS")
        os.environ["HETPU_METRICS"] = f.name
        try:
            t = Timer()
            fn(*args)
            total = t.tocr()
        finally:
            if old is None:
                os.environ.pop("HETPU_METRICS", None)
            else:
                os.environ["HETPU_METRICS"] = old
        stages = {}
        for line in f:
            ev = json.loads(line)
            if ev.get("event") == "timer" and ev.get("label"):
                stages[ev["label"]] = ev["seconds"]
    stages["total_wall_s"] = total
    return stages


# ----------------------------------------------------------------------
# sections
# ----------------------------------------------------------------------

def sec_keygen(device: str, small: bool) -> dict:
    """Keygen phases (reference matrix_operations.cpp:858-874), fresh
    seed, no key cache, each phase waited for."""
    out = {}
    for full, small_name in KEYGEN_PRESETS.items():
        name = small_name if small else full
        t = Timer()
        ctx = Context(preset(name), device)
        t1 = t.tocr(block_on=ctx.tables_full.q)
        kg = KeyGenerator(ctx)                       # fresh random seed
        t2 = t.tocr(block_on=kg.secret.data)
        pk = kg.create_public_key()
        t3 = t.tocr(block_on=pk.data)
        rk = kg.create_relin_keys()
        t4 = t.tocr(block_on=rk.key.data)
        gk = kg.create_galois_keys()                 # full ±2^i keyset
        t5 = t.tocr(block_on=gk.keys[-1].data)
        out[name] = {"context_s": t1, "secret_key_s": t2 - t1,
                     "public_key_s": t3 - t2, "relin_keys_s": t4 - t3,
                     "galois_keys_s": t5 - t4, "galois_elts": len(gk.elts),
                     "total_s": t5}
        print(f"  {name}: {out[name]}", flush=True)
    return out


def _demos(table: dict, names, device: str, small: bool) -> dict:
    out = {}
    for name in names:
        out[name] = run_demo_with_timers(table[name], small, device)
        print(f"  {name}: {out[name]}", flush=True)
    return out


def sec_workloads(device: str, small: bool) -> dict:
    from ..demos import matrix_operations as mo
    return _demos(mo.DEMOS, DEMOS, device, small)


def sec_fft(device: str, small: bool) -> dict:
    from ..demos import fft as fd
    return _demos(fd.DEMOS, ("fft", "bfft"), device, small)


def sec_sweep(device: str, small: bool) -> dict:
    """Chain-level op latency sweep at N=2^15 (the reference's 26 ladders,
    math_operations.cpp:614-619) at levels spanning the range, ms per op,
    each op chained and replayed from a captured step
    (``bench_he_all_chained``)."""
    from ..demos.math_operations import bench_he_all_chained
    from ..session import Session
    n, hi = (1 << 13, 6) if small else (1 << 15, 26)
    k, reps = (SMALL_K, 1) if small else (SWEEP_K, SWEEP_REPS)
    out = {}
    for lv, params in chain_sweep(n, 2, hi, sec_level=0 if small else 128):
        if lv not in SWEEP_LEVELS:
            continue
        sess = Session.create(params, galois_steps=[1], device=device)
        times = bench_he_all_chained(sess, k, reps)
        out[f"levels_{lv}"] = {op: s * 1e3 for op, s in times.items()}
        print(f"  levels={lv}: {out[f'levels_{lv}']} (ms)", flush=True)
        del sess
    return out


def matvec_operands(device: str, small: bool, rng):
    """BASELINE.json config 2's operands: a 64×64 matrix in diagonal
    layout and a vector, from ``rng``, encrypted on ckks_small (N=2^13)
    with rotation keys 1..63: (matrix, vector, their encryptions)."""
    from ..linalg import BatchedMatrix
    d = MATVEC_D
    dsess = cached_session("test_tiny" if small else "ckks_small",
                           seed=b"\x23" * 32, galois_steps=list(range(1, d)),
                           device=device)
    mat = rng.uniform(-1, 1, (d, d))
    vec = rng.uniform(-1, 1, d)
    return (mat, vec, BatchedMatrix.encrypt(dsess, mat, layout="diag"),
            BatchedMatrix.encrypt(dsess, vec[:, None], layout="col"))


def matvec_chain(bm, vb) -> Chain:
    """The whole 64-rotation matvec bm·v as one step, v's data XOR the
    tag."""
    from ..linalg import BatchedMatrix

    def mv_fn(vdata):
        v = BatchedMatrix(vb.sess, vb.ct.with_(data=vdata), rows=vb.rows,
                          cols=1, layout="col")
        return bm.matmul(v).ct.data
    return Chain(mv_fn, vb.ct.data, fold8, "enc_matvec64")


def matvec(device: str, small: bool, rng) -> dict:
    """enc matvec/s (config 2) and the product's decrypt error."""
    mat, vec, bm, vb = matvec_operands(device, small, rng)
    r = timed(matvec_chain(bm, vb), SMALL_K if small else MATVEC_K)
    report(r, program="workloads", chain="enc_matvec64",
           device=device_name(device))
    got = bm.matmul(vb).decrypt().real[:, 0]
    return {"enc_matvec64_n13_ops_per_s": 1 / r["seconds"],
            "enc_matvec64_max_err": float(np.abs(got - mat @ vec).max())}


def sec_secondary(device: str, small: bool) -> dict:
    """Rotation / hoisted-rotation / NTT throughput (:mod:`.secondary`),
    then enc matvec/s on the same rng."""
    sess = cached_session(secondary.SMALL_PRESET if small
                          else secondary.PRESET, seed=secondary.SEED,
                          device=device)
    rng = np.random.default_rng(0)
    out = secondary.measure(sess, secondary.SMALL_BATCH if small
                            else secondary.BATCH, rng, small)
    del sess
    out.update(matvec(device, small, rng))
    return out


def matmul128(device: str, small: bool) -> dict:
    """Config 3: 128×128 encrypted mat-mat product at N=2^14, L=8
    (reference scale-up of he_linalg.cpp:943-1006), in column chunks of 8
    (a hoisted rotation set over all 128 columns at once would need ~19 GB
    of rotated operands); ``compile_s`` is the first chunk alone, which
    builds every plan and kernel."""
    from ..linalg.batched import BatchedMatrix
    d, chunk = (16, 8) if small else (128, 8)
    sess = cached_session("test_dnum" if small else "bench_n14",
                          seed=b"\x31" * 32, galois_steps=list(range(1, d)),
                          device=device)
    rng = np.random.default_rng(3)
    A = rng.uniform(-1, 1, (d, d))
    Bm = rng.uniform(-1, 1, (d, d))
    ma = BatchedMatrix.encrypt(sess, A, layout="diag")
    mb = BatchedMatrix.encrypt(sess, Bm, layout="col")

    def chunk_fn(bdata):
        mbc = BatchedMatrix(sess, mb.ct.with_(data=bdata), rows=d,
                            cols=chunk, layout="col")
        return ma.matmul(mbc).ct
    t = Timer()
    t_first = t.tocr(block_on=chunk_fn(mb.ct.data[:chunk]).data)
    t = Timer()
    cols = [chunk_fn(mb.ct.data[j: j + chunk]) for j in range(0, d, chunk)]
    got = torch.cat([c.data for c in cols])
    dt = t.tocr(block_on=got)
    mc = BatchedMatrix(sess, cols[0].with_(data=got), rows=d, cols=d,
                       layout="col")
    err = float(np.abs(mc.decrypt().real - A @ Bm).max())
    return {"matmul_s": dt, "compile_s": t_first, "chunk": chunk,
            "max_err": err}


def bfft1024(device: str, small: bool) -> dict:
    """Config 4: the in-slot FFT of a length-1024 signal, batched over 64
    ciphertexts (he_fft.cpp:166-223 at 8x the reference's 128 points);
    1/n-normalised signals keep the spectrum O(1)."""
    from .. import fft as hefft
    rng = np.random.default_rng(3)
    n, nct = (64, 4) if small else (1024, 64)
    steps = sorted({s for h in [n >> (i + 1)
                                for i in range(n.bit_length() - 1)]
                    for s in (h, -h)})
    fs = cached_session("test_dnum" if small else "ckks_fft",
                        seed=b"\x32" * 32, galois_steps=steps, device=device)
    sig = (rng.uniform(-1, 1, (nct, n))
           + 1j * rng.uniform(-1, 1, (nct, n))) / n
    tile = fs.slots // n
    cts = [fs.encrypt(np.tile(sig[i], tile)) for i in range(nct)]
    ct = cts[0].with_(data=torch.stack([c.data for c in cts]))
    t = Timer()
    fout = hefft.bfft(fs, ct, n)
    dt = t.tocr(block_on=fout.data)
    errs = []
    for i in (0, nct // 2, nct - 1):
        got = fs.decrypt(fout.with_(data=fout.data[i]))[:n]
        want = hefft.bit_reverse_order(np.fft.fft(sig[i]))
        errs.append(np.abs(got - want).max())
    return {"bfft_s": dt, "n": n, "batch_cts": nct,
            "max_err": float(np.max(errs))}


def pipeline_infer(device: str, small: bool) -> dict:
    """Config 5: the inference pipeline step (enc matvec + activation
    polynomial) of a batch of 8, sharded over every rank of the default
    group (one without a process group); timed as hetpu times it, on the
    host clock around a synchronised call, since an exchange between
    ranks refuses CUDA graph capture."""
    from ..offload import pipeline
    from ..session import Session
    rng = np.random.default_rng(3)
    ps = Session.create("test_dnum" if small else "ckks_hi14",
                        seed=b"\x33" * 32, galois_steps=list(range(1, 8)),
                        device=device)
    vals = [rng.uniform(-1, 1, ps.slots) for _ in range(8)]
    cts = [ps.encrypt(v) for v in vals]
    nd = dist.get_world_size() if dist.is_initialized() else 1
    if device == "cuda":
        torch.cuda.synchronize()
    t = Timer()
    res = pipeline.evaluate_sharded_infer(ps, cts, wseed=7, n_diags=8)
    dt = t.tocr(block_on=[r.data for r in res])
    diags, act = pipeline._infer_weights(ps.slots, 8, 7)
    errs = [np.abs(ps.decrypt(r).real
                   - pipeline.infer_reference(v, diags, act)).max()
            for r, v in zip(res, vals)]
    return {"batch": 8, "n_diags": 8, "mesh_devices": nd, "wall_s": dt,
            "max_err": float(np.max(errs))}


def sec_baseline(device: str, small: bool) -> dict:
    """BASELINE.json configs 3-5."""
    out = {}
    for name, fn in (("matmul128_n14_L8", matmul128),
                     ("bfft1024_x64_n14", bfft1024),
                     ("pipeline_infer_n14", pipeline_infer)):
        out[name] = fn(device, small)
        print(f"  {name}: {out[name]}", flush=True)
    return out


SECTIONS = {
    "keygen": sec_keygen,
    "workloads": sec_workloads,
    "fft": sec_fft,
    "sweep": sec_sweep,
    "secondary": sec_secondary,
    "baseline": sec_baseline,
}


def run(only: str | None, out: Path, small: bool, device: str) -> dict:
    """Run every section (or ``only``), each merged into ``out`` when it
    finishes; returns the sections' payloads."""
    done = {}
    for name in [only] if only else list(SECTIONS):
        print(f"[bench_workloads] section {name} ...", flush=True)
        t = Timer()
        done[name] = SECTIONS[name](device, small)
        merge(out, name, done[name], device, small)
        print(f"[bench_workloads] {name} done in {t.tocr():.1f}s",
              flush=True)
    return done
