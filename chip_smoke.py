#!/usr/bin/env python3
"""Smoke run of hetpu_torch's main path on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order (each prints one line; any failure raises and the run
exits non-zero without a result line):

  1. device — needs CUDA; prints the card's name and power limit;
  2. build  — compiles hetpu_torch/csrc/*.cu with nvcc into
     build/hetpu_torch/ (at first use; rebuilt when the sources change);
  3. NTT golden — the ``ntt`` kernel forward and inverse on the 14-prime
     N=2^14 basis of tests/golden/golden_n14.npz, bit-exact;
  4. kernel vs plain — each of the four kernels against its plain PyTorch
     version on the same CUDA inputs at the bench_n14 B=8 shapes, exact
     (torch.equal), with per-call times (CUDA events around 20
     back-to-back calls, median of 5 windows; a kernel shorter than its
     wrapper's host time is host-bound in this measure);
  5. slice golden — Session "test_dnum" (seed 0x33) on the card,
     multiply_relin_rescale on golden_pins fused_a/fused_b = fused_out;
  6. main path — Session.create("bench_n14", seed 0x21) on the card,
     encrypt x and y at B=8, multiply_relin_rescale, decrypt: max error
     against x·y < 2e-3; the B=1 output equals the plain path on the CPU
     with the same keys and inputs; every kernel was launched;
  7. time — the op at B=8 over 200 iterations (CUDA events) → ops/s.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
Imports only hetpu_torch, torch and numpy (no JAX, no hetpu).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from hetpu_torch.core import cuda_lib, fused_ntt, ip_kernel
from hetpu_torch.core.ciphertext import Ciphertext
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import from_u32, shoup_companion, to_u32
from hetpu_torch.core.ntt import (build_tables, ntt_fwd, ntt_fwd_plain,
                                  ntt_inv, ntt_inv_plain)
from hetpu_torch.core.params import preset
from hetpu_torch.session import Session

GOLD = Path(__file__).resolve().parent / "tests" / "golden"
B = 8
LEVEL = 8                      # bench_n14's top level: 9 data primes
TIMED_RUNS = 20
OP_ITERS = 200


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def median_ms(fn, runs: int = TIMED_RUNS, samples: int = 5) -> float:
    """Per-call ms: CUDA events around ``runs`` back-to-back calls, the
    median over ``samples`` such windows, after two warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / runs)
    return statistics.median(times)


def residues(rng, shape, primes, device="cuda") -> torch.Tensor:
    """Uniform residues [..., L, N] below the per-limb primes."""
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % q
    return from_u32(x, device)


def compare(name, kernel_fn, plain_fn) -> dict:
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel differs from plain "
                             f"({bad} elements)")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    return {"max_abs_err": float(err), "ms": median_ms(kernel_fn),
            "plain_ms": median_ms(plain_fn)}


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build() -> None:
    t0 = time.perf_counter()
    so = cuda_lib.build()
    cuda_lib.lib()
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 3), library=so.name,
        ptxas=ptxas)


def phase_ntt_golden() -> None:
    z = np.load(GOLD / "golden_n14.npz")
    primes = tuple(int(p) for p in z["ntt_n14_primes"])
    t = build_tables(z["ntt_n14_x"].shape[-1], primes, "cuda")
    x = from_u32(z["ntt_n14_x"], "cuda")
    fwd = to_u32(ntt_fwd(x, t))
    inv = to_u32(ntt_inv(x, t))
    if not (np.array_equal(fwd, z["ntt_n14_fwd"])
            and np.array_equal(inv, z["ntt_n14_inv"])):
        raise AssertionError("ntt kernel differs from golden_n14")
    log("ntt_golden", primes=len(primes), n=t.n, exact=True)


def phase_kernels(rng) -> dict:
    ctx = Context(preset("bench_n14"), "cuda")
    n = ctx.params.poly_degree
    tabs = ctx.tables(LEVEL)
    ks = ctx.keyswitch_plan(LEVEL)
    mdr = ctx.moddown_rescale_plan(LEVEL)
    out = {}

    x = residues(rng, (B, LEVEL + 1, n), tabs.primes)
    out["ntt_inv"] = compare(
        "ntt inverse strip+extra",
        lambda: ntt_inv(x, tabs, strip_mont=True, extra=ks.dig_inv),
        lambda: ntt_inv_plain(x, tabs, strip_mont=True, extra=ks.dig_inv))
    out["ntt_fwd"] = compare(
        "ntt forward to_mont",
        lambda: ntt_fwd(x, tabs, to_mont=True),
        lambda: ntt_fwd_plain(x, tabs, to_mont=True))

    lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.foreign_cat_tables)
    out["ntt_fwd_lifted"] = compare(
        "ntt_fwd_lifted",
        lambda: fused_ntt.ntt_fwd_lifted(x, *lift),
        lambda: fused_ntt.ntt_fwd_lifted_plain(x, *lift))

    u = residues(rng, (B, 2, len(mdr.src_tables.primes), n),
                 mdr.src_tables.primes)
    out["ntt_fwd_fbc"] = compare(
        "ntt_fwd_fbc",
        lambda: fused_ntt.ntt_fwd_fbc(u, mdr.fbc, mdr.dst_tables),
        lambda: fused_ntt.ntt_fwd_fbc_plain(u, mdr.fbc, mdr.dst_tables))

    R = len(ks.basis_tables.primes)
    J = ks.num_digits
    ext = residues(rng, (B, J, R, n), ks.basis_tables.primes)
    k = residues(rng, (J, 2, R, n), ks.basis_tables.primes)
    k_sh = shoup_companion(k, ks.q)
    out["inner_product"] = compare(
        "inner_product",
        lambda: ip_kernel.inner_product(ext, k, k_sh, ks.q),
        lambda: ip_kernel.inner_product_plain(ext, k, k_sh, ks.q))
    for name, r in out.items():
        log("kernel_vs_plain", kernel=name, **r)
    return out


def phase_slice_golden() -> None:
    z = np.load(GOLD / "golden_pins.npz")
    sess = Session.create("test_dnum", seed=b"\x33" * 32, galois_steps=[1],
                          device="cuda")
    proto = sess.encrypt(0.0)
    a = proto.with_(data=from_u32(z["fused_a"], "cuda"))
    b = proto.with_(data=from_u32(z["fused_b"], "cuda"))
    got = to_u32(sess.ev.multiply_relin_rescale(a, b, sess.rk).data)
    if not np.array_equal(got, z["fused_out"]):
        raise AssertionError(f"fused_out differs in "
                             f"{int((got != z['fused_out']).sum())} elements")
    log("slice_golden", preset="test_dnum", exact=True)


def stack(cts) -> Ciphertext:
    return cts[0].with_(data=torch.stack([c.data for c in cts]))


def phase_main_path(rng):
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    sess = Session.create("bench_n14", seed=b"\x21" * 32, galois_steps=[1],
                          device="cuda")
    x = rng.uniform(-1, 1, (B, sess.slots))
    y = rng.uniform(-1, 1, (B, sess.slots))
    a = stack([sess.encrypt(v) for v in x])
    b = stack([sess.encrypt(v) for v in y])
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    dec = sess.decrypt(out).real
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    seconds = time.perf_counter() - t0
    if out.data.shape != (B, 2, LEVEL, sess.ctx.params.poly_degree) \
            or not np.isfinite(dec).all():
        raise AssertionError(f"bad output shape {tuple(out.data.shape)}")
    err = float(np.abs(dec - x * y).max())
    if not err < 2e-3:
        raise AssertionError(f"bench_n14 decrypt error {err} >= 2e-3")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # B=1: the card's output equals the plain path on the CPU (same keys,
    # same inputs) and row 0 of the batched output
    a1 = a.with_(data=a.data[0].contiguous())
    b1 = b.with_(data=b.data[0].contiguous())
    out1 = sess.ev.multiply_relin_rescale(a1, b1, sess.rk).data.cpu()
    ev_cpu = Evaluator(Context(sess.ctx.params, "cpu"))
    ref1 = ev_cpu.multiply_relin_rescale(a1.to("cpu"), b1.to("cpu"),
                                         sess.rk.to("cpu")).data
    if not torch.equal(out1, ref1):
        raise AssertionError("B=1 output differs from the CPU plain path")
    if not torch.equal(out1, out.data[0].cpu()):
        raise AssertionError("B=1 output differs from row 0 of B=8")
    log("main_path", preset="bench_n14", batch=B, max_err=err,
        seconds=round(seconds, 3), launches=launches, cpu_plain_equal=True)
    return sess, a, b, launches


def phase_time(sess, a, b, smi: str) -> float:
    ev, rk = sess.ev, sess.rk
    for _ in range(5):
        ev.multiply_relin_rescale(a, b, rk)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(OP_ITERS):
        ev.multiply_relin_rescale(a, b, rk)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / OP_ITERS
    ops = B * 1000.0 / ms
    log("time", op="multiply_relin_rescale", preset="bench_n14", batch=B,
        iters=OP_ITERS, ms_per_call=ms, ops_per_s=ops, card=smi)
    return ops


KERNELS = [
    ("ntt", "hetpu_torch/csrc/ntt.cu", "hetpu/core/mxu_ntt.py:710",
     ("ntt_inv", "ntt_fwd")),
    ("ntt_fwd_lifted", "hetpu_torch/csrc/fused_ntt.cu",
     "hetpu/core/mxu_ntt.py:816", ("ntt_fwd_lifted",)),
    ("ntt_fwd_fbc", "hetpu_torch/csrc/fused_ntt.cu",
     "hetpu/core/mxu_ntt.py:816", ("ntt_fwd_fbc",)),
    ("inner_product", "hetpu_torch/csrc/ip_kernel.cu",
     "hetpu/core/ip_kernel.py:75", ("inner_product",)),
]


def main() -> int:
    name, smi = phase_device()
    rng = np.random.default_rng(2024)
    phase_build()
    phase_ntt_golden()
    timings = phase_kernels(rng)
    phase_slice_golden()
    sess, a, b, main_launches = phase_main_path(rng)
    phase_time(sess, a, b, smi)
    rows = []
    for kname, src, replaces, cases in KERNELS:
        # the ntt kernel reports its inverse case (the main path runs it
        # twice per op); the forward case is in the kernel_vs_plain lines
        r = timings[cases[0]]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": main_launches[kname],
                     "max_abs_err": max(timings[c]["max_abs_err"]
                                        for c in cases),
                     "ms": r["ms"], "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
