#!/usr/bin/env python3
"""Smoke run of hetpu_torch's paths on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, in order (each prints one JSON line; any failure raises and the
run exits non-zero without a result line):

  1. device — needs CUDA; prints the card's name and power limit;
  2. build  — compiles hetpu_torch/csrc/*.cu with nvcc (one process per
     source, in parallel) into build/hetpu_torch/ (at first use; rebuilt
     when the sources change);
 19. parallel (right after the build, so that the spawned ranks only load
     the library) — 2 and then 4 processes on cuda:0 (gloo group, file
     store under build/chip_smoke_ranks/): P5 ``peer_permute`` against
     its gloo twin at the snippet's [8,128] f32 and the butterfly's
     [2,13,N] int32, each exchange timed as a latency (between two syncs)
     and back to back (one sync after 20); the store and signal alone
     timed on rank 0 (eager, cold, and cudaMemcpyAsync into the mapped
     peer buffer as the library yardstick; the twin on the host clock);
     64 exchanges with no host sync between them, one rank asleep 50 ms
     before its 10th, each equal to its twin (the stress sequence of
     tests/torch_parallel_ranks.py); an exchange refuses CUDA graph
     capture; then the parallel path, launches counted around it:
     tp_relinearize and tp_rotate(1) at bench_n14 level 7, cp_ntt_fwd /
     cp_ntt_inv over the 9 data primes, bucketed_matvec d=8 and, at 2
     ranks, evaluate_sharded_infer B=8 — each equal to its single-rank
     result on the card; the 2 ranks then serve this process's
     run_client_infer (bench_n14, B=8, error < 5e-3); here, the
     bucketed ciphertexts at rot 2 and 4 equal rot 1's and decrypt within
     1e-2 of A·v, and evaluate_sharded_infer with no mesh equals
     infer_step.  infer_step alone, and evaluate_sharded_infer at dp 1 and
     2, are timed over 5 calls (median, least, most); ``kernel_ab.py
     --parallel`` sets them beside a parent tree's.  The ranks share one
     card: their times are one card's, not scaling;
  3. NTT golden — the ``ntt`` kernel forward and inverse on the 14-prime
     N=2^14 basis of tests/golden/golden_n14.npz, bit-exact;
  4. kernel vs plain — each of the six kernels against its plain PyTorch
     version on the same CUDA inputs at the bench_n14 B=8 shapes, exact
     (torch.equal), with per-call times (ms: CUDA events around 20
     back-to-back eager calls, median of 5 windows; a kernel shorter than
     its wrapper's host time is host-bound in this measure), one call
     replayed from a CUDA graph with L2 flushed before it (graph_ms, median
     of 10: the device's time alone, inputs from device memory) and the
     least time the card could take (bytes read once and written once over
     3.35 TB/s, or for K1, K2, K3 and K6 the 32-bit multiplies they need
     over 64 lanes an SM at the SM clock nvidia-smi reports as
     clocks.max.sm, where larger: 3 a Shoup product of the butterflies and
     epilogue, and for the fused prologues one a term and one reduction a
     residue); K1 also at the rescale's one-limb INTT [8,2,1,N], the
     mod-down INTT [8,2,5,N] and the probes' 288 planes [32,9,N], K3 at
     the tail [8,2,6,N]→[8,2,8,N] and the mod-down [8,2,5,N]→[8,2,9,N];
     K6 ``ntt_fwd_centered`` (K5's path form: the centered conversion
     fused with the forward NTT) at the centered lift [8,9,N]→[8,19,N],
     the tail and the mod-down; K5 ``centered_fbc`` at its four bench_n14
     shapes (tail, the lifts of digits 0 and 1, mod-down), and exact only
     at S 1 / 6 / 16 by F 1 / 8 / 25 by 1 / 3 / 16 rows, with and without
     α and ``extra``; K3, K5 and K6 also on near-tie α columns
     built here for the bench_n14 tail plan (columns where an fma chain
     and a multiply-then-add chain round α differently); then the shapes
     of the BFV path at bfv_batch's top level (K1 [8,2,7,N], [8,3,7,N]
     over Q, [8,2,10,N], [8,3,10,N] over the auxiliary basis, [1,N] over a
     t factor; K2 and the K6 lift [8,7,N]→[8,29,N] with a short last
     digit; K3 and K6 mod-down [8,2,2,N]→[8,2,7,N]; K4 at J=4, R=9) and of
     the paired-prime path at ckks_hi14's top level (K1 [8,2,2,N] and
     [8,2,5,N]; K3 and K6 pair [8,2,2,N]→[8,2,10,N] and fused tail
     [8,2,5,N]→[8,2,10,N]); K4 also, exact only, at batches 1, 3, 8, 64
     by digits 1, 2, 7, 27 ([B,J,9,2^13], ragged batch tiles); then the
     application paths' top-level shapes:
     ckks_deep_hi (N=2^15, 25 data primes, J=7, R=29) and ckks_deep
     (N=2^15, 16 data primes, J=4, R=20) at one row, ckks_fft at 64 rows
     (K1 decompose INTT, forward NTT over the data primes and over the key
     basis, mod-down INTT; K2 and the K6 lift; K3 and K6 mod-down, fused
     tail and, at g=2, pair; K4);
  5. goldens — Session "test_dnum" (seed 0x33) on the card:
     multiply_relin_rescale on golden_pins fused_a/fused_b = fused_out and
     rotate by 1 = fused_rot; golden_n14 rs_n14 through Evaluator.rescale;
     BfvSession "test_bfv_crt" (seed 0x34): multiply_relin of bfv_a/bfv_b
     = bfv_out;
  6. main path — Session.create("bench_n14", seed 0x21) on the card,
     encrypt x and y at B=8, multiply_relin_rescale, decrypt: max error
     against x·y < 2e-3; the B=1 output equals the plain path on the CPU
     with the same keys and inputs; K1–K4 were launched;
  7. time — that op at B=8 over 200 iterations (CUDA events) → ops/s;
  8. inference path — Session.create("bench_n14", seed 0x21,
     galois_steps 1..7): infer_step (8 diagonals, weight seed 7) on B=8
     encrypted vectors, decrypt: max error against infer_reference < 5e-3;
     the B=1 output equals the CPU plain path; K1–K4 launched, K6 not.
     Then the same with centered_fbc=True (Session.from_wire on the same
     keys): error < 5e-3, B=1 equal to the CPU plain path, K6 launched,
     K2, K3 and the standalone K5 not, and no more K1 launches than the
     default path (no forward NTT after a conversion);
  9. time — infer_step at B=8 in both FBC modes (ms per call,
     vectors/s), rotate(ct, 1) at B=8, and multiply_relin_rescale with
     centered_fbc=True beside the default;
 10. profile — torch.profiler over 5 infer_step calls in each mode: device
     time per call by kernel (K1–K6, the plain PyTorch kernels by name),
     device kernels per call, and the device's busy share of the wall time;
 11. BFV path — BfvSession.create("bfv_batch", seed 0x35, galois_steps
     [1]): B=8 slot vectors mod t through multiply_relin, rotate_rows(1)
     and mod_switch, each row decrypted exactly (Python ints), noise
     budget > 0, the B=1 output equal to the CPU plain path, K1–K4
     launched; multiply_relin timed (ops/s) and profiled, with the
     precise-α conversions' device time and kernels;
 12. paired-prime path — Session.create("ckks_hi14", seed 0x36) at B=8 in
     both FBC modes: fused multiply_relin_rescale within 2e-9 of x·y (see
     HI_ERR), the standalone rescale(relinearize(multiply)) within 1e-9
     of it, B=1 equal to the CPU plain path, K3 (default) or K6
     (centered, no K2 or K3) launched, both ops timed;
 13. wire — every blob kind of core/serial round-trips on the card, and a
     from_wire session on the loaded keys gives phase 6's bits;
 14. least squares — least_squares_2d as hetpu/demos/matrix_operations.py
     runs it (ckks_deep_hi, seed 0x77, galois steps 1, 2, 4, 5 points from
     rng(0), inv_iters 6): a and b within 2^-10 of the closed form; wall
     seconds, launches, and a profile of two fits (device busy share);
 15. matmul128 — scripts/bench_workloads.py's config 3: bench_n14 (seed
     0x31, galois steps 1..127), BatchedMatrix diag×col 128×128 from
     rng(3) in chunks of 8 columns, within 5e-3 of A@B; seconds for the
     whole product, peak device memory, a profile of one chunk;
 16. bfft1024x64 — config 4: ckks_fft (seed 0x32), the in-slot FFT of 64
     ciphertexts of 1024 points, rows 0, 32, 63 within 1e-2 of the
     bit-reversed numpy.fft.fft; seconds of a first and a cached call;
 17. server — the port's Client against serve_once on the card in a
     thread over runtime.native.pipe_pair (hetpu/demos/offload_demos.py's
     rookie harness), the seven workloads at the demos' presets and inputs
     (twice_max on tests/test_math.py's inputs: the demo's leave the |·|
     Newton basin), each error within its stated bound, round-trip
     seconds, launches and the transport that served; then at the --small
     presets, the card server's reply frames equal the CPU server's byte
     for byte on the same request frames;
 18. probes — the micro-benchmark kernels P1 copy_planes, P2 muladd_u32,
     P3 dot_i8 and P4 plane_parts against their plain versions at each
     probe's own shapes, exact (P3 on all four u8/s8 pairs at [128,256]@
     [256,128], then [512,512]@[512,128] and 288 planes; P4 in all six
     variants, and exact only at rows 1, 5, 32 by limbs 1, 3, 9 with the
     extreme int32 values), timed as in phase 4 with the bound (bytes, or int8
     tensor-core operations over 1,979 TOP/s where larger) and the library
     call where one computes the same function (Tensor.copy_ for P1,
     torch._int_mm for s8×s8 P3), both timed as ms and graph_ms; P4's
     extract, twiddle and recomb also time their plain version as
     graph_ms (plain_graph_ms); then every probe through its entry point
     (hetpu_torch.probes.run: eager and CUDA-graph chains) and
     kernel_micro on phase 6's session; last, the host's time per call of
     each probe wrapper on one plane, of K1 at the rescale's INTT
     [8,2,1,N] and of K3 and K6 at the tail (host clock);
 20. demos — every suite and name of ``python -m hetpu_torch.demos`` at
     full size, through the CLI's ``main`` in this process, from a fresh
     key cache in build/chip_smoke_keys (``keycache.CACHE_DIR``): one line a
     demo with its preset, seconds, Timer lines, launches, peak device
     memory and checked values (BFV: every ``exact:`` True, every noise
     budget > 0; the 2^-10 asserts of least_squares_2d,
     batched_matmul_ckks, fft and bfft; op and sum_elems within 1e-3,
     batch_matmul_ckks within 1e-2; bench_rot within ROT_BOUND, the
     slot-0 bias of the uncentered key switch; the client workloads
     within phase 17's bounds, twice_max only finishing), K1–K4 launched
     by every demo that switches a key; the level sweep (``bench_all``:
     N=2^15, levels 2..26, one special prime) eager from the CLI and,
     per level, ``bench_he_all_chained`` from CUDA graphs (one chained
     step captured, replayed 128 times), with J and R; one TCP pair at
     --small (``server simple`` as a process, ``client simple`` here once
     it listens); then K1–K4 (and K6) against their plain versions at the
     demos' new shapes: the sweep's level 26 (J=27, R=28), ckks_hi at the
     64×64 matmul's 64 rows, the fft demo's pair rescale of 128 ckks_fft_hi
     ciphertexts, bfv_matpow's multiply (8 rows) and relinearize (4).
 21. bench — ``python -m hetpu_torch.bench`` (hetpu's bench.py,
     scripts/bench_secondary.py and scripts/bench_workloads.py) through
     its CLI's ``main`` in this process: headline at its defaults
     (bench_n14, B=8, K=1536, reps 2: one captured step replayed 3,072
     times, and 1,536 eager steps), secondary at its full sizes, and
     workloads' keygen and secondary sections into
     build/chip_smoke_bench.json; hetpu's metric names and units, every
     value finite and positive, no device memory grown over the replays,
     K1-K4 launched by each program (keygen: K1), the record's meta
     naming the card, enc_matvec64_max_err < 1e-2 (hetpu's
     tests/test_linalg.py:83); then, at bench_n14 B=8, the tag and last
     output after 2 chained steps of multiply_relin_rescale, rotate(·, 1)
     and rotate_hoisted, and of the 64-rotation matvec at ckks_small,
     equal the same 2 steps replayed from the captured step, and for the
     first two the same chain on the CPU (plain twins), bit for bit.
 22. profiles — hetpu's op-profiling programs through the same CLI at the
     scripts' sizes: profile_fused (bench_n14 B=32, K=16, best of 3),
     op_parts_chain (B=32 and 64), bench_sweep (B 32 and 64 x K 8 and
     32), probe_n15b (ckks_deep_hi B=1), probe_lsq_twice and trace_op (2
     traced steps); every label that the script passes to chain, timeit
     or direct (its printed lines where it has none, read from
     scripts/<name>.py) printed, no device memory grown over any replays,
     K1-K4 launched by each, the lsq fit's max_err within 2^-10, each
     record written under build/hetpu_torch/ naming the card; then every
     chain of profile_fused, profile_hotpath, op_parts_chain,
     bench_sweep, probe_n15, probe_n15b and trace_op at its script's size
     leaves, after its K eager steps, the tag and last output of its K
     replays from the captured step, bit for bit.

Launch counts are zeroed just before each path and read just after it
(a CUDA graph's replay counts the kernels its capture recorded); the
``kernels`` line reports each kernel's launches on the inference path
(K5, K6: on its centered run, where the standalone K5 reads 0; P1–P4: on
the probes' run; P5: on the parallel path of rank 0 of 2) and, under
``launches_by_path``, on every path (the BFV multiply_relin and chain,
each paired-prime op in each mode, least squares, matmul128,
bfft1024x64, each server workload, the demos and the bench programs),
its eager ``ms`` and cold-L2 ``graph_ms``, the library call's eager ms,
and under ``cases`` the times of each shape it was compared at.  A
``total`` line gives the run's seconds.  The last line is
{"ok": true, "device": {"platform": "gpu", ...}}.
Imports only hetpu_torch, torch and numpy (no JAX, no hetpu).
``kernel_ab.py`` reuses its K1/K2/K3/K6 cases, host timing and profile
reduction to compare two checkouts.
"""

from __future__ import annotations

import ast
import contextlib
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from hetpu_torch.bench import (bench_sweep, op_parts_chain, probe_n15,
                               profile_fused, profile_hotpath, trace_op)
from hetpu_torch.bench import headline as bench_headline
from hetpu_torch.bench import secondary as bench_secondary
from hetpu_torch.bench import workloads as bench_workloads
from hetpu_torch.bench.__main__ import main as bench_main
from hetpu_torch.bfv import BfvSession
from hetpu_torch.core import (centered_fbc, cuda_lib, fused_ntt, ip_kernel,
                              nt, serial)
from hetpu_torch.core.bfv import BfvScheme
from hetpu_torch.core.centered_fbc import CenteredFbcPlan
from hetpu_torch.core.ciphertext import Ciphertext
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.keys import KeyGenerator
from hetpu_torch.core.modular import from_u32, shoup_companion, to_u32
from hetpu_torch.core.ntt import (build_tables, ntt_fwd, ntt_fwd_mont,
                                  ntt_fwd_plain, ntt_inv, ntt_inv_plain)
from hetpu_torch.core.params import chain_sweep, preset
from hetpu_torch.core.rns import fbc_apply
from hetpu_torch.demos.__main__ import main as demos_main
from hetpu_torch.demos.math_operations import bench_he_all_chained
from hetpu_torch.demos.offload_demos import CLIENT_DEMOS, _params_for
from hetpu_torch import parallel, probes
from hetpu_torch.fft import bfft, bit_reverse_order
from hetpu_torch.linalg import BatchedMatrix
from hetpu_torch.models.least_squares import least_squares_2d
from hetpu_torch.offload import pipeline, recv_request, send_reply
from hetpu_torch.offload.client import Client
from hetpu_torch.offload.server import handle, serve_once
from hetpu_torch.probes import copy as copy_probe
from hetpu_torch.probes import dot, kernel_parts, overhead2
from hetpu_torch.runtime import native
from hetpu_torch.session import Session
from hetpu_torch.utils import keycache

GOLD = Path(__file__).resolve().parent / "tests" / "golden"
B = 8
LEVEL = 8                      # bench_n14's top level: 9 data primes
BFV_LEVEL = 6                  # bfv_batch's top level: 7 data primes
HI_LEVEL = 11                  # ckks_hi14's top level: 12 data primes
# ckks_hi14's bound on a product's decrypt error.  The error is the pair
# rescale's rounding u0 + u1·s.  In a slot it is U(ζ)·S(ζ), the rounding's
# evaluation times the secret's, whose standard deviation grows as N at a
# fixed scale (1.55e-10 for a real part at N=2^14, scale 2^44) and whose
# tail is heavy (S(ζ) is the same in every row), so the largest of B·N/2
# slots lands near 1e-9.  tests/test_hiprec.py's 1e-9 is set at N=2^10.
HI_ERR = 2e-9
HI_SAME = 1e-9                 # fused against standalone (test_hiprec.py)
TIMED_RUNS = 20
OP_ITERS = 200
INFER_ITERS = 50
PROFILE_ITERS = 5
BFV_ITERS = 50
HI_ITERS = 50
N_DIAGS, WSEED = 8, 7
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
INT8_OPS_PER_S = 1.979e15      # H100 SXM int8 tensor cores, dense (data sheet)
INT32_LANES_PER_SM = 64        # Hopper SM: 32-bit integer multiply lanes
IMUL_PER_SHOUP = 3             # __umulhi, x*w, qe*q
HOST_CALLS = 200               # calls enqueued back to back by host_us
imul_per_s = 0.0               # set by phase_device from the SM clock


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def calls_ms(fn, runs: int, warmup: int = 3) -> float:
    """ms per call of ``runs`` back-to-back eager calls (CUDA events
    around them), after ``warmup`` calls and a synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    return probes.window_ms(lambda: [fn() for _ in range(runs)]) / runs


def median_ms(fn, runs: int = TIMED_RUNS, samples: int = 5) -> float:
    """Per-call ms: the median of ``samples`` windows of ``runs``
    back-to-back calls, after two warm-up calls."""
    return statistics.median(calls_ms(fn, runs, 2 if i == 0 else 0)
                             for i in range(samples))


def residues(rng, shape, primes, device="cuda") -> torch.Tensor:
    """Uniform residues [..., L, N] below the per-limb primes."""
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % q
    return from_u32(x, device)


def bound_ms(*tensors) -> float:
    """Least time for the card to read every input once and write every
    output once at the device-memory rate."""
    return sum(t.numel() * t.element_size() for t in tensors) \
        / HBM_BYTES_PER_S * 1e3


def compare(name, kernel_fn, plain_fn, io, ops: float = 0, imul: float = 0,
            library=None, plain_graph: bool = False) -> dict:
    """Kernel vs plain version on the same inputs (exact), both timed
    eagerly (ms), the kernel also replayed with L2 cold (graph_ms);
    ``io`` lists the kernel's input tensors, its output is added.  The
    bound is the largest of the bytes over the memory rate, ``ops`` int8
    tensor-core operations over their peak and ``imul`` 32-bit integer
    multiplies over the SMs' multiply lanes at the maximum SM clock.  ``library``: (fn,
    as_out) — one PyTorch call computing the same function, timed both
    ways, and ``as_out`` mapping its result to the kernel's layout for a
    check.  ``plain_graph``: the plain version replayed too."""
    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else -1
        raise AssertionError(f"{name}: kernel differs from plain "
                             f"({bad} elements)")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
    by_bytes = bound_ms(*io, got)
    by_ops = max(ops / INT8_OPS_PER_S, imul / imul_per_s if imul else 0) * 1e3
    r = {"max_abs_err": float(err), "ms": median_ms(kernel_fn),
         "graph_ms": probes.cold_ms(kernel_fn),
         "plain_ms": median_ms(plain_fn), "bound_ms": max(by_bytes, by_ops),
         "bound_by": "operations" if by_ops > by_bytes else "bytes",
         "library_ms": None, "shape_in": list(io[0].shape),
         "shape_out": list(got.shape)}
    if imul:
        r["imul_bound_ms"] = imul / imul_per_s * 1e3
        r["bytes_bound_ms"] = by_bytes
    if plain_graph:
        r["plain_graph_ms"] = probes.cold_ms(plain_fn)
    if library is not None:
        fn, as_out = library
        r["library_equal"] = bool(torch.equal(as_out(fn()), want))
        r["library_ms"] = median_ms(fn)
        r["library_graph_ms"] = probes.cold_ms(fn)
    return r


def plan_tensors(plan: CenteredFbcPlan) -> list:
    names = ["q_src", "recip", "c", "c_shoup", "q_dst"]
    names += ["p_mod", "p_mod_shoup"] if plan.has_alpha else []
    names += ["extra", "extra_shoup"] if plan.has_extra else []
    return [getattr(plan, n) for n in names]


# ----------------------------------------------------------------------
# near-tie α columns (numpy: an fma chain against a multiply-then-add chain)
# ----------------------------------------------------------------------

def _fma32(a, b, c):
    """float32 a·b + c with one rounding (float64 product + TwoSum)."""
    p = a.astype(np.float64) * b.astype(np.float64)
    s = c.astype(np.float64)
    hi = p + s
    z = hi - p
    lo = (p - (hi - z)) + (s - z)
    f = hi.astype(np.float32)
    g = np.nextafter(f, np.where(hi > f, np.float32(np.inf),
                                 np.float32(-np.inf)).astype(np.float32))
    tie = (f.astype(np.float64) + g.astype(np.float64)) == 2 * hi
    return np.where(tie & (lo != 0) & ((lo > 0) == (g > f)), g, f)


def _alphas(v, recip):
    s = np.zeros(v.shape[1], np.float32)
    m = np.zeros(v.shape[1], np.float32)
    for i in range(v.shape[0]):
        x = v[i].astype(np.int32).astype(np.float32)
        s = _fma32(x, np.full_like(x, recip[i]), s)
        m = (m + x * recip[i]).astype(np.float32)
    return np.rint(s), np.rint(m)


def near_tie_columns(primes, centered: bool, count: int, seed: int):
    """``count`` columns of residues [S, count] whose α (over the values,
    or over their centered forms) rounds differently in an fma chain and
    in a multiply-then-add chain: the last value is solved so that the sum
    lands on a half, then a window around it is searched."""
    q = np.array(primes, dtype=np.int64)
    recip = (1.0 / q.astype(np.float64)).astype(np.float32)
    lo_v = -(q // 2) + 1 if centered else np.zeros_like(q)
    hi_v = q // 2 if centered else q - 1
    rng = np.random.default_rng(seed)
    cols = []
    while len(cols) < count:
        head = np.array([rng.integers(lo_v[i], hi_v[i] + 1)
                         for i in range(len(q) - 1)])
        part = float((head / q[:-1]).sum())
        ks = np.arange(np.ceil(part + lo_v[-1] / q[-1] - 0.5),
                       np.floor(part + hi_v[-1] / q[-1] - 0.5) + 1)
        if not len(ks):
            continue
        c = int(round((rng.choice(ks) + 0.5 - part) * q[-1]))
        last = np.arange(max(c - 4096, lo_v[-1]), min(c + 4096, hi_v[-1]) + 1)
        v = np.concatenate([np.repeat(head[:, None], len(last), 1),
                            last[None]])
        a, m = _alphas(v, recip)
        hit = np.nonzero(a != m)[0]
        if len(hit):
            cols.append(v[:, hit[rng.integers(len(hit))]] % q)
    return np.stack(cols, axis=1).astype(np.uint32)


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------

def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def phase_device() -> tuple[str, str]:
    global imul_per_s
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    name = torch.cuda.get_device_name(0)
    smi = _smi("name,power.limit")
    clock = _smi("clocks.max.sm")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    imul_per_s = INT32_LANES_PER_SM * sms * float(clock.split()[0]) * 1e6
    log("device", name=name, nvidia_smi=smi, count=torch.cuda.device_count(),
        sms=sms, clocks_max_sm=clock, int32_mul_per_s=imul_per_s,
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


def ntt_cases(rng, ctx) -> dict:
    """K1 at the bench_n14 B=8 shapes of the main path: (x, tables,
    keyword arguments) by case."""
    n = ctx.params.poly_degree
    tabs = ctx.tables(LEVEL)
    ks = ctx.keyswitch_plan(LEVEL)
    md = ks.moddown
    rs = ctx.rescale_plan(LEVEL).src_tables
    x = residues(rng, (B, LEVEL + 1, n), tabs.primes)
    return {
        # decompose INTT [8,9,N] and the forward NTT ×R of the same shape
        "ntt_inv": (x, tabs, dict(strip_mont=True, extra=ks.dig_inv)),
        "ntt_fwd": (x, tabs, dict(to_mont=True)),
        # rescale's one-limb INTT [8,2,1,N]
        "ntt_inv_rescale": (residues(rng, (B, 2, 1, n), rs.primes), rs,
                            dict(strip_mont=True)),
        # the probes' 288 planes [32,9,N] (kernel_micro)
        "ntt_fwd_288": (residues(rng, (32, LEVEL + 1, n), tabs.primes), tabs,
                        dict(to_mont=True)),
        # mod-down INTT of the special limbs [8,2,5,N]
        "ntt_inv_moddown": (residues(rng, (B, 2, len(md.src_tables.primes), n),
                                     md.src_tables.primes), md.src_tables,
                            dict(strip_mont=True, extra=md.fbc.inv_punit)),
    }


def fbc_cases(rng, ctx) -> dict:
    """K3 at the tail [8,2,6,N]→[8,2,8,N] and the mod-down
    [8,2,5,N]→[8,2,9,N]: (u, plan, target tables) by case."""
    n = ctx.params.poly_degree
    mdr = ctx.moddown_rescale_plan(LEVEL)
    md = ctx.keyswitch_plan(LEVEL).moddown
    out = {}
    for name, plan in (("ntt_fwd_fbc", mdr), ("ntt_fwd_fbc_moddown", md)):
        src = plan.src_tables.primes
        out[name] = (residues(rng, (B, 2, len(src), n), src), plan.fbc,
                     plan.dst_tables)
    return out


def twiddles(t, inverse: bool = False) -> list:
    """The twiddles a transform needs, N a prime and their Shoup
    companions, at the size of the flat tables: the kernels read them from
    pass tables whose unused slots the bound does not count."""
    return ([t.inv_w, t.inv_w_shoup] if inverse
            else [t.fwd_w, t.fwd_w_shoup])


def fbc_tensors(fbc, t) -> list:
    return [fbc.phat_mod_r, fbc.phat_shoup, fbc.p_recip, *twiddles(t)]


def ntt_imuls(planes: int, n: int) -> float:
    """32-bit multiplies of ``planes`` transforms: N/2·log2 N Shoup
    butterflies and the epilogue's Shoup multiply of every residue."""
    return IMUL_PER_SHOUP * planes * (n // 2 * (n.bit_length() - 1) + n)


def loader_imuls(planes: int, terms: int, n: int) -> float:
    """The transforms of ``planes`` output planes plus the least their
    fused prologue needs: each of the ``terms`` products a column (a source
    residue times its weight, α times P) at one wide multiply, accumulated
    in 64 bits, and one Shoup-sized reduction a residue."""
    return ntt_imuls(planes, n) + n * (terms + planes * IMUL_PER_SHOUP)


def fbc_imuls(u, t) -> float:
    """The conversion: A + 1 products for every output residue (the
    terms u_i·phat_i and α·P)."""
    A, n = u.shape[-2:]
    planes = u.numel() // (A * n) * len(t.primes)
    return loader_imuls(planes, planes * (A + 1), n)


def lift_imuls(y, ks) -> float:
    """The digit lift: each output plane's digit holds min(α, Ly − dig·α)
    source primes, one product each (a short digit's padded terms have
    weight 0)."""
    Ly, n = y.shape[-2:]
    rows = y.numel() // (Ly * n)
    A = ks.lift_w.shape[1]
    terms = sum(min(A, Ly - d * A) for d in ks.lift_dig.tolist())
    return loader_imuls(rows * len(ks.lift_dig), rows * terms, n)


def lift_tensors(ks, t) -> list:
    return [ks.lift_w, ks.lift_ws, ks.lift_dig, *twiddles(t)]


def centered_cases(rng, ctx) -> dict:
    """K6 ``ntt_fwd_centered`` at the bench_n14 B=8 conversions of the
    centered path, tail [8,2,6,N]→[8,2,8,N] and mod-down
    [8,2,5,N]→[8,2,9,N]: (u, FBC plan, its centered plan, target tables)
    by case."""
    n = ctx.params.poly_degree
    mdr = ctx.moddown_rescale_plan(LEVEL)
    md = ctx.keyswitch_plan(LEVEL).moddown
    out = {}
    for name, plan in (("ntt_fwd_centered_tail", mdr),
                       ("ntt_fwd_centered_moddown", md)):
        src = plan.src_tables.primes
        out[name] = (residues(rng, (B, 2, len(src), n), src), plan.fbc,
                     ctx.centered_fbc_plan(plan.fbc), plan.dst_tables)
    return out


def ntt_compare(name, x, t, kw) -> dict:
    """K1 against its plain version: the inverse for names ``ntt_inv*``."""
    inv = name.startswith("ntt_inv")
    return compare(
        name, lambda: (ntt_inv if inv else ntt_fwd)(x, t, **kw),
        lambda: (ntt_inv_plain if inv else ntt_fwd_plain)(x, t, **kw),
        [x, *twiddles(t, inv)], imul=ntt_imuls(x.numel() // t.n, t.n))


def lift_compare(name, x, ks, level: int, centered: bool = False) -> dict:
    """K2 (or K6's centered lift) of the key-switch plan ``ks`` on x, the
    [B, level+1, N] decompose-INTT output."""
    ft = ks.foreign_cat_tables
    if centered:
        args = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.q[: level + 1], ft)
        return compare(
            name, lambda: fused_ntt.ntt_fwd_centered_lift(x, *args),
            lambda: fused_ntt.ntt_fwd_centered_lift_plain(x, *args),
            [x, *lift_tensors(ks, ft), ks.q[: level + 1]],
            imul=lift_imuls(x, ks))
    args = (ks.lift_w, ks.lift_ws, ks.lift_dig, ft)
    return compare(name, lambda: fused_ntt.ntt_fwd_lifted(x, *args),
                   lambda: fused_ntt.ntt_fwd_lifted_plain(x, *args),
                   [x, *lift_tensors(ks, ft)], imul=lift_imuls(x, ks))


def fbc_compare(name, u, fbc, dt) -> dict:
    """K3: the conversion of u by ``fbc`` onto ``dt``, forward NTT ×R."""
    return compare(name, lambda: fused_ntt.ntt_fwd_fbc(u, fbc, dt),
                   lambda: fused_ntt.ntt_fwd_fbc_plain(u, fbc, dt),
                   [u, *fbc_tensors(fbc, dt)], imul=fbc_imuls(u, dt))


def centered_compare(name, u, plan, dt) -> dict:
    """K6: the centered conversion of u by ``plan`` onto ``dt``."""
    return compare(name, lambda: fused_ntt.ntt_fwd_centered_fbc(u, plan, dt),
                   lambda: fused_ntt.ntt_fwd_centered_fbc_plain(u, plan, dt),
                   [u, *plan_tensors(plan), *twiddles(dt)],
                   imul=fbc_imuls(u, dt))


def ip_compare(name, rng, ks, rows: int = B) -> dict:
    """K4 over the key basis of ``ks``: ext [rows, J, R, N]."""
    n = ks.basis_tables.n
    R = len(ks.basis_tables.primes)
    J = ks.num_digits
    ext = residues(rng, (rows, J, R, n), ks.basis_tables.primes)
    k = residues(rng, (J, 2, R, n), ks.basis_tables.primes)
    k_sh = shoup_companion(k, ks.q)
    return compare(name, lambda: ip_kernel.inner_product(ext, k, k_sh, ks.q),
                   lambda: ip_kernel.inner_product_plain(ext, k, k_sh, ks.q),
                   [ext, k, k_sh])


def k5_cases(rng, ctx) -> dict:
    """K5 ``centered_fbc`` at the four bench_n14 B=8 conversions of the
    centered path: (plan, residues y) by case — the tail [8,2,6,N] →
    [8,2,8,N], the lift of digit 0 [8,5,N] → [8,9,N] and of digit 1
    [8,4,N] → [8,10,N], the mod-down [8,2,5,N] → [8,2,9,N]."""
    n = ctx.params.poly_degree
    ks = ctx.keyswitch_plan(LEVEL)
    cases = {"centered_fbc_tail": (
                 ctx.centered_fbc_plan(ctx.moddown_rescale_plan(LEVEL).fbc),
                 (B, 2)),
             "centered_fbc_lift0": (centered_fbc.lift_plan(ks, 0), (B,)),
             "centered_fbc_lift1": (centered_fbc.lift_plan(ks, 1), (B,)),
             "centered_fbc_moddown": (ctx.centered_fbc_plan(ks.moddown.fbc),
                                      (B, 2))}
    return {name: (plan, residues(rng, (*lead, plan.S, n),
                                  to_u32(plan.q_src)[:, 0]))
            for name, (plan, lead) in cases.items()}


def copy_cold_ms(plan, y) -> float:
    """Cold ms of ``Tensor.copy_`` moving what K5 moves on ``y``: (S + F) / 2
    planes of y's rows read and written (a yardstick of the bytes, not of
    the function: no library call computes the conversion)."""
    src = torch.zeros((*y.shape[:-2], (plan.S + plan.F) // 2, y.shape[-1]),
                      dtype=torch.int32, device=y.device)
    dst = torch.empty_like(src)
    return probes.cold_ms(lambda: dst.copy_(src))


def k5_edges(rng) -> None:
    """K5 exact (untimed) at the edges of its grid walk and of its
    64-bit sums: S 1 / 6 / 16 source primes, F 1 / 8 / 25 targets, 1 / 3
    / 16 rows of N = 1024, with and without α and ``extra`` (31-bit
    primes, so the centered values and constants are near 2^30)."""
    n = 1 << 10
    primes = nt.gen_primes(31, 16 + 25, 2 * n)
    for S in (1, 6, 16):
        for F in (1, 8, 25):
            src, dst = primes[:S], primes[16:16 + F]
            C = rng.integers(0, 1 << 31, (S, F), dtype=np.uint64)
            P = rng.integers(0, 1 << 31, F, dtype=np.uint64)
            ex = rng.integers(1, 1 << 31, F, dtype=np.uint64)
            for alpha, extra in ((None, None), (P, None), (P, ex),
                                 (None, ex)):
                plan = CenteredFbcPlan(src, dst, C, alpha, extra,
                                       device="cuda")
                for rows in (1, 3, 16):
                    y = residues(rng, (rows, S, n), src)
                    exact(f"centered_fbc S={S} F={F} rows={rows} "
                          f"alpha={alpha is not None} "
                          f"extra={extra is not None}",
                          lambda: plan.apply(y), lambda: plan.apply_plain(y))


def exact(name, kernel_fn, plain_fn) -> None:
    """Kernel vs plain version on the same inputs, bit for bit, untimed."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from plain")
    log("kernel_exact", kernel=name, shape_out=list(got.shape))


# K4's edge cases: batches by digits, 9 limbs of N = 2^13
IP_EDGE_B, IP_EDGE_J, IP_EDGE_R, IP_EDGE_N = (1, 3, 8, 64), (1, 2, 7, 27), \
    9, 1 << 13


def ip_edges(rng) -> None:
    primes = nt.gen_primes(30, IP_EDGE_R, 2 * IP_EDGE_N)
    q = from_u32(np.array(primes, dtype=np.uint64).reshape(-1, 1), "cuda")
    for b in IP_EDGE_B:
        for j in IP_EDGE_J:
            ext = residues(rng, (b, j, IP_EDGE_R, IP_EDGE_N), primes)
            k = residues(rng, (j, 2, IP_EDGE_R, IP_EDGE_N), primes)
            ks = shoup_companion(k, q)
            exact(f"inner_product B={b} J={j}",
                  lambda: ip_kernel.inner_product(ext, k, ks, q),
                  lambda: ip_kernel.inner_product_plain(ext, k, ks, q))


def phase_kernels(rng) -> dict:
    ctx = Context(preset("bench_n14"))
    n = ctx.params.poly_degree
    ks = ctx.keyswitch_plan(LEVEL)
    mdr = ctx.moddown_rescale_plan(LEVEL)
    out = {}

    k1 = ntt_cases(rng, ctx)
    for name, case in k1.items():
        out[name] = ntt_compare(name, *case)

    x = k1["ntt_inv"][0]
    out["ntt_fwd_lifted"] = lift_compare("ntt_fwd_lifted", x, ks, LEVEL)

    # K6: the centered lift of both digits [8,9,N]→[8,19,N] (x holds
    # residues of the level's primes), the centered tail and mod-down
    out["ntt_fwd_centered_lift"] = lift_compare("ntt_fwd_centered lift", x,
                                                ks, LEVEL, centered=True)
    for name, (u, fbc, plan, dt) in centered_cases(rng, ctx).items():
        out[name] = centered_compare(name, u, plan, dt)

    for name, (u, fbc, dt) in fbc_cases(rng, ctx).items():
        out[name] = fbc_compare(name, u, fbc, dt)

    out["inner_product"] = ip_compare("inner_product", rng, ks)
    ip_edges(rng)

    # K5 at the four bench_n14 B=8 shapes of the centered path
    k5 = k5_cases(rng, ctx)
    for name, (plan, y) in k5.items():
        out[name] = compare(name, lambda: plan.apply(y),
                            lambda: plan.apply_plain(y),
                            [y, *plan_tensors(plan)])
        out[name]["copy_graph_ms"] = copy_cold_ms(plan, y)
    k5_edges(np.random.default_rng(5))

    # K3 and K5 on near-tie α columns of the tail plan, tiled to [B,2,S,N]
    src, dt = mdr.src_tables.primes, mdr.dst_tables
    cols = near_tie_columns(src, False, 16, seed=1)
    u_tie = from_u32(np.tile(cols, (B, 2, 1, n // cols.shape[1])), "cuda")
    out["ntt_fwd_fbc_ties"] = fbc_compare("ntt_fwd_fbc near-tie columns",
                                          u_tie, mdr.fbc, dt)
    plan = k5["centered_fbc_tail"][0]
    cols = near_tie_columns(src, True, 16, seed=2)
    y_tie = from_u32(np.tile(cols, (B, 2, 1, n // cols.shape[1])), "cuda")
    out["centered_fbc_ties"] = compare(
        "centered_fbc near-tie columns", lambda: plan.apply(y_tie),
        lambda: plan.apply_plain(y_tie), [y_tie, *plan_tensors(plan)])
    out["ntt_fwd_centered_ties"] = centered_compare(
        "ntt_fwd_centered near-tie columns", y_tie, plan, dt)
    out.update(slice6_kernel_cases(rng))
    out.update(app_kernel_cases(rng))
    for name, r in out.items():
        log("kernel_vs_plain", kernel=name, **r)
    return out


def slice6_kernel_cases(rng) -> dict:
    """K1–K4 and K6 at the B=8 shapes that the BFV path (bfv_batch, top
    level) and the paired-prime path (ckks_hi14, top level) give them."""
    out = {}
    bctx = Context(preset("bfv_batch"))
    n = bctx.params.poly_degree
    scheme = BfvScheme(bctx)
    lvl = scheme._lvl(BFV_LEVEL)
    tq, tb = bctx.tables(BFV_LEVEL), lvl["tables_B"]
    tt = scheme.tables_t[scheme.t_factors[0]]
    hctx = Context(preset("ckks_hi14"))
    hn = hctx.params.poly_degree
    grs = hctx.group_rescale_plan(HI_LEVEL)
    mdr = hctx.moddown_rescale_plan(HI_LEVEL)
    L, K = BFV_LEVEL + 1, len(tb.primes)
    k1 = {  # BFV: the INTTs of a 2-part input and of the 3-part product
            # over Q, the forward NTT ×R and the INTT over the auxiliary
            # basis B, the t factor's transforms of encode and decode
          "ntt_inv_bfv_q2": ((B, 2, L, n), tq, dict(strip_mont=True)),
          "ntt_inv_bfv_q3": ((B, 3, L, n), tq, dict(strip_mont=True)),
          "ntt_fwd_bfv_b2": ((B, 2, K, n), tb, dict(to_mont=True)),
          "ntt_inv_bfv_b3": ((B, 3, K, n), tb, dict(strip_mont=True)),
          "ntt_inv_bfv_t": ((1, n), tt, {}),
          # g=2: the pair's INTT and the fused tail's (pair + specials)
          "ntt_inv_pair": ((B, 2, len(grs.src_tables.primes), hn),
                           grs.src_tables,
                           dict(strip_mont=True, extra=grs.fbc.inv_punit)),
          "ntt_inv_hi_tail": ((B, 2, len(mdr.src_tables.primes), hn),
                              mdr.src_tables,
                              dict(strip_mont=True, extra=mdr.fbc.inv_punit))}
    for name, (shape, t, kw) in k1.items():
        out[name] = ntt_compare(name, residues(rng, shape, t.primes), t, kw)
    ks = bctx.keyswitch_plan(BFV_LEVEL)
    y = residues(rng, (B, L, n), tq.primes)
    out["ntt_fwd_lifted_bfv"] = lift_compare("ntt_fwd_lifted bfv", y, ks,
                                             BFV_LEVEL)
    out["ntt_fwd_centered_bfv_lift"] = lift_compare(
        "ntt_fwd_centered bfv lift", y, ks, BFV_LEVEL, centered=True)
    for tag, ctx, plan in (("bfv_moddown", bctx, ks.moddown),
                           ("pair", hctx, grs), ("hi_tail", hctx, mdr)):
        src = plan.src_tables.primes
        u = residues(rng, (B, 2, len(src), ctx.params.poly_degree), src)
        out["ntt_fwd_fbc_" + tag] = fbc_compare(
            "ntt_fwd_fbc " + tag, u, plan.fbc, plan.dst_tables)
        out["ntt_fwd_centered_" + tag] = centered_compare(
            "ntt_fwd_centered " + tag, u, ctx.centered_fbc_plan(plan.fbc),
            plan.dst_tables)
    out["inner_product_bfv"] = ip_compare("inner_product bfv", rng, ks)
    return out


# the application paths' configurations: tag → (preset, rows a call)
APP_SHAPES = {"dhi": ("ckks_deep_hi", 1), "deep": ("ckks_deep", 1),
              "fft64": ("ckks_fft", 64)}


def app_kernel_cases(rng, shapes=APP_SHAPES) -> dict:
    """K1–K4 and K6 at the top-level shapes of the application paths:
    ckks_deep_hi (N=2^15, 25 data primes, 4 special, J=7, R=29, paired
    rescale) at one row, the least-squares fit; ckks_deep (N=2^15, 16 data
    primes, 4 special, J=4, R=20) at one row, the server's math workloads;
    ckks_fft (N=2^14, 11 data primes, 3 special, J=4, R=14) at 64 rows, the
    in-slot FFT of 64 ciphertexts.  K1: the decompose INTT and the forward
    NTT over the data primes, the forward NTT over the key basis, the
    mod-down INTT of the specials; K2 and the K6 lift; K3 and K6 for the
    mod-down, the fused rescale tail and, at g=2, the pair rescale; K4.
    ``shapes``: tag → (preset name or HeParams, rows)."""
    out = {}
    for tag, (params, rows) in shapes.items():
        name = params if isinstance(params, str) else tag
        ctx = Context(preset(params) if isinstance(params, str) else params)
        lvl = ctx.num_data - 1
        n = ctx.params.poly_degree
        ks, tabs = ctx.keyswitch_plan(lvl), ctx.tables(lvl)
        md, kb = ks.moddown, ks.basis_tables
        x = residues(rng, (rows, lvl + 1, n), tabs.primes)
        k1 = {"ntt_inv_" + tag: (x, tabs, dict(strip_mont=True,
                                               extra=ks.dig_inv)),
              "ntt_fwd_" + tag: (x, tabs, dict(to_mont=True)),
              "ntt_fwd_%s_basis" % tag: (
                  residues(rng, (rows, len(kb.primes), n), kb.primes), kb,
                  dict(to_mont=True)),
              "ntt_inv_%s_moddown" % tag: (
                  residues(rng, (rows, 2, len(md.src_tables.primes), n),
                           md.src_tables.primes), md.src_tables,
                  dict(strip_mont=True, extra=md.fbc.inv_punit))}
        for case, (y, t, kw) in k1.items():
            out[case] = ntt_compare(f"{case} {name}", y, t, kw)
        out["ntt_fwd_lifted_" + tag] = lift_compare(
            f"ntt_fwd_lifted {name}", x, ks, lvl)
        out["ntt_fwd_centered_%s_lift" % tag] = lift_compare(
            f"ntt_fwd_centered lift {name}", x, ks, lvl, centered=True)
        plans = {"moddown": md, "tail": ctx.moddown_rescale_plan(lvl)}
        if ctx.params.rescale_group == 2:
            plans["pair"] = ctx.group_rescale_plan(lvl)
        for ptag, plan in plans.items():
            src = plan.src_tables.primes
            u = residues(rng, (rows, 2, len(src), n), src)
            out[f"ntt_fwd_fbc_{tag}_{ptag}"] = fbc_compare(
                f"ntt_fwd_fbc {ptag} {name}", u, plan.fbc, plan.dst_tables)
            out[f"ntt_fwd_centered_{tag}_{ptag}"] = centered_compare(
                f"ntt_fwd_centered {ptag} {name}", u,
                ctx.centered_fbc_plan(plan.fbc), plan.dst_tables)
        out["inner_product_" + tag] = ip_compare(f"inner_product {name}", rng,
                                                 ks, rows)
    return out


def phase_goldens() -> None:
    z = np.load(GOLD / "golden_pins.npz")
    sess = Session.create("test_dnum", seed=b"\x33" * 32, galois_steps=[1])
    proto = sess.encrypt(0.0)
    a = proto.with_(data=from_u32(z["fused_a"], "cuda"))
    b = proto.with_(data=from_u32(z["fused_b"], "cuda"))
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    got = to_u32(out.data)
    if not np.array_equal(got, z["fused_out"]):
        raise AssertionError(f"fused_out differs in "
                             f"{int((got != z['fused_out']).sum())} elements")
    rot = to_u32(sess.ev.rotate(out, 1, sess.gk).data)
    if not np.array_equal(rot, z["fused_rot"]):
        raise AssertionError(f"fused_rot differs in "
                             f"{int((rot != z['fused_rot']).sum())} elements")

    # rs_n14, fed as tests/test_golden.py:_check_rescale feeds it
    z = np.load(GOLD / "golden_n14.npz")
    ctx = Context(preset("bench_n14"))
    if tuple(ctx.params.moduli[: LEVEL + 1]) != tuple(
            int(p) for p in z["rs_n14_primes"]):
        raise AssertionError("rs_n14 primes differ from bench_n14")
    x_m = ntt_fwd_mont(from_u32(z["rs_n14_x"], "cuda"), ctx.tables(LEVEL))
    ct = Ciphertext(data=x_m.unsqueeze(0), level=LEVEL, scale=1.0)
    res = Evaluator(ctx).rescale(ct)
    rs = to_u32(ntt_inv(res.data[0], ctx.tables(LEVEL - 1), strip_mont=True))
    if not np.array_equal(rs, z["rs_n14_out"]):
        raise AssertionError(f"rs_n14 differs in "
                             f"{int((rs != z['rs_n14_out']).sum())} elements")
    # bfv_out, fed as tests/test_golden.py:test_bfv_multiply_pin feeds it
    z = np.load(GOLD / "golden_pins.npz")
    bs = BfvSession.create("test_bfv_crt", seed=b"\x34" * 32,
                           galois_steps=[1])
    proto = bs.encrypt(np.zeros(4, dtype=np.int64))
    out = bs.multiply_relin(proto.with_(data=from_u32(z["bfv_a"], "cuda")),
                            proto.with_(data=from_u32(z["bfv_b"], "cuda")))
    got = to_u32(out.data)
    if not np.array_equal(got, z["bfv_out"]):
        raise AssertionError(f"bfv_out differs in "
                             f"{int((got != z['bfv_out']).sum())} elements")
    log("goldens", preset="test_dnum", fused_out=True, fused_rot=True,
        rs_n14=True, bfv_out=True, exact=True)


def stack(cts) -> Ciphertext:
    return cts[0].with_(data=torch.stack([c.data for c in cts]))


def phase_main_path(rng):
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    sess = Session.create("bench_n14", seed=b"\x21" * 32, galois_steps=[1])
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
    missing = [k for k in ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                           "inner_product") if launches[k] <= 0]
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
    return sess, a, b


def phase_time(sess, a, b, smi: str) -> None:
    ms = calls_ms(lambda: sess.ev.multiply_relin_rescale(a, b, sess.rk),
                    OP_ITERS)
    ops = B * 1000.0 / ms
    log("time", op="multiply_relin_rescale", preset="bench_n14", batch=B,
        iters=OP_ITERS, ms_per_call=ms, ops_per_s=ops, card=smi)


def _infer_run(sess, ct, x, diags, act, dec_sess, mode: str) -> dict:
    """One inference path on the card, launches counted around it: the
    batch through infer_step and decrypt, checked against
    infer_reference; then its B=1 output against the CPU plain path."""
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    out = pipeline.infer_step(sess, ct, diags, act)
    dec = dec_sess.decrypt(out).real
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    seconds = time.perf_counter() - t0
    n = sess.ctx.params.poly_degree
    if out.data.shape != (B, 2, LEVEL - 3 + 1, n) or not np.isfinite(dec).all():
        raise AssertionError(f"{mode}: bad output {tuple(out.data.shape)}")
    err = max(float(np.abs(dec[i] - pipeline.infer_reference(x[i], diags, act)
                           ).max()) for i in range(B))
    if not err < 5e-3:
        raise AssertionError(f"{mode}: infer_step error {err} >= 5e-3")
    ct1 = ct.with_(data=ct.data[0].contiguous())
    out1 = pipeline.infer_step(sess, ct1, diags, act).data.cpu()
    t1 = time.perf_counter()
    cpu = Session.from_wire(sess.ctx.params, sess.rk, sess.gk, device="cpu",
                            centered_fbc=sess.ev.centered_fbc)
    ref1 = pipeline.infer_step(cpu, ct1.to("cpu"), diags, act).data
    cpu_seconds = time.perf_counter() - t1
    if not torch.equal(out1, ref1):
        raise AssertionError(f"{mode}: B=1 output differs from the CPU "
                             "plain path")
    if not torch.equal(out1, out.data[0].cpu()):
        raise AssertionError(f"{mode}: B=1 output differs from row 0 of B=8")
    r = dict(mode=mode, preset="bench_n14", batch=B, n_diags=N_DIAGS,
             wseed=WSEED, max_err=err, seconds=round(seconds, 3),
             cpu_b1_seconds=round(cpu_seconds, 3), cpu_plain_equal=True,
             launches=launches)
    log("infer_path", **r)
    return r


def phase_infer(rng):
    t0 = time.perf_counter()
    sess = Session.create("bench_n14", seed=b"\x21" * 32,
                          galois_steps=list(range(1, N_DIAGS)))
    x = rng.uniform(-1, 1, (B, sess.slots))
    ct = stack([sess.encrypt(v) for v in x])
    diags, act = pipeline._infer_weights(sess.slots, N_DIAGS, WSEED)
    log("infer_setup", seconds=round(time.perf_counter() - t0, 3),
        galois_keys=len(sess.gk.elts))
    default = _infer_run(sess, ct, x, diags, act, sess, "default")
    dl = default["launches"]
    missing = [k for k in ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                           "inner_product") if dl[k] <= 0]
    if missing or dl["ntt_fwd_centered"] or dl["centered_fbc"]:
        raise AssertionError(f"default inference path: kernels not "
                             f"launched {missing}, launches {dl}")
    cent = Session.from_wire(sess.ctx.params, sess.rk, sess.gk,
                             centered_fbc=True)
    centered = _infer_run(cent, ct, x, diags, act, sess, "centered_fbc")
    cl = centered["launches"]
    # every lift and conversion fused into ntt_fwd_centered: no standalone
    # K5, no K2/K3, and no forward NTT after a conversion
    if cl["ntt_fwd_centered"] <= 0 or cl["inner_product"] <= 0 \
            or cl["ntt"] != dl["ntt"] or any(
                cl[k] for k in ("centered_fbc", "ntt_fwd_lifted",
                                "ntt_fwd_fbc")):
        raise AssertionError(f"centered inference path: launches {cl}, "
                             f"default {dl}")
    return sess, cent, ct, diags, act, default, centered


def phase_infer_time(sess, cent, ct, diags, act, a, b, smi: str) -> None:
    for mode, s in (("default", sess), ("centered_fbc", cent)):
        ms = calls_ms(lambda: pipeline.infer_step(s, ct, diags, act),
                        INFER_ITERS)
        log("time", op="infer_step", mode=mode, preset="bench_n14", batch=B,
            n_diags=N_DIAGS, iters=INFER_ITERS, ms_per_call=ms,
            vectors_per_s=B * 1000.0 / ms, card=smi)
    ms = calls_ms(lambda: sess.ev.rotate(ct, 1, sess.gk), OP_ITERS)
    log("time", op="rotate", steps=1, preset="bench_n14", batch=B,
        iters=OP_ITERS, ms_per_call=ms, ops_per_s=B * 1000.0 / ms, card=smi)
    for mode, ev in (("default", Evaluator(cent.ctx)),
                     ("centered_fbc", cent.ev)):
        ms = calls_ms(lambda: ev.multiply_relin_rescale(a, b, sess.rk),
                        OP_ITERS)
        log("time", op="multiply_relin_rescale", mode=mode,
            preset="bench_n14", batch=B, iters=OP_ITERS, ms_per_call=ms,
            ops_per_s=B * 1000.0 / ms, card=smi)


# device kernel name fragment → kernel of this package (first match wins)
def profile_calls(fn, calls: int = PROFILE_ITERS, warmup: int = 3) -> dict:
    """torch.profiler over ``calls`` calls of ``fn`` after ``warmup``
    calls, per call: wall µs (profiler on), device µs of this package's
    kernels (``ours``, by ``trace_op.package_name``) and of the plain
    torch kernels (``plain``, by name), and the device kernels launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ours, plain, n_kernels = {}, {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", 0.0)
        n_kernels += e.count
        name = trace_op.package_name(e.key)
        bucket = ours if name else plain
        key = name or e.key[:60]
        bucket[key] = bucket.get(key, 0.0) + us / calls
    return {"wall_us": wall_us / calls, "ours": ours, "plain": plain,
            "device_us": sum(ours.values()) + sum(plain.values()),
            "kernels": n_kernels / calls}


def phase_profile(sess, cent, ct, diags, act, smi: str) -> None:
    for mode, s in (("default", sess), ("centered_fbc", cent)):
        r = profile_calls(lambda: pipeline.infer_step(s, ct, diags, act))
        top = dict(sorted(r["plain"].items(), key=lambda kv: -kv[1])[:8])
        log("profile", op="infer_step", mode=mode, preset="bench_n14",
            batch=B, calls=PROFILE_ITERS, wall_us_per_call=r["wall_us"],
            device_us_per_call=r["device_us"],
            device_busy_share=r["device_us"] / r["wall_us"],
            device_kernels_per_call=r["kernels"],
            our_kernels_us=r["ours"], plain_us=sum(r["plain"].values()),
            plain_top_us=top, card=smi)


def _counted(fn):
    """``fn()`` with the launch counts zeroed just before it and read just
    after it (synchronised): (result, launches)."""
    cuda_lib.reset_launches()
    r = fn()
    torch.cuda.synchronize()
    return r, dict(cuda_lib.launches)


def _need(launches: dict, kernels, what: str, absent=()) -> None:
    missing = [k for k in kernels if launches[k] <= 0]
    extra = [k for k in absent if launches[k]]
    if missing or extra:
        raise AssertionError(f"{what}: kernels not launched {missing}, "
                             f"launched {extra}: {launches}")


def _bfv_chain(s, a, b):
    """The BFV path: multiply + relinearize, rotate the rows by 1, drop the
    last prime."""
    return s.mod_switch(s.rotate_rows(s.multiply_relin(a, b), 1))


def phase_bfv(rng, smi: str):
    """BfvSession on the card at bfv_batch (the reference's
    batch_matmul_bfv configuration: N=2^14, 7 data primes, 2 special
    primes, t = t₁·t₂ ≈ 2^60): B=8 slot vectors through the BFV path,
    decrypted exactly; the B=1 output equals the CPU plain path; then its
    multiply_relin timed and profiled."""
    t0 = time.perf_counter()
    sess = BfvSession.create("bfv_batch", seed=b"\x35" * 32,
                             galois_steps=[1])
    t = sess.ctx.params.plain_modulus
    xs = rng.integers(0, t, (2, B, sess.slots), dtype=np.uint64)
    a = stack([sess.encrypt(v) for v in xs[0]])
    b = stack([sess.encrypt(v) for v in xs[1]])
    setup = time.perf_counter() - t0
    _, mr_launches = _counted(lambda: sess.multiply_relin(a, b))
    out, launches = _counted(lambda: _bfv_chain(sess, a, b))
    n = sess.ctx.params.poly_degree
    if out.data.shape != (B, 2, BFV_LEVEL, n) or out.level != BFV_LEVEL - 1:
        raise AssertionError(f"bfv: bad output {tuple(out.data.shape)}")
    half = sess.slots // 2
    for i in range(B):
        prod = [int(x) * int(y) % t for x, y in zip(xs[0, i], xs[1, i])]
        want = prod[1:half] + prod[:1] + prod[half + 1:] + prod[half:half + 1]
        got = [int(v) for v in sess.decrypt(out.with_(data=out.data[i]))]
        if got != want:
            bad = sum(g != w for g, w in zip(got, want))
            raise AssertionError(f"bfv: row {i} decrypts wrong in {bad} "
                                 "slots")
    budget = sess.noise_budget(out.with_(data=out.data[0]))
    if not budget > 0:
        raise AssertionError(f"bfv: noise budget {budget}")
    _need(mr_launches, ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                        "inner_product"), "bfv multiply_relin",
          absent=("ntt_fwd_centered", "centered_fbc"))
    # B=1: the card's output equals the plain path on the CPU (same keys)
    a1 = a.with_(data=a.data[0].contiguous())
    b1 = b.with_(data=b.data[0].contiguous())
    out1 = _bfv_chain(sess, a1, b1).data.cpu()
    t1 = time.perf_counter()
    cctx = Context(sess.ctx.params, "cpu")
    cpu = BfvSession(ctx=cctx, scheme=BfvScheme(cctx), ev=Evaluator(cctx),
                     rk=sess.rk.to("cpu"), gk=sess.gk.to("cpu"),
                     encryptor=None, sk_data=None)
    ref1 = _bfv_chain(cpu, a1.to("cpu"), b1.to("cpu")).data
    cpu_seconds = time.perf_counter() - t1
    if not torch.equal(out1, ref1) or not torch.equal(out1, out.data[0].cpu()):
        raise AssertionError("bfv: B=1 output differs from the CPU plain "
                             "path or from row 0 of B=8")
    log("bfv_path", preset="bfv_batch", batch=B, t_bits=t.bit_length(),
        aux_primes=len(sess.scheme._lvl(BFV_LEVEL)["B_primes"]),
        exact=True, noise_budget=budget, setup_seconds=round(setup, 3),
        cpu_b1_seconds=round(cpu_seconds, 3), cpu_plain_equal=True,
        launches_multiply_relin=mr_launches, launches=launches)
    ms = calls_ms(lambda: sess.multiply_relin(a, b), BFV_ITERS)
    log("time", op="bfv multiply_relin", preset="bfv_batch", batch=B,
        iters=BFV_ITERS, ms_per_call=ms, ops_per_s=B * 1000.0 / ms, card=smi)
    r = profile_calls(lambda: sess.multiply_relin(a, b))
    # the precise-α conversions of one multiply at the shapes it gives them:
    # both inputs to B, r = |t·x|_Q to B, the scaled y back to Q
    lvl = sess.scheme._lvl(BFV_LEVEL)
    L, K = BFV_LEVEL + 1, len(lvl["B_primes"])
    convs = {"q_to_b [8,2,7,N] x2": (2, (B, 2, L), lvl["fbc_q_to_b"]),
             "q_to_b [8,3,7,N]": (1, (B, 3, L), lvl["fbc_q_to_b"]),
             "b_to_q [8,3,10,N]": (1, (B, 3, K), lvl["fbc_b_to_q"])}
    precise = {}
    for key, (times, lead, plan) in convs.items():
        u = residues(rng, (*lead, n), to_u32(plan.p)[:, 0])
        c = profile_calls(lambda: fbc_apply(u, plan, precise=True))
        precise[key] = {"device_us": times * c["device_us"],
                        "kernels": times * c["kernels"]}
    p_us = sum(v["device_us"] for v in precise.values())
    p_k = sum(v["kernels"] for v in precise.values())
    top = dict(sorted(r["plain"].items(), key=lambda kv: -kv[1])[:8])
    log("profile", op="bfv multiply_relin", preset="bfv_batch", batch=B,
        calls=PROFILE_ITERS, wall_us_per_call=r["wall_us"],
        device_us_per_call=r["device_us"],
        device_busy_share=r["device_us"] / r["wall_us"],
        device_kernels_per_call=r["kernels"], our_kernels_us=r["ours"],
        plain_us=sum(r["plain"].values()), plain_top_us=top,
        precise_fbc_us=p_us, precise_fbc_kernels=p_k,
        precise_fbc_share=p_us / r["device_us"], precise_fbc=precise,
        card=smi)
    return sess, a, {"bfv_multiply_relin": mr_launches, "bfv_path": launches}


def phase_hi(rng, smi: str) -> dict:
    """The paired-prime rescale on the card at ckks_hi14 (N=2^14, 2 anchor
    primes + 5 pairs of 17–31 bits, 3 special primes, scale ≈ 2^44), B=8,
    in both FBC modes (centered through Session.from_wire on the same
    keys): the fused multiply_relin_rescale drops two levels within
    HI_ERR of x·y, and the standalone rescale(relinearize(multiply))
    matches it within HI_SAME; B=1 equals the CPU plain path; K3 runs on
    the default path, K6 (not K2 or K3) on the centered one.  The inputs
    are secret-key (seeded) encryptions, the reference client's compact
    form: a public-key encryption's fresh noise grows with N to ~1e-8 in
    a slot here and would hide the rescale's."""
    t0 = time.perf_counter()
    sess = Session.create("ckks_hi14", seed=b"\x36" * 32, galois_steps=[1])
    x = rng.uniform(-1, 1, (B, sess.slots))
    y = rng.uniform(-1, 1, (B, sess.slots))
    enc = lambda v, i: sess.encryptor.encrypt_symmetric(
        sess.encode(v), seed=bytes([0x60 + i]) * 32)
    a = stack([enc(v, i) for i, v in enumerate(x)])
    b = stack([enc(v, B + i) for i, v in enumerate(y)])
    cent = Session.from_wire(sess.ctx.params, sess.rk, sess.gk,
                             centered_fbc=True)
    log("hi_setup", preset="ckks_hi14", seconds=round(time.perf_counter()
                                                      - t0, 3))
    fused_op = lambda s, a, b: s.ev.multiply_relin_rescale(a, b, s.rk)
    steps_op = lambda s, a, b: s.ev.rescale(s.ev.relinearize(
        s.ev.multiply(a, b), s.rk))
    out = {}
    for mode, s in (("default", sess), ("centered_fbc", cent)):
        fused, lf = _counted(lambda: fused_op(s, a, b))
        steps, ls = _counted(lambda: steps_op(s, a, b))
        if not fused.level == steps.level == HI_LEVEL - 2:
            raise AssertionError(f"hi {mode}: levels {fused.level}, "
                                 f"{steps.level}")
        df, ds = sess.decrypt(fused).real, sess.decrypt(steps).real
        err = float(np.abs(df - x * y).max())
        diff = float(np.abs(df - ds).max())
        if not (err < HI_ERR and diff < HI_SAME):
            raise AssertionError(f"hi {mode}: error {err} (bound {HI_ERR}), "
                                 f"fused against standalone {diff} (bound "
                                 f"{HI_SAME})")
        for name, lc in (("fused", lf), ("standalone", ls)):
            if mode == "default":
                _need(lc, ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                           "inner_product"), f"hi {mode} {name}",
                      absent=("ntt_fwd_centered", "centered_fbc"))
            else:
                _need(lc, ("ntt", "ntt_fwd_centered", "inner_product"),
                      f"hi {mode} {name}", absent=(
                          "ntt_fwd_lifted", "ntt_fwd_fbc", "centered_fbc"))
        a1 = a.with_(data=a.data[0].contiguous())
        b1 = b.with_(data=b.data[0].contiguous())
        t1 = time.perf_counter()
        cpu = Session.from_wire(sess.ctx.params, sess.rk, sess.gk,
                                device="cpu", centered_fbc=s.ev.centered_fbc)
        for name, op, batched in (("fused", fused_op, fused),
                                  ("standalone", steps_op, steps)):
            got = op(s, a1, b1).data.cpu()
            ref = op(cpu, a1.to("cpu"), b1.to("cpu")).data
            if not torch.equal(got, ref) or not torch.equal(
                    got, batched.data[0].cpu()):
                raise AssertionError(f"hi {mode} {name}: B=1 output differs "
                                     "from the CPU plain path or row 0")
        cpu_seconds = time.perf_counter() - t1
        times = {name: calls_ms(lambda: op(s, a, b), HI_ITERS)
                 for name, op in (("fused", fused_op),
                                  ("standalone", steps_op))}
        log("hi_path", mode=mode, preset="ckks_hi14", batch=B, max_err=err,
            fused_vs_standalone=diff, cpu_plain_equal=True,
            cpu_b1_seconds=round(cpu_seconds, 3), launches_fused=lf,
            launches_standalone=ls, ms_per_call=times,
            ops_per_s={k: B * 1000.0 / v for k, v in times.items()},
            card=smi)
        out[f"hi_{mode}_fused"] = lf
        out[f"hi_{mode}_standalone"] = ls
    return out


def phase_wire(sess, a, b, bfv_sess, bfv_ct) -> None:
    """Every blob kind of core/serial round-trips on the card to equal
    tensors; a from_wire session on the loaded keys gives phase 6's
    multiply_relin_rescale bits (bench_n14)."""
    t0 = time.perf_counter()
    ctx = sess.ctx
    same = lambda u, v: u.device == v.device and torch.equal(u, v)
    params = serial.load_params(serial.dump_params(ctx.params))
    pt = sess.encode(np.linspace(-1, 1, 16))
    seed = b"\x37" * 32
    sym = sess.encryptor.encrypt_symmetric(pt, seed=seed)
    kg = KeyGenerator(Context(preset("test_dnum")), seed=seed)
    kg.create_public_key()
    rk2 = kg.create_relin_keys(count=2)
    rk = serial.load_relin_keys(serial.dump_relin_keys(sess.rk), ctx)
    gk = serial.load_galois_keys(serial.dump_galois_keys(sess.gk), ctx)
    rk2b = serial.load_relin_keys(serial.dump_relin_keys(rk2), kg.ctx)
    pt2 = serial.load_plaintext(serial.dump_plaintext(pt))
    kinds = {
        "params": params == ctx.params,
        "ckks_ciphertext": same(serial.load_ciphertext(
            serial.dump_ciphertext(a), ctx).data, a.data),
        "bfv_ciphertext": same(serial.load_ciphertext(
            serial.dump_ciphertext(bfv_ct), bfv_sess.ctx).data, bfv_ct.data),
        "seeded_ciphertext": same(serial.load_ciphertext(
            serial.dump_ciphertext(sym, seed=seed), ctx).data, sym.data),
        "plaintext": same(pt2.data, pt.data) and same(pt2.shoup, pt.shoup),
        "public_key": same(serial.load_public_key(serial.dump_public_key(
            sess.encryptor.pk)).data, sess.encryptor.pk.data),
        "relin_keys": same(rk.key.data, sess.rk.key.data)
        and same(rk.key.shoup, sess.rk.key.shoup),
        "relin_keys_count_2": len(rk2b.more) == 1 and all(
            same(u.data, v.data) and same(u.shoup, v.shoup)
            for u, v in zip((rk2b.key, *rk2b.more), (rk2.key, *rk2.more))),
        "galois_keys": gk.elts == sess.gk.elts and all(
            same(u.data, v.data) and same(u.shoup, v.shoup)
            for u, v in zip(gk.keys, sess.gk.keys)),
    }
    wire = Session.from_wire(params, rk, gk)
    kinds["from_wire_multiply_relin_rescale"] = same(
        wire.ev.multiply_relin_rescale(a, b, wire.rk).data,
        sess.ev.multiply_relin_rescale(a, b, sess.rk).data)
    bad = [k for k, ok in kinds.items() if not ok]
    if bad:
        raise AssertionError(f"wire: round trips differ: {bad}")
    log("wire", preset="bench_n14", kinds=sorted(kinds),
        seconds=round(time.perf_counter() - t0, 3), exact=True)


# ----------------------------------------------------------------------
# the application layer: least squares, matmul128, bfft1024×64, server
# ----------------------------------------------------------------------

LSQ_ERR = 2 ** -10             # hetpu/demos/matrix_operations.py:196-197
MATMUL_D, MATMUL_CHUNK = 128, 8
MATMUL_ERR = 5e-3              # hetpu recorded 1.89e-3 (BENCH_WORKLOADS.json)
BFFT_N, BFFT_CTS = 1024, 64
BFFT_ERR = 1e-2                # hetpu recorded 6.6e-3 (BENCH_WORKLOADS.json)


def _busy(fn, calls: int) -> dict:
    """Profile ``calls`` calls of ``fn`` after one warm-up: device busy
    share, device µs and kernels a call, this package's kernels' µs."""
    r = profile_calls(fn, calls, warmup=1)
    return {"wall_us_per_call": r["wall_us"],
            "device_us_per_call": r["device_us"],
            "device_busy_share": r["device_us"] / r["wall_us"],
            "device_kernels_per_call": r["kernels"],
            "our_kernels_us": r["ours"], "plain_us": sum(r["plain"].values())}


def phase_least_squares(smi: str) -> dict:
    """The flagship fit as hetpu/demos/matrix_operations.py:168-197 runs
    it: ckks_deep_hi (the demo's seed 0x77, galois steps 1, 2, 4), 5
    points from rng(0), inv_iters 6; a and b within 2^-10 of the closed
    form."""
    t0 = time.perf_counter()
    sess = Session.create("ckks_deep_hi", seed=b"\x77" * 32,
                          galois_steps=[1, 2, 4])
    rng = np.random.default_rng(0)
    n = 5
    x = rng.uniform(0.5, 2.0, n)
    y = 0.7 * x + 0.3 + rng.normal(0, 0.02, n)
    px, py = np.zeros((2, sess.slots))
    px[:n], py[:n] = x, y
    sx, sxx, sy, sxy = x.sum(), (x * x).sum(), y.sum(), (x * y).sum()
    D = n * sxx - sx * sx
    cx, cy = sess.encrypt(px), sess.encrypt(py)
    setup = time.perf_counter() - t0
    fit = lambda: least_squares_2d(sess, cx, cy, n, inv_guess=1.0 / D,
                                   inv_iters=6)
    t0 = time.perf_counter()
    (ct_a, ct_b), launches = _counted(fit)
    seconds = time.perf_counter() - t0
    a, b = sess.decrypt(ct_a).real[0], sess.decrypt(ct_b).real[0]
    ea, eb = (n * sxy - sx * sy) / D, (sxx * sy - sx * sxy) / D
    err = max(abs(a - ea), abs(b - eb))
    if not (np.isfinite([a, b]).all() and err < LSQ_ERR):
        raise AssertionError(f"least squares: error {err} (bound {LSQ_ERR})")
    _need(launches, ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                     "inner_product"), "least squares",
          absent=("ntt_fwd_centered", "centered_fbc"))
    log("least_squares", preset="ckks_deep_hi", points=n, inv_iters=6,
        a=a, b=b, expected=[ea, eb], max_err=err, bound=LSQ_ERR,
        levels_left=ct_a.level, setup_seconds=round(setup, 3),
        seconds=seconds, launches=launches, profile=_busy(fit, 2), card=smi)
    return launches


def phase_matmul128(smi: str) -> dict:
    """scripts/bench_workloads.py's config 3: bench_n14 (seed 0x31, galois
    steps 1..127), a 128×128 diag-layout A times a col-layout B from rng(3)
    as BatchedMatrix diag×col in chunks of 8 columns; within 5e-3 of A@B."""
    d, chunk = MATMUL_D, MATMUL_CHUNK
    t0 = time.perf_counter()
    sess = Session.create("bench_n14", seed=b"\x31" * 32,
                          galois_steps=list(range(1, d)))
    rng = np.random.default_rng(3)
    A = rng.uniform(-1, 1, (d, d))
    Bm = rng.uniform(-1, 1, (d, d))
    ma = BatchedMatrix.encrypt(sess, A, layout="diag")
    mb = BatchedMatrix.encrypt(sess, Bm, layout="col")
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0

    def chunk_fn(j):
        mbc = BatchedMatrix(sess, mb.ct.with_(data=mb.ct.data[j: j + chunk]),
                            rows=d, cols=chunk, layout="col")
        return ma.matmul(mbc).ct

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outs, launches = _counted(lambda: [chunk_fn(j)
                                       for j in range(0, d, chunk)])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    mc = BatchedMatrix(sess, outs[0].with_(data=torch.cat(
        [o.data for o in outs])), rows=d, cols=d, layout="col")
    got = mc.decrypt().real
    err = float(np.abs(got - A @ Bm).max())
    if not (np.isfinite(got).all() and err < MATMUL_ERR):
        raise AssertionError(f"matmul128: error {err} (bound {MATMUL_ERR})")
    _need(launches, ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                     "inner_product"), "matmul128",
          absent=("ntt_fwd_centered", "centered_fbc"))
    log("matmul128", preset="bench_n14", d=d, chunk=chunk, max_err=err,
        bound=MATMUL_ERR, setup_seconds=round(setup, 3), seconds=seconds,
        peak_device_bytes=peak, launches=launches,
        profile_chunk=_busy(lambda: chunk_fn(0), 2), card=smi)
    return launches


def phase_bfft(smi: str) -> dict:
    """scripts/bench_workloads.py's config 4: ckks_fft (seed 0x32, steps
    ±512..±1), the in-slot FFT of 64 ciphertexts of 1024 points each
    (rng(3), 1/n-normalised, tiled over the slots); rows 0, 32 and 63
    within 1e-2 of the bit-reversed numpy.fft.fft.  Timed twice: the first
    call encodes the stage masks, the second finds them cached."""
    n, nct = BFFT_N, BFFT_CTS
    t0 = time.perf_counter()
    steps = sorted({s for h in [n >> (i + 1) for i in range(n.bit_length()
                                                            - 1)]
                    for s in (h, -h)})
    fs = Session.create("ckks_fft", seed=b"\x32" * 32, galois_steps=steps)
    rng = np.random.default_rng(3)
    sig = (rng.uniform(-1, 1, (nct, n))
           + 1j * rng.uniform(-1, 1, (nct, n))) / n
    tile = fs.slots // n
    ct = stack([fs.encrypt(np.tile(sig[i], tile)) for i in range(nct)])
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    fout, launches = _counted(lambda: bfft(fs, ct, n))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _counted(lambda: bfft(fs, ct, n))
    second = time.perf_counter() - t0
    errs = []
    for i in (0, nct // 2, nct - 1):
        got = fs.decrypt(fout.with_(data=fout.data[i]))[:n]
        errs.append(float(np.abs(got - bit_reverse_order(
            np.fft.fft(sig[i]))).max()))
    err = max(errs)
    if not (fout.data.shape[0] == nct and err < BFFT_ERR):
        raise AssertionError(f"bfft: error {err} (bound {BFFT_ERR})")
    _need(launches, ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc",
                     "inner_product"), "bfft",
          absent=("ntt_fwd_centered", "centered_fbc"))
    log("bfft", preset="ckks_fft", n=n, cts=nct, max_err=err, bound=BFFT_ERR,
        setup_seconds=round(setup, 3), seconds_first=first,
        seconds_cached=second, launches=launches, card=smi)
    return launches


class Wire:
    """A transport that hands out the given frames in order and keeps the
    frames sent: a recorded request, served again."""

    def __init__(self, frames=()):
        self.sent = []
        self._frames = list(frames)

    def send(self, payload: bytes) -> None:
        self.sent.append(bytes(payload))

    def recv(self) -> bytes:
        return self._frames.pop(0)


class Tap:
    """Wraps a transport and keeps every frame it receives and sends."""

    def __init__(self, inner):
        self.inner = inner
        self.received, self.sent = [], []

    def send(self, payload: bytes) -> None:
        self.sent.append(bytes(payload))
        self.inner.send(payload)

    def recv(self) -> bytes:
        frame = self.inner.recv()
        self.received.append(frame)
        return frame


# each client workload's bound (kind, bound, source): phase 17 holds the
# whole decrypted result to it, phase 20 the values the CLI prints
CLIENT_BOUNDS = {
    "simple": ("abs", 1e-3, "tests/test_offload.py:93 atol"),
    "batch_matmul": ("abs", 1e-2, "tests/test_offload.py:103 atol"),
    "inv": ("rel", 5e-3, "tests/test_offload.py:111 rtol"),
    "inv_sqrt_twice": ("rel", 5e-3, "tests/test_math.py:35 rtol, the same "
                       "inputs, guess and iterations"),
    "abs": ("rel", 1e-2, "tests/test_math.py:49 rtol, the same inputs, "
            "guess and iterations"),
    "twice_max": ("rel_max", 2e-2, "tests/test_math.py:66 rtol = atol, on "
                  "its inputs (the demo's leave the Newton basin)"),
    "fft": ("abs", 1e-3, "tests/test_fft.py:46 atol"),
}


def error(kind: str, got, want) -> float:
    """The error of ``got`` against ``want`` that a bound of ``kind``
    holds: absolute, relative, or relative to 1 + |want|."""
    got, want = np.asarray(got), np.asarray(want)
    if kind == "abs":
        return float(np.abs(got - want).max())
    if kind == "rel":
        return float(np.abs(got / want - 1).max())
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


def demo_workload(name: str, slots: int, small: bool):
    """hetpu/demos/offload_demos.py's inputs for one client workload (a
    fresh rng(0) each, :21-70): (client method arguments, the expected
    result, and how the decrypted result maps onto it)."""
    rng = np.random.default_rng(0)
    if name == "simple":
        x1, x2 = rng.uniform(-1, 1, slots), rng.uniform(-1, 1, slots)
        return (x1, x2), x1 * x2, lambda got: got.real
    if name == "batch_matmul":
        a = rng.uniform(-1, 1, (5, 5, slots))
        b = rng.uniform(-1, 1, (5, 5, slots))
        return ((a, b), np.einsum("ikb,kjb->ijb", a, b),
                lambda got: got.real[:, :, :slots])
    if name == "inv":
        x = rng.uniform(0.5, 1.5, slots)
        return (x, 0.8, 5), 1 / x, lambda got: got.real
    if name == "inv_sqrt_twice":
        x = rng.uniform(0.4, 0.7, slots)
        return (x, 1.0, 4), 1 / np.sqrt(2 * x), lambda got: got.real
    if name == "abs":
        x = rng.uniform(0.5, 1.0, slots) * rng.choice([-1, 1], slots)
        return (x, 1.0, 4), np.abs(x), lambda got: got.real
    if name == "twice_max":
        # the demo draws x1, x2 from U(-1, 1): |x1 - x2| then leaves the
        # |·| Newton basin |x1 - x2| < sqrt(1.5)/guess (he_math.h:9-15) in
        # about one slot in eight, where the iteration grows to ~1e19; the
        # float64 decode of such coefficients loses every slot's precision,
        # so no bound can hold.  tests/test_math.py:56-61's draws (rng(0)
        # here) stay inside the basin, with the demo's guess and iterations
        base = rng.uniform(-0.5, 0.5, slots)
        diff = rng.uniform(0.6, 1.0, slots) * rng.choice([-1, 1], slots)
        x1, x2 = base + diff / 2, base - diff / 2
        return (x1, x2, 1.0, 4), 2 * np.maximum(x1, x2), lambda got: got.real
    n = 8 if small else 32
    sig = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    return (sig,), np.fft.fft(sig), lambda got: got


def _rookie(client, name, args):
    """One round trip as hetpu/demos/offload_demos.py:87-100 runs it: the
    port's server on the card in a thread, the client over an in-process
    socket pair.  Returns (decrypted result, transport kind, the server's
    transport tapped: the request and reply frames)."""
    ta, tb = native.pipe_pair()
    tap = Tap(tb)
    err = []

    def srv():
        try:
            serve_once(tap, device="cuda")
        except Exception as e:          # re-raised below, after the join
            err.append(e)
            tb.close()                  # unblock the client's recv

    th = threading.Thread(target=srv)
    th.start()
    try:
        got = getattr(client, name)(ta, *args)
    finally:
        th.join(timeout=600)
        ta.close()
        tb.close()
    if th.is_alive():
        raise AssertionError(f"server {name}: the server did not finish")
    if err:
        raise err[0]
    return got, ta.kind, tap


def phase_server(smi: str) -> dict:
    """The port's Client against the port's serve_once on the card, all
    seven workloads at the demos' full-size presets and inputs, each error
    within its bound; then at the --small presets, the card server's reply
    frames equal the CPU server's on the same request frames."""
    clients, out = {}, {}
    for name in CLIENT_DEMOS:
        pname = _params_for(name, False)
        t0 = time.perf_counter()
        if pname not in clients:
            clients[pname] = Client(pname, galois_steps=[1])
        client = clients[pname]
        setup = time.perf_counter() - t0
        args, want, as_want = demo_workload(name, client.sess.slots, False)
        t0 = time.perf_counter()
        (got, kind, _), launches = _counted(lambda: _rookie(client, name,
                                                            args))
        seconds = time.perf_counter() - t0
        how, bound, why = CLIENT_BOUNDS[name]
        err = error(how, as_want(got), want)
        if not (np.isfinite(err) and err < bound):
            raise AssertionError(f"server {name}: error {err} (bound {bound},"
                                 f" {why})")
        _need(launches, ("ntt", "inner_product") if name != "fft"
              else ("ntt",), f"server {name}")
        log("server", workload=name, preset=pname, transport=kind,
            max_err=err, bound=bound, bound_source=why,
            client_setup_seconds=round(setup, 3), round_trip_seconds=seconds,
            launches=launches, card=smi)
        out["server_" + name] = launches

    # the card's replies equal the CPU's, byte for byte (--small presets):
    # the request frames the card's server received, served on the CPU
    t0 = time.perf_counter()
    small = {}
    for name in CLIENT_DEMOS:
        pname = _params_for(name, True)
        if pname not in small:
            small[pname] = Client(pname, galois_steps=[1])
        client = small[pname]
        args, _, _ = demo_workload(name, client.sess.slots, True)
        _, _, tap = _rookie(client, name, args)
        header, sess, cts = recv_request(Wire(tap.received), device="cpu")
        cpu = Wire()
        send_reply(cpu, handle(header, sess, cts))
        if tap.sent != cpu.sent:
            raise AssertionError(f"server {name}: card reply frames differ "
                                 "from the CPU's")
    log("server_small_bytes", workloads=list(CLIENT_DEMOS),
        presets=sorted(small), equal=True,
        seconds=round(time.perf_counter() - t0, 3))
    return out


def phase_probe_kernels(rng) -> dict:
    """P1–P4 against their plain versions at each probe's own shapes; P1
    also as GB/s each way per CTA (one CTA a block), P3 as TMAC/s, both
    from the cold time."""
    out = {}

    def copy_case(name, x, rb, flat, library):
        r = compare(name, lambda: copy_probe.copy_planes(x, rb, flat),
                    lambda: copy_probe.copy_planes_plain(x, rb, flat), [x],
                    library=library)
        ctas = x.shape[0] // rb * (1 if flat or x.dim() == 3 else x.shape[1])
        r["ctas"] = ctas
        r["gbps_per_cta"] = x.numel() * 4 / ctas / (r["graph_ms"] * 1e6)
        out[name] = r

    x = copy_probe.planes_u32((32, 9, 128, 128), device="cuda")
    dst = torch.empty_like(x)
    lib_copy = (lambda: dst.copy_(x), lambda r: r)
    copy_case("copy_planes_rb8", x, 8, False, lib_copy)
    copy_case("copy_planes_flat_rb8", x, 8, True, lib_copy)
    x4 = copy_probe.planes_u32((1152, 128, 128), device="cuda")
    dst4 = torch.empty_like(x4)
    copy_case("copy_planes_1152", x4, 8, False,
              (lambda: dst4.copy_(x4), lambda r: r))
    out["muladd_u32"] = compare(
        "muladd_u32", lambda: overhead2.muladd_u32(x),
        lambda: overhead2.muladd_u32_plain(x), [x])

    def dot_case(name, a, b, ppb=1, library=None):
        macs = b.shape[0] * a.shape[0] * a.shape[1] * b.shape[2]
        r = compare(name, lambda: dot.dot_i8(a, b, ppb),
                    lambda: dot.dot_i8_plain(a, b), [a, b], ops=2 * macs,
                    library=library)
        r["tmac_per_s"] = macs / (r["graph_ms"] * 1e-3) / 1e12
        out[name] = r

    # torch._int_mm: the s8×s8 library yardstick (the port never calls it)
    for pname, la, ra in dot.PAIRS:
        a, b = (torch.from_numpy(v).cuda() for v in dot.pair_inputs(la, ra))
        mm = None
        if a.dtype == b.dtype == torch.int8:
            mm = (lambda a=a, b=b: torch._int_mm(a, b), lambda r: r[None])
        dot_case("dot_i8_" + pname.replace(" x ", "x"), a, b[None],
                 library=mm)
    w8 = torch.from_numpy(rng.integers(-128, 128, (512, 512),
                                       dtype=np.int8)).cuda()
    x8 = torch.from_numpy(rng.integers(-128, 128, (512, 128),
                                       dtype=np.int8)).cuda()
    dot_case("dot_i8_512", w8, x8[None],
             library=(lambda: torch._int_mm(w8, x8), lambda r: r[None]))
    w, a = dot.int8_mxu_inputs(288, device="cuda")
    a2 = a.permute(1, 0, 2).reshape(512, 288 * 128).contiguous()
    mm = (lambda: torch._int_mm(w, a2),
          lambda r: r.view(512, 288, 128).permute(1, 0, 2))
    dot_case("dot_i8_288", w, a, 1, library=mm)
    dot_case("dot_i8_288_ppb8", w, a, 8, library=mm)

    # dot and dot2 issue the products of all 512 rows, as the TPU probe
    # does; the bound counts only those the stored rows 0..127 depend on:
    # a quarter of one product for dot, the whole first product and a
    # quarter of the second for dot2
    xp, wp, tw, tws = kernel_parts.make_inputs(device="cuda")
    planes = xp.shape[0] * xp.shape[1]
    macs = planes * 512 * 512 * 128
    io = {"copy": [xp], "dot": [xp, wp], "dot2": [xp, wp],
          "extract": [xp], "twiddle": [xp, tw, tws], "recomb": [xp]}
    # copy is the one part a single PyTorch call computes (Tensor.copy_)
    dstp = torch.empty_like(xp)
    for v in kernel_parts.VARIANTS:
        out["plane_parts_" + v] = compare(
            "plane_parts " + v,
            lambda: kernel_parts.plane_parts(v, xp, wp, tw, tws),
            lambda: kernel_parts.plane_parts_plain(v, xp, wp, tw, tws),
            io[v], ops={"dot": macs // 2, "dot2": 2 * macs + macs // 2}
            .get(v, 0), plain_graph=v in ("extract", "twiddle", "recomb"),
            library=(lambda: dstp.copy_(xp), lambda r: r) if v == "copy"
            else None)
    for v, issued in (("dot", 2 * macs), ("dot2", 4 * macs)):
        r = out["plane_parts_" + v]
        r["issued_ops_ms"] = issued / INT8_OPS_PER_S * 1e3
        r["issued_tmac_per_s"] = issued / 2 / (r["graph_ms"] * 1e-3) / 1e12
    # edge shapes, exact only: rows 1, 5, 32 by limbs 1, 3, 9 (at 5 x 9 and
    # 32 x 9 the clusters' ranges cross limb boundaries), extreme values
    for rows in (1, 5, 32):
        for limbs in (1, 3, 9):
            xe, we, twe, twse = kernel_parts.make_inputs(
                rows, limbs, seed=rows * 10 + limbs, device="cuda")
            xe[-1, -1, -1, -4:] = torch.tensor(
                [-1, -2**31, 2**31 - 1, 536870912], dtype=torch.int32)
            for v in kernel_parts.VARIANTS:
                exact(f"plane_parts {v} {rows}x{limbs}",
                      lambda: kernel_parts.plane_parts(v, xe, we, twe, twse),
                      lambda: kernel_parts.plane_parts_plain(v, xe, we, twe,
                                                             twse))
    for name, r in out.items():
        log("kernel_vs_plain", kernel=name, **r)
    return out


def phase_probes(sess, smi: str) -> dict:
    """The probes' own entry point on the card, launches counted around
    it: every micro-benchmark, then kernel_micro on ``sess``."""
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    res = {name: probes.run(name) for name in probes.NAMES
           if name != "kernel_micro"}
    res["kernel_micro"] = probes.run("kernel_micro", sess=sess)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    if not all(r["exact"] for r in res["u8_dot"]) \
            or not res["pallas_s8"]["exact"]:
        raise AssertionError("dot_i8 is not exact in the u8_dot / pallas_s8 "
                             "probes")
    missing = [k for k in ("copy_planes", "muladd_u32", "dot_i8",
                           "plane_parts") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the probes: {missing}")
    log("probes", seconds=round(time.perf_counter() - t0, 3),
        launches=launches, results=res, card=smi)
    return launches


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host µs per call of ``fn`` on the host clock: ``calls`` calls
    enqueued back to back after one call and a synchronise, then one
    synchronise outside the clock.  The card's work per call must be
    shorter than the host's, or the clock reads the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def phase_host_cost(rng, smi: str) -> None:
    """Host µs per call of each probe wrapper on one small plane, of K1 at
    the rescale's INTT [8,2,1,N] and of K3 and K6 at the tail."""
    x = copy_probe.planes_u32((8, 1, 128, 128), device="cuda")
    xp, wp, tw, tws = kernel_parts.make_inputs(1, 1, device="cuda")
    w, a = dot.int8_mxu_inputs(1, device="cuda")
    ctx = Context(preset("bench_n14"))
    xr, tr, kw = ntt_cases(rng, ctx)["ntt_inv_rescale"]
    u, fbc, dt = fbc_cases(rng, ctx)["ntt_fwd_fbc"]
    uc, _, plan, dtc = centered_cases(rng, ctx)["ntt_fwd_centered_tail"]
    calls = {"torch x ^ 1": lambda: x ^ 1,
             "torch x.clone()": lambda: x.clone(),
             "copy_planes": lambda: copy_probe.copy_planes(x, 8),
             "muladd_u32": lambda: overhead2.muladd_u32(x),
             "dot_i8": lambda: dot.dot_i8(w, a),
             "plane_parts": lambda: kernel_parts.plane_parts("copy", xp, wp,
                                                            tw, tws),
             "ntt [8,2,1,N]": lambda: ntt_inv(xr, tr, **kw),
             "ntt_fwd_fbc [8,2,6,N]": lambda: fused_ntt.ntt_fwd_fbc(u, fbc,
                                                                    dt),
             "ntt_fwd_centered [8,2,6,N]":
                 lambda: fused_ntt.ntt_fwd_centered_fbc(uc, plan, dtc)}
    log("host_cost", host_us_per_call={k: host_us(fn)
                                       for k, fn in calls.items()}, card=smi)


# ----------------------------------------------------------------------
# the demos CLI at full size (phase 20)
# ----------------------------------------------------------------------

ROOT = Path(__file__).resolve().parent
DEMO_KEYS = ROOT / "build" / "chip_smoke_keys"
DEMO_ERR = 2 ** -10            # hetpu/demos/{matrix_operations,fft}.py asserts
SWEEP_N, SWEEP_LO, SWEEP_HI = 1 << 15, 2, 26    # math_operations.cpp:614-619
CHAIN_K, CHAIN_REPS = 64, 2    # hetpu's bench_he_all_chained defaults
TCP_TIMEOUT_S = 300
# every demo but the level sweep, at full size: (suite, name) → preset
DEMO_PRESETS = {
    **{("matrix_operations", n): p for n, p in (
        ("op", "ckks_small"), ("elemwise_square", "bfv_small"),
        ("matmul", "bfv_matpow"), ("batch_matmul_bfv", "bfv_batch"),
        ("batch_matmul_ckks", "ckks_small"), ("matpow", "bfv_matpow"),
        ("sum_elems", "ckks_small"), ("least_squares_2d", "ckks_deep_hi"),
        ("batched_matmul_ckks", "ckks_hi"))},
    **{("bfv_operations", n): p for n, p in (
        ("elemwise_square", "bfv_small"), ("batch_matmul_bfv", "bfv_batch"),
        ("matpow_bfv", "bfv_matpow"))},
    ("math_operations", "bench_rot"): "ckks_deep",
    ("fft", "fft"): "ckks_fft_hi",
    ("fft", "bfft"): "ckks_fft_hi",
    **{("client_server_rookie", w): _params_for(w, False)
       for w in CLIENT_DEMOS},
}
# bench_rot's bound.  hetpu's default key switch lifts uncentered digits
# (d_j in [0, Q_j), plus the mod-up's u·Q_j, u < α): their mean ~2·Q_j
# times the key's error e_j, over P, is added to every rotation, and its
# Σ X^k factor peaks at slot 0 (|2/(1-ζ)| ≈ 2N/π), the first value
# bench_rot prints.  At ckks_deep (N=2^15, scale 2^30, α=4, J=4) a
# component's σ is sqrt(Σ (2Q_j/P)^2)·(2N/π)·3.2·sqrt(N/2)/2^30 = 2.6e-3
# (CPU runs of the port and of hetpu agree, PERF.md); 2e-2 is 7.7σ
ROT_BOUND = ("abs", 2e-2, "7.7σ of the slot-0 bias of hetpu's uncentered "
             "key switch at ckks_deep (σ 2.6e-3)")
# what a CKKS demo prints, held against what it expects: (kind, bound,
# source); twice_max's CLI inputs leave the Newton basin (CLIENT_BOUNDS),
# so its run is only checked to finish
DEMO_BOUNDS = {
    ("matrix_operations", "op"): CLIENT_BOUNDS["simple"],
    ("matrix_operations", "sum_elems"): CLIENT_BOUNDS["simple"],
    ("math_operations", "bench_rot"): ROT_BOUND,
    ("matrix_operations", "batch_matmul_ckks"): CLIENT_BOUNDS["batch_matmul"],
    **{k: ("abs", DEMO_ERR, "the demo's assert") for k in (
        ("matrix_operations", "least_squares_2d"),
        ("matrix_operations", "batched_matmul_ckks"), ("fft", "fft"),
        ("fft", "bfft"))},
    **{("client_server_rookie", w): CLIENT_BOUNDS[w]
       for w in CLIENT_DEMOS if w != "twice_max"},
}
# the demos that switch no key: the coefficient FFT (plaintext multiplies
# and rescales)
NO_KEYSWITCH = {("fft", "fft"), ("client_server_rookie", "fft")}
K1_K4 = ("ntt", "ntt_fwd_lifted", "ntt_fwd_fbc", "inner_product")
NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?j?")


def printed_values(s: str) -> np.ndarray:
    """The numbers numpy printed in ``s``: complex where an imaginary part
    (``...j``) follows a real one."""
    if re.search(r"nan|inf", s):
        raise AssertionError(f"a non-finite value was printed: {s!r}")
    vals = []
    for tok in NUMBER.findall(s):
        if tok.endswith("j"):
            vals[-1] += 1j * float(tok[:-1])
        else:
            vals.append(complex(float(tok)))
    return np.array(vals)


def demo_values(what: str, text: str, bound) -> dict:
    """What a demo printed, checked (each check raises): its Timer lines
    (label → seconds); BFV's ``exact:`` flags, all True, and noise budgets,
    all > 0; CKKS's error (its ``max err``, or else its printed values
    against the expected ones that follow them) within ``bound`` (kind,
    bound, source; None: only finished)."""
    out = {"timers": {k: float(v) for k, v in re.findall(
        r"^(.+?): (-?\d+\.\d+) s$", text, re.M)}}
    exact = re.findall(r"exact: (\w+)", text)
    budgets = [int(b) for b in re.findall(r"noise budget [^:]*: (-?\d+) bits",
                                          text)]
    if exact or budgets:
        if not (exact and all(e == "True" for e in exact) and budgets
                and min(budgets) > 0):
            raise AssertionError(f"{what}: exact {exact}, noise budgets "
                                 f"{budgets}:\n{text}")
        return {**out, "exact": exact, "noise_budgets": budgets}
    if bound is None:
        return out
    kind, limit, source = bound
    max_err = re.findall(r"max err = (\S+)", text)
    if max_err:
        err = float(printed_values(max_err[-1])[0].real)
    else:
        head, tail = text.split("expected", 1)
        got = printed_values(head.rsplit("=", 1)[1])
        want = printed_values(re.match(r"\s*=\s*(\[[^\]]*\]|\S+)",
                                       tail).group(1))
        if got.shape != want.shape or not got.size:
            raise AssertionError(f"{what}: printed {got}, expected {want}")
        err = error(kind, got, want)
    if not (np.isfinite(err) and err < limit):
        raise AssertionError(f"{what}: error {err} (bound {limit}, {source})"
                             f":\n{text}")
    return {**out, "error": err, "error_kind": kind, "bound": limit,
            "bound_source": source}


def run_cli(main, argv: list) -> tuple[str, float, dict]:
    """A CLI's ``main(argv)`` in this process, on the card, launch counts
    zeroed just before it: (what it printed, seconds, launches).  A
    failing run's output goes to stderr before the error is raised."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc, launches = _counted(lambda: main(argv))
    except BaseException:
        print(buf.getvalue(), file=sys.stderr, flush=True)
        raise
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{argv}: return code {rc}\n{buf.getvalue()}")
    return buf.getvalue(), seconds, launches


def run_demo(argv: list) -> tuple[str, float, dict, int]:
    """``python -m hetpu_torch.demos <argv>`` (:func:`run_cli`), with the
    peak device bytes."""
    torch.cuda.reset_peak_memory_stats()
    text, seconds, launches = run_cli(demos_main, argv)
    return text, seconds, launches, torch.cuda.max_memory_allocated()


def _printed_lines(text: str) -> list:
    return [ln.rstrip() for ln in text.splitlines()
            if ln.strip() and not re.match(r"^.+?: -?\d+\.\d+ s$", ln)]


def demo_tcp(smi: str) -> dict:
    """One TCP pair at --small: ``server simple`` as a process on the card,
    then ``client simple`` here once the server has printed its listening
    line (hetpu's client connects without retries); the server must name
    the workload it served.  Stops the server on every path."""
    srv = subprocess.Popen(
        [sys.executable, "-m", "hetpu_torch.demos", "server", "simple",
         "--small"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(TCP_TIMEOUT_S, srv.kill)
    watchdog.start()
    try:
        head = []
        for line in srv.stdout:
            head.append(line)
            if line.startswith("listening"):
                break
        else:
            raise AssertionError("tcp: the server ended before it listened:\n"
                                 + "".join(head))
        text, seconds, launches, _ = run_demo(["client", "simple", "--small"])
        tail = srv.stdout.read()
        rc = srv.wait()
    finally:
        watchdog.cancel()
        if srv.poll() is None:
            srv.kill()
            srv.wait()
        srv.stdout.close()
    if rc != 0 or "served workload 'simple'" not in tail:
        raise AssertionError(f"tcp: server rc {rc}:\n{''.join(head)}{tail}")
    values = demo_values("tcp client simple", text, CLIENT_BOUNDS["simple"])
    log("demo", suite="client/server", name="simple", preset="test_tiny",
        transport="tcp", seconds=seconds, **values, launches=launches,
        server_printed=_printed_lines("".join(head) + tail), card=smi)
    return launches


def demo_sweep(text: str, smi: str) -> None:
    """The CLI's eager level sweep (every level 2..26 printed, six ops
    each), then bench_he_all_chained at each level on a session of its
    own: one line a level with J, R and both times."""
    eager = {int(lv): {k: float(v) for k, v in re.findall(
        r"(\w+)=(-?\d+\.\d+)ms", row)}
        for lv, row in re.findall(r"^levels=\s*(\d+)\s+(.*)$", text, re.M)}
    if sorted(eager) != list(range(SWEEP_LO, SWEEP_HI + 1)) \
            or any(len(v) != 6 for v in eager.values()):
        raise AssertionError(f"bench_all printed levels {sorted(eager)}:\n"
                             f"{text}")
    for lv, params in chain_sweep(SWEEP_N, SWEEP_LO, SWEEP_HI):
        t0 = time.perf_counter()
        sess = Session.create(params, galois_steps=[1])
        ks = sess.ctx.keyswitch_plan(sess.ctx.num_data - 1)
        setup = time.perf_counter() - t0
        chained = bench_he_all_chained(sess, CHAIN_K, CHAIN_REPS)
        log("level_sweep", n=SWEEP_N, levels=lv, J=ks.num_digits,
            R=len(ks.basis_tables.primes), eager_ms=eager[lv],
            chained_ms={k: v * 1e3 for k, v in chained.items()},
            chained_steps=CHAIN_K * CHAIN_REPS, setup_seconds=setup,
            card=smi)
        del sess, ks


def demo_kernel_cases(rng) -> dict:
    """K1–K4 (with K6 as phase 4 has it) at the shapes of the full-size
    demos that no earlier phase timed: the sweep's level 26 at one row
    (N=2^15, 27 data primes, one special: α=1, J=27, R=28) and ckks_hi's
    paired-prime path at the batched matmul's 64 rows (N=2^13, J=3, R=8);
    the fft demo's pair rescale of 128 ckks_fft_hi ciphertexts (K1 INTT
    [128,2,2,N], K3 [128,2,2,N]→[128,2,21,N]); bfv_matpow's multiply at
    the 8 rows of a 2×2 square (K1 over Q and over its 9-prime auxiliary
    basis) and its relinearize at 4 (K2, K3, K4)."""
    top = next(p for _, p in chain_sweep(SWEEP_N, SWEEP_HI, SWEEP_HI))
    out = app_kernel_cases(rng, {"sweep26": (top, 1),
                                 "hi13": ("ckks_hi", 64)})
    ctx = Context(preset("ckks_fft_hi"))
    grs = ctx.group_rescale_plan(ctx.num_data - 1)
    src, n = grs.src_tables.primes, ctx.params.poly_degree
    out["ntt_inv_fft128_pair"] = ntt_compare(
        "ntt_inv pair ckks_fft_hi x128", residues(rng, (128, 2, 2, n), src),
        grs.src_tables, dict(strip_mont=True, extra=grs.fbc.inv_punit))
    out["ntt_fwd_fbc_fft128_pair"] = fbc_compare(
        "ntt_fwd_fbc pair ckks_fft_hi x128",
        residues(rng, (128, 2, 2, n), src), grs.fbc, grs.dst_tables)
    del ctx, grs
    bctx = Context(preset("bfv_matpow"))
    top = bctx.num_data - 1
    tq = bctx.tables(top)
    tb = BfvScheme(bctx)._lvl(top)["tables_B"]
    L, K, n = top + 1, len(tb.primes), bctx.params.poly_degree
    k1 = {"ntt_inv_matpow_q2": ((8, 2, L, n), tq, dict(strip_mont=True)),
          "ntt_inv_matpow_q3": ((8, 3, L, n), tq, dict(strip_mont=True)),
          "ntt_fwd_matpow_b2": ((8, 2, K, n), tb, dict(to_mont=True)),
          "ntt_inv_matpow_b3": ((8, 3, K, n), tb, dict(strip_mont=True))}
    for case, (shape, t, kw) in k1.items():
        out[case] = ntt_compare(f"{case} bfv_matpow",
                                residues(rng, shape, t.primes), t, kw)
    ks = bctx.keyswitch_plan(top)
    out["ntt_fwd_lifted_matpow"] = lift_compare(
        "ntt_fwd_lifted bfv_matpow x4", residues(rng, (4, L, n), tq.primes),
        ks, top)
    md = ks.moddown.src_tables.primes
    out["ntt_fwd_fbc_matpow_moddown"] = fbc_compare(
        "ntt_fwd_fbc moddown bfv_matpow x4", residues(rng, (4, 2, len(md), n),
                                                      md),
        ks.moddown.fbc, ks.moddown.dst_tables)
    out["inner_product_matpow"] = ip_compare("inner_product bfv_matpow x4",
                                             rng, ks, 4)
    for name, r in out.items():
        log("kernel_vs_plain", kernel=name, **r)
    return out


def phase_demos(rng, smi: str) -> tuple[dict, dict]:
    """Every suite and name of ``python -m hetpu_torch.demos`` at full size
    on the card, in this process through the CLI's ``main``, from a fresh
    key cache under build/ (``keycache.CACHE_DIR``, which HETPU_KEY_CACHE
    sets at import: keygen on the card, no key of an earlier tree
    loaded): one line a demo with its preset, seconds, Timer lines,
    checked values, launches and peak device memory; the level sweep
    (eager from the CLI, chained from CUDA graphs); one TCP pair; then
    K1–K4 at the demos' new shapes.  Returns (the kernel cases' times, the
    launches summed over the demos' runs)."""
    t_phase = time.perf_counter()
    shutil.rmtree(DEMO_KEYS, ignore_errors=True)
    keycache.CACHE_DIR = DEMO_KEYS
    total = dict.fromkeys(cuda_lib.launches, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    for (suite, name), pname in DEMO_PRESETS.items():
        text, seconds, launches, peak = run_demo([suite, name])
        values = demo_values(f"demo {suite} {name}", text,
                             DEMO_BOUNDS.get((suite, name)))
        _need(launches, ("ntt",) if (suite, name) in NO_KEYSWITCH else K1_K4,
              f"demo {suite} {name}",
              absent=("ntt_fwd_centered", "centered_fbc"))
        log("demo", suite=suite, name=name, preset=pname, seconds=seconds,
            **values, printed=_printed_lines(text), launches=launches,
            peak_device_bytes=peak, card=smi)
        add(launches)
    text, seconds, launches, peak = run_demo(["math_operations", "bench_all"])
    _need(launches, K1_K4, "demo math_operations bench_all")
    log("demo", suite="math_operations", name="bench_all",
        preset=f"chain_sweep N={SWEEP_N} levels {SWEEP_LO}..{SWEEP_HI}",
        seconds=seconds, launches=launches, peak_device_bytes=peak, card=smi)
    add(launches)
    demo_sweep(text, smi)
    add(demo_tcp(smi))
    _need(total, K1_K4, "the demos")
    timings = demo_kernel_cases(rng)
    log("demos", seconds=round(time.perf_counter() - t_phase, 3),
        launches=total, key_cache=str(DEMO_KEYS.relative_to(ROOT)), card=smi)
    return timings, total


# ----------------------------------------------------------------------
# hetpu's measuring programs: python -m hetpu_torch.bench (phase 21)
# ----------------------------------------------------------------------

BENCH_OUT = ROOT / "build" / "chip_smoke_bench.json"
CHECK_STEPS = 2
# tests/test_linalg.py:83: hetpu's own bound on the diagonal matmul
# (atol=1e-2)
MATVEC_MAX_ERR = 1e-2


def run_bench(argv: list) -> tuple[list, float, dict]:
    """``python -m hetpu_torch.bench <argv>`` (:func:`run_cli`): (the JSON
    lines it printed, seconds, launches); no chain may grow device memory
    over its replays."""
    text, seconds, launches = run_cli(bench_main, argv)
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")]
    for ln in lines:
        if ln.get("grown_bytes"):
            raise AssertionError(f"bench {argv}: device memory grew over "
                                 f"the replays: {ln}")
    return lines, seconds, launches


def _two_steps(chain) -> tuple:
    for _ in range(CHECK_STEPS):
        chain()
    torch.cuda.synchronize()
    return chain.tag.cpu(), chain.out.cpu()


def _graph_steps(chain) -> tuple:
    """The same steps replayed from the captured step, from a zero tag."""
    graph = probes.Captured(chain)
    chain.tag.zero_()
    for _ in range(CHECK_STEPS):
        graph.replay()
    torch.cuda.synchronize()
    return chain.tag.cpu(), chain.out.cpu()


def bench_chain_check() -> dict:
    """The chains that no earlier phase captured, at bench_n14 B=8 (keys
    for steps 1..128 in powers of two): the card's tag and last output
    after 2 eager steps equal the same 2 steps replayed from the captured
    step, bit for bit, for multiply_relin_rescale, rotate(·, 1) and the
    8-step rotate_hoisted, and the 64-rotation matvec at ckks_small; and
    for multiply_relin_rescale and rotate they equal the same chain on the
    CPU (the plain twins, the same keys and inputs)."""
    sess = Session.create("bench_n14", seed=bench_headline.SEED,
                          galois_steps=bench_secondary.HOIST_STEPS)
    cpu = Session.from_wire(sess.ctx.params, sess.rk, sess.gk, device="cpu")
    a, b = bench_headline.operands(sess, B)
    make = {"multiply_relin_rescale": lambda s, a, b: bench_headline.chain(
                s, a, b),
            "rotate": lambda s, a, b: bench_secondary.rotate(s, a),
            "rotate_hoisted": lambda s, a, b: bench_secondary.rotate_hoisted(
                s, a)}
    out = {}
    for name, fn in make.items():
        card = _two_steps(fn(sess, a, b))
        graph = _graph_steps(fn(sess, a, b))
        same = {"graph": all(map(torch.equal, card, graph))}
        if name != "rotate_hoisted":
            same["cpu"] = all(map(torch.equal, card, _two_steps(
                fn(cpu, a.to("cpu"), b.to("cpu")))))
        if not all(same.values()) or not card[1].any():
            raise AssertionError(f"bench chain {name}: the card's 2 steps "
                                 f"differ: {same}")
        out[name] = same
    del sess, cpu
    _, _, bm, vb = bench_workloads.matvec_operands(
        "cuda", False, np.random.default_rng(0))
    card = _two_steps(bench_workloads.matvec_chain(bm, vb))
    graph = _graph_steps(bench_workloads.matvec_chain(bm, vb))
    if not all(map(torch.equal, card, graph)):
        raise AssertionError("bench chain enc_matvec64: the graph's 2 steps "
                             "differ from the eager steps")
    out["enc_matvec64"] = {"graph": True}
    return out


def phase_bench(smi: str) -> dict:
    """``python -m hetpu_torch.bench``: headline at its defaults (bench_n14,
    B=8, K=1536, reps 2), secondary at its full sizes, workloads' keygen
    and secondary sections into BENCH_OUT; each program's metric lines
    checked (hetpu's names and units, finite and positive, no device
    memory grown over the replays), K1-K4 launched by each, the record's
    meta naming the card, enc_matvec64_max_err within MATVEC_MAX_ERR; then
    the chains' 2-step check.  Returns the launches summed over the
    programs' runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(cuda_lib.launches, 0)
    BENCH_OUT.unlink(missing_ok=True)
    want = {"headline": [bench_headline.METRIC],
            "secondary": list(bench_secondary.K)}
    for argv in (["headline"], ["secondary"],
                 ["workloads", "--only", "keygen", "--out", str(BENCH_OUT)],
                 ["workloads", "--only", "secondary", "--out",
                  str(BENCH_OUT)]):
        lines, seconds, launches = run_bench(argv)
        _need(launches, ("ntt",) if "keygen" in argv else K1_K4,
              f"bench {' '.join(argv)}")
        metrics = [ln for ln in lines if "metric" in ln]
        if argv[0] in want and [m["metric"] for m in metrics] \
                != want[argv[0]]:
            raise AssertionError(f"bench {argv}: printed {lines}")
        for m in metrics:
            if not (np.isfinite(m["value"]) and m["value"] > 0) \
                    or m["unit"] not in ("ops/s", "planes/s"):
                raise AssertionError(f"bench {argv}: {m}")
        for k, v in launches.items():
            total[k] += v
        log("bench", argv=argv, seconds=seconds, lines=lines,
            launches=launches, card=smi)
    record = json.loads(BENCH_OUT.read_text())
    sec = record["secondary"]
    if record["meta"]["card"] != smi or set(record) != {
            "meta", "keygen", "secondary"} \
            or set(sec) != set(want["secondary"]) | {
                "enc_matvec64_n13_ops_per_s", "enc_matvec64_max_err"}:
        raise AssertionError(f"bench record: {record}")
    if not sec["enc_matvec64_max_err"] < MATVEC_MAX_ERR:
        raise AssertionError(f"enc_matvec64_max_err "
                             f"{sec['enc_matvec64_max_err']} >= "
                             f"{MATVEC_MAX_ERR}")
    log("bench_record", record=record, path=str(BENCH_OUT.relative_to(ROOT)),
        card=smi)
    log("bench_chains", same=bench_chain_check(), steps=CHECK_STEPS,
        preset="bench_n14", batch=B)
    log("bench_phase", seconds=round(time.perf_counter() - t_phase, 3),
        launches=total, card=smi)
    return total


# ----------------------------------------------------------------------
# hetpu's op-profiling programs (phase 22)
# ----------------------------------------------------------------------

PROFILE_ARGV = (["profile_fused"], ["op_parts_chain"],
                ["bench_sweep", "--K", "8", "32"], ["probe_n15b"],
                ["probe_lsq_twice"], ["trace_op", "--steps", "2"])
LSQ_MAX_ERR = 2.0 ** -10


def _label_pattern(node) -> str:
    if isinstance(node, ast.Constant):
        return re.escape(node.value)
    return "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                   else ".+?" for v in node.values)


def script_labels(name: str) -> list:
    """The labels scripts/<name>.py passes to chain, timeit or direct (its
    printed strings where it has none), as regexes."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.args
             and isinstance(n.args[0], (ast.Constant, ast.JoinedStr))]
    labels = [c.args[0] for c in calls
              if c.func.id in ("chain", "timeit", "direct")] or [
        c.args[0] for c in calls if c.func.id == "print"]
    return [_label_pattern(n) for n in labels]


def _eager_equals_graph(chain, k: int) -> bool:
    """The tag and last output after k eager steps from a zero tag equal
    those after k replays of the captured step from a zero tag."""
    chain.tag.zero_()
    for _ in range(k):
        chain()
    torch.cuda.synchronize()
    eager = chain.tag.clone(), chain.out.clone()
    graph = probes.Captured(chain)
    chain.tag.zero_()
    for _ in range(k):
        graph.replay()
    torch.cuda.synchronize()
    return all(map(torch.equal, eager, (chain.tag, chain.out)))


def profile_chain_check() -> dict:
    """Every chain of the op-profiling programs at its script's size and K:
    label → its eager steps equal its replays."""
    n14 = keycache.cached_session("bench_n14", seed=profile_fused.SEED,
                                  galois_steps=[1])
    deep = keycache.cached_session("ckks_deep_hi", seed=probe_n15.SEED,
                                   galois_steps=probe_n15.GALOIS)
    items = [(f"profile_fused:{label}", c, profile_fused.K)
             for label, c in profile_fused.chains(n14, profile_fused.B)]
    items += [(f"profile_hotpath:{label}", c, profile_hotpath.ITERS)
              for label, c in profile_hotpath.chains(n14,
                                                     profile_hotpath.BATCH)]
    items += [(f"op_parts_chain:B={b} {label}", c, op_parts_chain.K)
              for label, c, b in op_parts_chain.chains(n14)]
    ops = bench_sweep.operands(n14)
    items += [(f"bench_sweep:B={b} K={k}", bench_sweep.chain(n14, *ops, b), k)
              for b in bench_sweep.BATCHES for k in (8, 32)]
    items.append(("trace_op", trace_op.chain(n14, trace_op.BATCH), 2))
    items += [(f"probe_n15:{label}", c, k)
              for label, c, k, _ in probe_n15.chains_n15(deep)]
    _, n15b = probe_n15.n15b(deep)
    items += [(f"probe_n15b:{label}", c, k) for label, c, k, _ in n15b]
    same = {}
    for name, c, k in items:
        same[name] = _eager_equals_graph(c, k)
        if not same[name] or not c.out.any():
            raise AssertionError(f"profile chain {name}: {k} eager steps "
                                 "differ from the replays of its graph")
    return same


def phase_profiles(smi: str) -> dict:
    """``python -m hetpu_torch.bench`` op-profiling programs (PROFILE_ARGV)
    at the scripts' sizes: each script's labels printed, no device memory
    grown, K1-K4 launched, the records written naming the card, the lsq
    fit within LSQ_MAX_ERR; then every chain's eager steps against its
    replays.  Returns the launches summed over the programs' runs."""
    t_phase = time.perf_counter()
    total = dict.fromkeys(cuda_lib.launches, 0)
    for argv in PROFILE_ARGV:
        name = argv[0]
        record_path = bench_workloads.OUT_DIR / f"{name}.json"
        record_path.unlink(missing_ok=True)
        text, seconds, launches = run_cli(bench_main, argv)
        for ln in text.splitlines():
            if ln.startswith("{") and json.loads(ln).get("grown_bytes"):
                raise AssertionError(f"bench {argv}: device memory grew "
                                     f"over the replays: {ln}")
        _need(launches, K1_K4, f"bench {' '.join(argv)}")
        lines = text.splitlines()
        missing = [p for p in script_labels(name)
                   if not any(re.match(p, ln) for ln in lines)]
        record = json.loads(record_path.read_text())
        if missing or record["card"] != smi:
            raise AssertionError(f"bench {argv}: labels not printed "
                                 f"{missing}, record {record_path}: "
                                 f"{record.get('card')}")
        if name == "probe_lsq_twice" and not record["max_err"] < LSQ_MAX_ERR:
            raise AssertionError(f"probe_lsq_twice max_err "
                                 f"{record['max_err']} >= {LSQ_MAX_ERR}")
        for k, v in launches.items():
            total[k] += v
        log("profiles", argv=argv, seconds=round(seconds, 3),
            launches=launches, record=str(record_path.relative_to(ROOT)),
            lines=[ln for ln in lines if not ln.startswith('{"program"')],
            card=smi)
    same = profile_chain_check()
    log("profile_chains", chains=len(same), same=all(same.values()),
        card=smi)
    log("profiles_phase", seconds=round(time.perf_counter() - t_phase, 3),
        launches=total, card=smi)
    return total


# ----------------------------------------------------------------------
# the parallel layer: SPMD ranks on the card (phase 19)
# ----------------------------------------------------------------------

PAR_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_ranks"
PAR_SEED = b"\x21" * 32
PAR_STEPS = list(range(N_DIAGS))      # 0..7: bucketed_matvec and infer_step
TP_LEVEL = 7                   # L = 8 limbs: the top level's 9 divide no 2^k
MATVEC_D = 8
MATVEC_ERR = 1e-2              # tests/test_parallel.py:214
PAR_TIMEOUT_S = 300
SNIPPET = (8, 128)             # SNIPPETS.md: an [8, 128] f32 shard a device
PIPE_CALLS = 5                 # calls timed a pipeline step (median, spread)


def _seconds(fn, mesh=None) -> dict:
    """Host seconds of ``PIPE_CALLS`` calls of ``fn``, each between two
    card syncs (the ranks of ``mesh`` meet at a barrier before each): the
    median with the least and the most, after one warm-up call."""
    fn()
    times = []
    for _ in range(PIPE_CALLS):
        torch.cuda.synchronize()
        if mesh is not None:
            mesh.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"median": statistics.median(times), "min": min(times),
            "max": max(times), "calls": PIPE_CALLS}


def _par_inputs(sess) -> dict:
    """The global inputs every rank (and the parent) builds alike: values
    from a seeded rng, encryptions under fixed seeds."""
    rng = np.random.default_rng(808)
    n, slots = sess.ctx.params.poly_degree, sess.slots
    enc = lambda v, tag, level=None: sess.encrypt(
        v, level=level, seed=bytes([tag]) * 32)
    x, y = rng.uniform(-1, 1, (2, slots))
    A = rng.uniform(-1, 1, (MATVEC_D, MATVEC_D))
    v = rng.uniform(-1, 1, MATVEC_D)
    rows = [enc(np.tile([A[i, (i + j) % MATVEC_D]
                         for i in range(MATVEC_D)], 2), 10 + j).data
            for j in range(MATVEC_D)]
    xs = rng.uniform(-1, 1, (B, slots))
    primes = sess.ctx.params.moduli
    return {
        "c3": sess.ev.multiply(enc(x, 1, TP_LEVEL), enc(y, 2, TP_LEVEL)),
        "ct": enc(x, 3, TP_LEVEL),
        "cp_x": residues(rng, (len(primes), n), primes),
        "cp_y": residues(rng, (len(primes), n), primes),
        "diags": enc(np.zeros(MATVEC_D), 30).with_(data=torch.stack(rows)),
        "vec": enc(np.tile(v, 2), 31), "A": A, "v": v,
        "inf": [enc(xs[i], 40 + i) for i in range(B)]}


def par_path(sess, inp, meshes: dict, world: int) -> tuple[dict, float]:
    """The parallel path once, on the ranks' meshes by axis (tp, cp, rot,
    dp): tp_relinearize, tp_rotate(1), cp_ntt_fwd / cp_ntt_inv,
    bucketed_matvec and, at 2 ranks, evaluate_sharded_infer.  Returns the
    results and the host seconds from a synchronised start to a
    synchronised end (the four-step tables are built before the start)."""
    from hetpu_torch.parallel import cp, tp
    t4 = cp.build_tables(sess.ctx.params.poly_degree,
                         sess.ctx.params.moduli, meshes["cp"].device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = {"relin": tp.tp_relinearize(sess, inp["c3"], meshes["tp"]),
           "rot1": tp.tp_rotate(sess, inp["ct"], 1, meshes["tp"]),
           "cp_fwd": cp.cp_ntt_fwd(inp["cp_x"], t4, meshes["cp"]),
           "cp_inv": cp.cp_ntt_inv(inp["cp_y"], t4, meshes["cp"]),
           "matvec": parallel.bucketed_matvec(
               sess, inp["diags"], inp["vec"], MATVEC_D, meshes["rot"],
               "rot")}
    if world == 2:
        out["infer"] = pipeline.evaluate_sharded_infer(
            sess, inp["inf"], WSEED, N_DIAGS, meshes["dp"])
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def exchange_latency_ms(fn, mesh, runs: int = TIMED_RUNS) -> float:
    """Median host ms of one exchange ``fn()`` between two card syncs, the
    ranks meeting at a barrier before each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        mesh.barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def exchange_back_to_back_ms(fn, mesh, runs: int = TIMED_RUNS) -> float:
    """Host ms an exchange of ``runs`` exchanges ``fn()`` enqueued back to
    back, one card sync at the end (the ranks start at a barrier)."""
    torch.cuda.synchronize()
    mesh.barrier()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / runs * 1e3


def _p5_case(name, x, mesh, perm) -> dict:
    """P5 on ``x`` (this rank's CUDA tensor) against its gloo twin on the
    same values; every rank times the twin (host clock) and the exchange
    as a latency and back to back; rank 0 then times the store and signal
    alone (``peer.store`` of the last exchange's epoch again, with no
    wait: the same slot, and the "arrived" words keep their value; eager
    and cold) and cudaMemcpyAsync into the same mapped buffer (the library
    yardstick) while the others wait."""
    from hetpu_torch.parallel import peer
    got = parallel.ppermute(x, mesh, "x", perm)
    want = parallel.ppermute(x.cpu(), mesh, "x", perm)
    torch.cuda.synchronize()
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"{name}: peer_permute differs from its twin")
    n = mesh.shape["x"]
    t0 = time.perf_counter()
    for _ in range(TIMED_RUNS):
        parallel.ppermute(x.cpu(), mesh, "x", perm)
    plain_ms = (time.perf_counter() - t0) / TIMED_RUNS * 1e3
    fn = lambda: parallel.ppermute(x, mesh, "x", perm)
    r = {"max_abs_err": 0.0, "plain_ms": plain_ms,
         "latency_ms": exchange_latency_ms(fn, mesh),
         "back_to_back_ms": exchange_back_to_back_ms(fn, mesh),
         "shape_in": list(x.shape), "shape_out": list(got.shape),
         "bound_by": "bytes", "bound_ms": 2 * x.nbytes / HBM_BYTES_PER_S * 1e3,
         "ranks": n}
    torch.cuda.synchronize()
    mesh.barrier()
    if mesh.rank == 0:
        dst = mesh.axis_ranks("x")[dict(perm)[0]]
        segs = [(x, 0, dst, 0, x.nbytes)]
        ex = mesh.exchange
        cap = ex.capacity(x.nbytes)
        _, peers = ex.buffer(cap)
        kernel = lambda: peer.store(mesh, segs, cap, 1 << dst,
                                    ex.epochs[cap])
        library = lambda: peer.copy(peers[dst], x.data_ptr(), x.nbytes,
                                    mesh.device)
        r.update(ms=median_ms(kernel), graph_ms=probes.cold_ms(kernel),
                 library_ms=median_ms(library),
                 library_graph_ms=probes.cold_ms(library))
    torch.cuda.synchronize()
    mesh.barrier()
    return r


def _par_rank(rank: int, world: int, workdir: str, sock=None) -> None:
    """One SPMD rank on cuda:0: P5 against its twin (and timed), then the
    parallel path with the launches counted around it — tp_relinearize,
    tp_rotate(1), cp_ntt_fwd / cp_ntt_inv, bucketed_matvec and, at 2
    ranks, evaluate_sharded_infer — each held against its single-rank
    result on the card; at 2 ranks it then serves one pipeline_infer
    request on ``sock``.  Rank 0 writes the results."""
    import datetime
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_parallel_ranks import p5_capture_refused, p5_stress
    work = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{work}/store{world}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        torch.cuda.set_device(0)
        mesh = parallel.make_mesh((world,), ("x",))
        res, arrays = {"world": world}, {}
        g = torch.Generator().manual_seed(rank)
        snip = torch.randn(SNIPPET, generator=g).to(mesh.device)
        fly = torch.randint(0, 1 << 30, (2, 13, 1 << 14), generator=g,
                            dtype=torch.int32).to(mesh.device)
        right = [(i, (i + 1) % world) for i in range(world)]
        res["p5"] = {"snippet": _p5_case("snippet", snip, mesh, right),
                     "butterfly": _p5_case("butterfly", fly, mesh,
                                           [(i, i ^ 1) for i in range(world)])}
        res["p5_stress"] = p5_stress(mesh)
        if not p5_capture_refused(mesh):
            raise AssertionError("P5: an exchange was captured")
        t0 = time.perf_counter()
        sess = Session.create("bench_n14", seed=PAR_SEED,
                              galois_steps=PAR_STEPS)
        inp = _par_inputs(sess)
        res["setup_s"] = time.perf_counter() - t0
        meshes = {a: parallel.make_mesh((world,), (a,))
                  for a in ("tp", "cp", "rot", "dp")}
        diags, act = pipeline._infer_weights(sess.slots, N_DIAGS, WSEED)
        cuda_lib.reset_launches()
        out, res["path_s"] = par_path(sess, inp, meshes, world)
        res["launches"] = dict(cuda_lib.launches)
        tabs = sess.ctx.tables(sess.ctx.num_data - 1)
        want = {"relin": sess.ev.relinearize(inp["c3"], sess.rk).data,
                "rot1": sess.ev.rotate(inp["ct"], 1, sess.gk).data,
                "cp_fwd": ntt_fwd(inp["cp_x"], tabs),
                "cp_inv": ntt_inv(inp["cp_y"], tabs)}
        got = {k: (v if isinstance(v, torch.Tensor) else v.data)
               for k, v in out.items() if k != "infer"}
        if world == 2:
            single = pipeline.infer_step(sess, stack(inp["inf"]), diags, act)
            again = pipeline.evaluate_sharded_infer(
                sess, inp["inf"], WSEED, N_DIAGS, meshes["dp"])
            res["infer_sharded_s"] = _seconds(
                lambda: pipeline.evaluate_sharded_infer(
                    sess, inp["inf"], WSEED, N_DIAGS, meshes["dp"]),
                meshes["dp"])
            want["infer"] = single.data
            got["infer"] = torch.stack([c.data for c in out["infer"]])
            if not torch.equal(torch.stack([c.data for c in again]),
                               got["infer"]):
                raise AssertionError("evaluate_sharded_infer differs "
                                     "between two calls")
        res["equal"] = {k: bool(torch.equal(got[k], want[k])) for k in want}
        if not all(res["equal"].values()):
            raise AssertionError(f"rank {rank}: sharded results differ from "
                                 f"the single-rank ones: {res['equal']}")
        arrays["matvec"] = to_u32(got["matvec"])
        res["matvec_meta"] = [out["matvec"].level, out["matvec"].scale]
        if sock is not None:
            t = native.Transport(sock=sock) if rank == 0 else None
            if rank != 0:
                sock.close()
            t0 = time.perf_counter()
            res["served"] = pipeline.serve_pipeline(t, meshes["dp"])
            res["serve_s"] = time.perf_counter() - t0
        for m in (mesh, *meshes.values()):
            m.close()
        if rank == 0:
            np.savez(work / f"w{world}.npz", **arrays)
            (work / f"w{world}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _spawn(world: int, sock=None):
    import torch.multiprocessing as mp
    args = (world, str(PAR_DIR)) + ((sock,) if sock is not None else ())
    return mp.start_processes(_par_rank, args=args, nprocs=world,
                              join=False, start_method="spawn")


def _join(ctx) -> None:
    deadline = time.monotonic() + PAR_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError("parallel ranks did not finish")


def phase_parallel(smi: str) -> tuple[dict, dict]:
    """Phase 19: the parallel layer on the card, 2 and 4 ranks on cuda:0
    (they time-slice one card: the times are one card's, never scaling
    numbers).  Each rank: P5 against its gloo twin at the snippet's shape
    and the butterfly's [J=2, R=13, N], its 64-exchange stress sequence
    and the capture refusal; tp_relinearize and tp_rotate(1) at bench_n14
    level 7, cp_ntt_fwd / cp_ntt_inv over the 9 data primes,
    bucketed_matvec d=8 and (2 ranks) evaluate_sharded_infer B=8, each
    equal to its single-rank result; then the 2 ranks serve
    run_client_infer (bench_n14, B=8) from this process.  Here: the
    bucketed ciphertexts at rot 2 and 4 equal rot 1's (a one-rank mesh)
    and decrypt within 1e-2 of A·v; evaluate_sharded_infer with no mesh
    (one rank on the default-device session's card) equals infer_step, and
    both are timed alone on the card."""
    import shutil
    import socket
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    PAR_DIR.mkdir(parents=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a, b = socket.socketpair()
    a.settimeout(PAR_TIMEOUT_S)
    ctx2 = _spawn(2, b)
    b.close()
    try:
        err, res = pipeline.run_client_infer(
            native.Transport(sock=a), batch=B, params="bench_n14",
            n_diags=N_DIAGS, wseed=WSEED, seed=PAR_SEED)
    finally:
        a.close()
        _join(ctx2)
    client_s = time.perf_counter() - t0
    if not err < 5e-3 or len(res) != B:
        raise AssertionError(f"pipeline client: error {err}, {len(res)} "
                             "results")
    _join(_spawn(4))
    sess = Session.create("bench_n14", seed=PAR_SEED, galois_steps=PAR_STEPS)
    inp = _par_inputs(sess)
    one = parallel.bucketed_matvec(sess, inp["diags"], inp["vec"], MATVEC_D,
                                   parallel.make_mesh((1,), ("rot",)), "rot")
    dec = sess.decrypt(one).real[:MATVEC_D]
    mv_err = float(np.abs(dec - inp["A"] @ inp["v"]).max())
    if not mv_err < MATVEC_ERR:
        raise AssertionError(f"bucketed_matvec error {mv_err}")
    diags, act = pipeline._infer_weights(sess.slots, N_DIAGS, WSEED)
    batch = stack(inp["inf"])
    single = pipeline.infer_step(sess, batch, diags, act)
    alone = pipeline.evaluate_sharded_infer(sess, inp["inf"], WSEED, N_DIAGS)
    if not torch.equal(torch.stack([c.data for c in alone]), single.data):
        raise AssertionError("evaluate_sharded_infer without a mesh differs "
                             "from infer_step")
    alone_s = {
        "infer_step": _seconds(
            lambda: pipeline.infer_step(sess, batch, diags, act)),
        "evaluate_sharded_infer": _seconds(
            lambda: pipeline.evaluate_sharded_infer(
                sess, inp["inf"], WSEED, N_DIAGS))}
    runs = {}
    for w in (2, 4):
        runs[w] = json.loads((PAR_DIR / f"w{w}.json").read_text())
        got = np.load(PAR_DIR / f"w{w}.npz")["matvec"]
        if not np.array_equal(got, to_u32(one.data)) \
                or runs[w]["matvec_meta"] != [one.level, one.scale]:
            raise AssertionError(f"bucketed_matvec at rot {w} differs from "
                                 "rot 1")
    launches = runs[2]["launches"]
    missing = [k for k in ("peer_permute", "ntt", "ntt_fwd_lifted",
                           "ntt_fwd_fbc", "inner_product")
               if launches[k] <= 0]
    if missing or runs[2]["served"] != B:
        raise AssertionError(f"parallel path: not launched {missing}, "
                             f"served {runs[2].get('served')}")
    timings = {}
    for w in (2, 4):
        for shape, r in runs[w]["p5"].items():
            timings[f"peer_permute_{shape}_n{w}"] = r
    log("parallel", seconds=round(time.perf_counter() - t0, 3),
        client_infer={"max_err": err, "seconds": round(client_s, 3)},
        matvec_max_err=mv_err, one_rank_s=alone_s,
        ranks={w: {k: v for k, v in r.items() if k != "p5"}
               for w, r in runs.items()},
        note="ranks time-slice one card: one card's times, not scaling",
        card=smi)
    return timings, launches


# name, source, replaced TPU kernel, timing cases (first = the row's
# times; the others are in the kernel_vs_plain lines), path of the launches
PARTS = tuple("plane_parts_" + v for v in kernel_parts.VARIANTS)
APP_TAGS = tuple(APP_SHAPES) + ("sweep26", "hi13")
APP_CONV = tuple(f"{t}_{p}" for t in APP_TAGS for p in ("moddown", "tail")) \
    + ("dhi_pair", "hi13_pair")
KERNELS = [
    ("ntt", "hetpu_torch/csrc/ntt.cu", "hetpu/core/mxu_ntt.py:710",
     ("ntt_inv", "ntt_fwd", "ntt_inv_rescale", "ntt_inv_moddown",
      "ntt_fwd_288", "ntt_inv_bfv_q2", "ntt_inv_bfv_q3", "ntt_fwd_bfv_b2",
      "ntt_inv_bfv_b3", "ntt_inv_bfv_t", "ntt_inv_pair", "ntt_inv_hi_tail")
     + tuple(f"{k}_{t}{x}" for t in APP_TAGS for k, x in (
         ("ntt_inv", ""), ("ntt_fwd", ""), ("ntt_fwd", "_basis"),
         ("ntt_inv", "_moddown")))
     + ("ntt_inv_fft128_pair", "ntt_inv_matpow_q2", "ntt_inv_matpow_q3",
        "ntt_fwd_matpow_b2", "ntt_inv_matpow_b3"),
     "default"),
    ("ntt_fwd_lifted", "hetpu_torch/csrc/fused_ntt.cu",
     "hetpu/core/mxu_ntt.py:816", ("ntt_fwd_lifted", "ntt_fwd_lifted_bfv")
     + tuple("ntt_fwd_lifted_" + t for t in APP_TAGS + ("matpow",)),
     "default"),
    ("ntt_fwd_fbc", "hetpu_torch/csrc/fused_ntt.cu",
     "hetpu/core/mxu_ntt.py:816",
     ("ntt_fwd_fbc", "ntt_fwd_fbc_moddown", "ntt_fwd_fbc_ties",
      "ntt_fwd_fbc_bfv_moddown", "ntt_fwd_fbc_pair", "ntt_fwd_fbc_hi_tail")
     + tuple("ntt_fwd_fbc_" + c for c in APP_CONV
             + ("fft128_pair", "matpow_moddown")), "default"),
    ("inner_product", "hetpu_torch/csrc/ip_kernel.cu",
     "hetpu/core/ip_kernel.py:75", ("inner_product", "inner_product_bfv")
     + tuple("inner_product_" + t for t in APP_TAGS + ("matpow",)),
     "default"),
    ("ntt_fwd_centered", "hetpu_torch/csrc/fused_ntt.cu",
     "hetpu/core/mxu_fbc.py:214",
     ("ntt_fwd_centered_tail", "ntt_fwd_centered_moddown",
      "ntt_fwd_centered_lift", "ntt_fwd_centered_ties",
      "ntt_fwd_centered_bfv_lift", "ntt_fwd_centered_bfv_moddown",
      "ntt_fwd_centered_pair", "ntt_fwd_centered_hi_tail")
     + tuple(f"ntt_fwd_centered_{t}_lift" for t in APP_TAGS)
     + tuple("ntt_fwd_centered_" + c for c in APP_CONV), "centered"),
    # the standalone conversion: no path launches it any more (0 on the
    # centered run); its function is on the path inside ntt_fwd_centered
    ("centered_fbc", "hetpu_torch/csrc/centered_fbc.cu",
     "hetpu/core/mxu_fbc.py:214",
     ("centered_fbc_tail", "centered_fbc_lift0", "centered_fbc_lift1",
      "centered_fbc_moddown", "centered_fbc_ties"), "centered"),
    ("copy_planes", "hetpu_torch/csrc/probes.cu", "scripts/probe_grid.py:30",
     ("copy_planes_rb8", "copy_planes_flat_rb8", "copy_planes_1152"),
     "probes"),
    ("muladd_u32", "hetpu_torch/csrc/probes.cu",
     "scripts/probe_overhead2.py:45", ("muladd_u32",), "probes"),
    ("dot_i8", "hetpu_torch/csrc/dot_i8.cu", "scripts/probe_int8_mxu.py:59",
     ("dot_i8_288", "dot_i8_288_ppb8", "dot_i8_512", "dot_i8_u8xs8",
      "dot_i8_s8xu8", "dot_i8_s8xs8", "dot_i8_u8xu8"), "probes"),
    ("plane_parts", "hetpu_torch/csrc/plane_parts.cu",
     "scripts/probe_kernel_parts.py:57",
     ("plane_parts_twiddle",) + tuple(c for c in PARTS
                                      if c != "plane_parts_twiddle"),
     "probes"),
    ("peer_permute", "hetpu_torch/csrc/peer.cu", "SNIPPETS.md:39",
     tuple(f"peer_permute_{s}_n{w}" for s in ("snippet", "butterfly")
           for w in (2, 4)), "parallel"),
]


CASE_KEYS = ("shape_in", "shape_out", "ms", "graph_ms", "plain_ms",
             "bound_ms", "bound_by", "imul_bound_ms", "library_ms",
             "library_graph_ms", "copy_graph_ms", "latency_ms",
             "back_to_back_ms", "gbps_per_cta",
             "tmac_per_s", "issued_tmac_per_s")


def main() -> int:
    start = time.perf_counter()
    name, smi = phase_device()
    rng = np.random.default_rng(2024)
    phase_build()
    par_timings, par_launches = phase_parallel(smi)
    phase_ntt_golden()
    timings = phase_kernels(rng)
    phase_goldens()
    sess, a, b = phase_main_path(rng)
    phase_time(sess, a, b, smi)
    isess, cent, ct, diags, act, default, centered = phase_infer(rng)
    phase_infer_time(isess, cent, ct, diags, act, a, b, smi)
    phase_profile(isess, cent, ct, diags, act, smi)
    bfv_sess, bfv_ct, bfv_launches = phase_bfv(rng, smi)
    hi_launches = phase_hi(rng, smi)
    phase_wire(sess, a, b, bfv_sess, bfv_ct)
    app_launches = {"least_squares": phase_least_squares(smi),
                    "matmul128": phase_matmul128(smi),
                    "bfft1024x64": phase_bfft(smi), **phase_server(smi)}
    demo_timings, demo_launches = phase_demos(rng, smi)
    timings.update(demo_timings)
    bench_launches = phase_bench(smi)
    profile_launches = phase_profiles(smi)
    timings.update(phase_probe_kernels(rng))
    timings.update(par_timings)
    launches = {"default": default["launches"],
                "centered": centered["launches"],
                "probes": phase_probes(sess, smi),
                **bfv_launches, **hi_launches, **app_launches,
                "demos": demo_launches, "bench": bench_launches,
                "profiles": profile_launches,
                "parallel": par_launches}
    phase_host_cost(rng, smi)
    log("total", seconds=round(time.perf_counter() - start, 3))
    rows = []
    for kname, src, replaces, cases, path in KERNELS:
        r = timings[cases[0]]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": launches[path][kname],
                     "launches_by_path": {p: c[kname]
                                          for p, c in launches.items()},
                     "max_abs_err": max(timings[c]["max_abs_err"]
                                        for c in cases),
                     "ms": r["ms"], "graph_ms": r["graph_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "cases": {c: {k: timings[c][k] for k in CASE_KEYS
                                   if k in timings[c]} for c in cases}})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
