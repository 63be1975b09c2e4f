"""A profiler trace of the chained headline op (port of
``scripts/trace_op.py``).

``multiply_relin_rescale`` at bench_n14 (seed 0x21…, galois [1]) B=32, its
output's ``[..., :1, :1, :8]`` folded into the next input
(:func:`..bench.fold_rows8`): one warm-up step, then 5 chained eager steps
under ``torch.profiler`` (:func:`..utils.profiling.trace`), the Chrome
trace written to ``build/hetpu_torch/trace_op/trace.json``.  Prints the
device µs a step of the 15 costliest kernels by name, the package
kernels' share of device time and the device's busy share of the traced
wall time, then hetpu's ``trace done``.  The script's choice of a TPU NTT
backend (``mxu_ntt._FORCE``) has no counterpart here.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from . import OUT_DIR, bench_sweep, meta, write_record
from ..utils.keycache import cached_session
from ..utils.profiling import trace

PRESET, SMALL_PRESET = "bench_n14", "test_dnum"
SEED = b"\x21" * 32
BATCH, STEPS = 32, 5
SMALL_BATCH, SMALL_STEPS = 2, 3
TOP = 15
# name fragments of the package's kernels (csrc/*.cu), most specific first
PACKAGE_KERNELS = (("centered_fbc_kernel", "centered_fbc"),
                   ("centered_kernel", "ntt_fwd_centered"),
                   ("lifted_kernel", "ntt_fwd_lifted"),
                   ("fbc_kernel", "ntt_fwd_fbc"),
                   ("ip_kernel", "inner_product"), ("ntt_kernel", "ntt"))


def chain(sess, batch: int):
    """The script's step (``:9-22``) on two encryptions from rng(0), each
    stacked ``batch`` times: bench_sweep's chain."""
    return bench_sweep.chain(sess, *bench_sweep.operands(sess), batch)


def device_us(prof, steps: int) -> dict:
    """Device µs a step by kernel name, costliest first (empty without a
    card)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", 0.0) / steps
            out[e.key] = out.get(e.key, 0.0) + us
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def package_name(kernel: str) -> str | None:
    """The package kernel a device kernel's name belongs to, if any."""
    return next((k for frag, k in PACKAGE_KERNELS if frag in kernel), None)


def run(small: bool, device: str, out=None, steps: int | None = None) -> dict:
    """Trace the chained steps and print the summary; writes the record
    and returns it.  ``steps`` replaces the traced step count."""
    sess = cached_session(SMALL_PRESET if small else PRESET, seed=SEED,
                          galois_steps=[1], device=device)
    batch = SMALL_BATCH if small else BATCH
    steps = steps or (SMALL_STEPS if small else STEPS)
    name = "trace_op_small" if small else "trace_op"
    trace_dir = Path(out).with_suffix("") if out else OUT_DIR / name
    c = chain(sess, batch)
    c()
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    sync()
    c.tag.zero_()
    with trace(str(trace_dir)) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            c()
        sync()
        wall_us = (time.perf_counter() - t0) * 1e6 / steps
    kernels = device_us(prof, steps)
    total = sum(kernels.values())
    ours = sum(us for k, us in kernels.items() if package_name(k))
    for k, us in list(kernels.items())[:TOP]:
        print(f"{us:10.1f} us/step  {package_name(k) or 'plain'}  {k[:90]}",
              flush=True)
    summary = {"steps": steps, "batch": batch, "wall_us_per_step": wall_us,
               "device_us_per_step": total if kernels else None,
               "package_share": ours / total if total else None,
               "busy_share": total / wall_us if kernels else None,
               "top": dict(list(kernels.items())[:TOP]),
               "trace": str(trace_dir / "trace.json")}
    print(json.dumps({k: v for k, v in summary.items() if k != "top"}),
          flush=True)
    print("trace done", flush=True)
    record = {**summary, **meta(device)}
    write_record(name, record, out)
    return record
