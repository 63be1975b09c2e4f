"""The program's own stages in a traced slice, and where the device idled.

While a torch profiler records, the port opens a ``hetpu/<stage>`` span
(``record_function``) around each stage of its key-switching op
(``hetpu_torch.utils.profiling.span``).  Here each device operation of
the traced slice is put under the innermost such span open on the host
when it was launched (by the trace's correlation ids; ``"none"`` outside
every stage), beside the benchmark's own span (``hebench.trace``); each
idle gap of the device is labelled ``<benchmark span>/<stage>`` where a
stage was open when it began, and ends in ``@<call>`` where a blocking
CUDA runtime call was in flight on the host during the gap.

``hebench.trace.parse`` keeps only the benchmark's spans, and a profiler
saves its trace once, so the readers take the slice's events from the
profiler the harness holds (:func:`of_run`, found in the callers'
frames), through ``prof.events()`` (:func:`events_of`).  Without program
stages (a program that opens no ``hetpu/`` span) the readers read
nothing.

    python3 -m hebench.stages --workload <name> --seed <n>

runs one traced cell and prints its device µs an op by stage, the share
of ``evaluate``'s kernel time outside every stage, the stages' sum
against the plain and package kernels, the package kernels' bytes and
the longest idle gaps, labelled.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass

from torch.autograd import DeviceType

from . import trace as tr

PREFIX = "hetpu/"
RUNTIME = ("cuda", "cuLaunch")     # CUDA API calls on the host
BLOCKING = ("cudaMalloc", "cudaFree", "cudaHostAlloc",
            "cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


@dataclass
class Op:
    name: str
    cat: str
    start: float                 # µs on the trace's clock
    dur: float
    span: str = "none"           # the benchmark's innermost span
    stage: str = "none"          # the program's innermost stage


@dataclass
class Stages:
    ops: list                    # device operations in the window
    gaps: list                   # (seconds, label), longest first

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o.cat == "kernel"]


def parse(events: list) -> Stages:
    """Chrome-trace events (``ph`` X, with ``cat``, ``name``, ``ts``,
    ``dur``, ``args.correlation``) → the window's device operations with
    their span and stage, and its idle gaps labelled.  The window is
    ``hebench.trace.parse``'s: from the first ``request`` to the last
    request or device operation."""
    xs = [e for e in events if e.get("ph") == "X"]
    user = [e for e in xs if e.get("cat") == "user_annotation"]
    spans = [e for e in user if e["name"] in tr.SPANS]
    stages = [e for e in user if e["name"].startswith(PREFIX)]
    dev = [e for e in xs if e.get("cat") in tr.DEVICE_CATS]
    runtime = [e for e in xs if e.get("cat") == "cuda_runtime"]
    launch = {e["args"]["correlation"]: e["ts"] for e in runtime
              if "correlation" in e.get("args", {})}
    req = [s for s in spans if s["name"] == "request"]
    if not req:
        return Stages([], [])
    t0 = min(s["ts"] for s in req)
    t1 = max([s["ts"] + s["dur"] for s in req]
             + [e["ts"] + e["dur"] for e in dev])
    span_at, stage_at = tr._innermost(spans), tr._innermost(stages)
    ops = []
    for e in dev:
        if e["ts"] < t0:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        ops.append(Op(e["name"], e["cat"], e["ts"], e["dur"], span_at(ts),
                      stage_at(ts)))
    blocking = [e for e in runtime if e["name"] in BLOCKING]

    def label(a: float, b: float) -> str:
        s, st = span_at(a), stage_at(a)
        out = s if st == "none" else f"{s}/{st[len(PREFIX):]}"
        calls = [(min(b, e["ts"] + e["dur"]) - max(a, e["ts"]), e["name"])
                 for e in blocking if e["ts"] < b and e["ts"] + e["dur"] > a]
        return f"{out}@{max(calls)[1]}" if calls else out

    gaps, end = [], t0
    for o in sorted(ops, key=lambda o: o.start):
        if o.start > end:
            gaps.append(((o.start - end) / 1e6, label(end, o.start)))
        end = max(end, o.start + o.dur)
    if t1 > end:
        gaps.append(((t1 - end) / 1e6, label(end, t1)))
    gaps.sort(key=lambda g: -g[0])
    return Stages(ops, gaps)


def events_of(prof) -> list:
    """A stopped ``torch.profiler.profile``'s events (``prof.events()``) in
    the Chrome trace's form that :func:`parse` reads.  A device operation
    and the runtime call that launched it carry one id (the correlation
    id; a launch through ``ctypes`` hangs under no host op, so the id and
    the host time of that call are what place it)."""
    out = []
    for e in prof.events():
        r, n = e.time_range, e.name
        span = n in tr.SPANS or n.startswith(PREFIX)
        if e.device_type == DeviceType.CPU:
            cat = ("user_annotation" if span else "cuda_runtime"
                   if n.startswith(RUNTIME) else "cpu_op")
        else:
            cat = ("gpu_user_annotation" if span else "gpu_memcpy"
                   if n.startswith("Memcpy") else "gpu_memset"
                   if n.startswith("Memset") else "kernel")
        out.append({"ph": "X", "cat": cat, "name": n, "ts": r.start,
                    "dur": r.end - r.start, "args": {"correlation": e.id}})
    return out


def _profiler_in_callers():
    """The stopped profiler a caller holds (the harness's ``run_cell``
    holds the traced slice's), or None."""
    from torch.profiler import profile
    f = sys._getframe(1)
    while f is not None:
        for v in f.f_locals.values():
            if isinstance(v, profile):
                return v
        f = f.f_back
    return None


_cache: list = [None, None]      # [profiler, its Stages]


def of_run(run) -> Stages | None:
    """The traced slice's stages, parsed once a profiler; None without a
    trace, a profiler or a program stage."""
    if run.trace is None:
        return None
    prof = _profiler_in_callers()
    if prof is None:
        return None
    if _cache[0] is not prof:
        _cache[:] = [prof, parse(events_of(prof))]
    st = _cache[1]
    return st if any(o.stage != "none" for o in st.ops) else None


def us_per_op(run, stage: str) -> float | None:
    """Device µs an op in the kernels of ``evaluate`` launched in the
    program's ``stage``; None where none ran."""
    st = of_run(run)
    if st is None or not run.trace.units:
        return None
    ks = [k for k in st.kernels if k.stage == stage and k.span == "evaluate"]
    return sum(k.dur for k in ks) / run.trace.units if ks else None


def summary(st: Stages, calls: int, units: int, launch_bytes: dict) -> dict:
    """One traced slice's reading, as ``__main__`` prints it."""
    ev = [k for k in st.kernels if k.span == "evaluate"]
    total = sum(k.dur for k in ev)
    by = {}
    for k in ev:
        by[k.stage] = by.get(k.stage, 0.0) + k.dur / units
    return {"stage_us_per_op": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "none_share": by.get("none", 0.0) * units / total
            if total else None,
            "stages_sum_us": sum(v for k, v in by.items() if k != "none"),
            "launch_bytes_per_call": {k: b / calls for k, b in
                                      launch_bytes.items() if b},
            "idle_gaps": [[s, g] for g, s in st.gaps[:10]]}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    import torch

    from . import harness
    from . import stages       # the module the readers import, not __main__
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(prog="python3 -m hebench.stages")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args(argv)
    cell = harness.find_cell(a.workload)
    if not torch.cuda.is_available():
        print("hebench.stages: needs a CUDA card", file=sys.stderr)
        return 3
    from hetpu_torch.core import cuda_lib
    out = harness.run_cell(cell, a.seed, a.seconds, True, "cuda", t_start,
                           log=lambda s: print(s, file=sys.stderr))
    m = {k: v["value"] for k, v in out["metrics"].items()}
    calls = cell.params["trace_calls"]
    res = {"workload": a.workload, "seed": a.seed, "correct": out["correct"],
           "metrics": m, "device": out["device"],
           "plain_plus_pkg_us": m["plain_kernel_us_per_op"]
           + m["pkg_kernel_us_per_op"],
           **summary(stages._cache[1], calls, calls * cell.params["batch"],
                     cuda_lib.launch_bytes)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
