"""Profiling: a ``torch.profiler`` trace and an honest per-op latency.

Counterpart of ``hetpu/utils/profiling.py``.

* ``trace(log_dir)`` — ``torch.profiler`` over the block (CPU activity,
  and CUDA activity where there is a card); the Chrome trace is written to
  ``log_dir/trace.json`` (open it in Perfetto or ``chrome://tracing``);
  it yields ``log_dir``, as the reference's does.  ``profiled(log_dir)``
  is the same, yielding the profiler itself (``key_averages()``).
* ``op_latency(fn, data, iters)`` — seconds per call of ``fn``, with each
  call's input chained to the previous output through a one-bit tag, so
  neither overlap nor reuse of a result can shorten the measure.  Timed
  with CUDA events on the card and ``time.perf_counter`` on the CPU.
* ``span(name)`` — the program's stage span ``hetpu/<name>``
  (``torch.profiler.record_function``), opened only while a torch
  profiler records (:func:`profiler_on`); otherwise one shared no-op
  context, so an untraced call pays one check a span.  Nothing else turns
  it on or off.  The spans land in the profiler's Chrome trace, on its
  clock, which CUPTI aligns with the device's kernels.
* ``phase(name)`` — a set-up phase: its self time on ``time.perf_counter``
  added to :data:`host_s` (phase → seconds), with or without a profiler;
  it opens no span.  Self time is the phase's wall time less that of the
  phases opened inside it (each thread keeps its own stack of open
  phases), so a plan built inside ``encrypt`` counts once, under
  ``context``.  The program opens ``card`` (the kernel library's build
  and load, the first use of the card), ``context`` (a preset's prime
  search, a context's tables, every plan built on a miss of
  ``Context._cached`` or of ``BfvScheme``'s levels), ``keys``, ``encode``
  and ``encrypt``; an evaluator's call opens one only where it builds a
  plan, its first.  ``core.cuda_lib.reset_launches`` clears
  :data:`host_s`.
* ``stage_device_us(events, steps)`` — device µs a step of a Chrome
  trace's kernels, copies and sets by the innermost ``hetpu/`` span open
  on the host when each was launched (``"none"`` outside every stage).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from bisect import bisect_right

import torch

PREFIX = "hetpu/"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_OFF = contextlib.nullcontext()
profiler_on = torch._C._autograd._profiler_enabled
host_s: dict = {}          # phase → self seconds on the host clock (phase)
_host_lock = threading.Lock()
_open = threading.local()  # .stack: the inner phases' seconds, per open one


def span(name: str):
    """``record_function("hetpu/" + name)`` while a torch profiler
    records, else the shared no-op context."""
    if profiler_on():
        return torch.profiler.record_function(PREFIX + name)
    return _OFF


@contextlib.contextmanager
def phase(name: str):
    """Add the block's self time (its wall time less that of the phases
    opened inside it) to ``host_s[name]``; also a decorator."""
    stack = _open.__dict__.setdefault("stack", [])
    stack.append(0.0)
    t = time.perf_counter()
    try:
        yield
    finally:
        wall = time.perf_counter() - t
        self_s = wall - stack.pop()
        with _host_lock:
            host_s[name] = host_s.get(name, 0.0) + self_s
        if stack:
            stack[-1] += wall


def stage_device_us(events: list, steps: int = 1) -> dict:
    """Device µs a step by program stage, costliest first, from a Chrome
    trace's ``traceEvents``: each device operation goes under the
    innermost ``hetpu/`` span open when its launch (the runtime call of
    the same correlation id) began."""
    xs = [e for e in events if e.get("ph") == "X"]
    stages = sorted((e for e in xs if e.get("cat") == "user_annotation"
                     and e["name"].startswith(PREFIX)),
                    key=lambda e: e["ts"])
    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    starts = [e["ts"] for e in stages]
    out = {}
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        name = "none"
        for s in reversed(stages[:bisect_right(starts, ts)]):
            if ts <= s["ts"] + s["dur"]:
                name = s["name"]
                break
        out[name] = out.get(name, 0.0) + e["dur"] / steps
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _default_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "hetpu_torch_trace")


@contextlib.contextmanager
def profiled(log_dir: str | None = None):
    """Profile the block; yields the profiler (``key_averages()`` etc.)
    and writes ``<log_dir>/trace.json`` on exit (the port's own form:
    :func:`trace` yields the directory, as the reference's does)."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or _default_dir()
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the block into ``<log_dir>/trace.json``; yields
    ``log_dir``."""
    log_dir = log_dir or _default_dir()
    with profiled(log_dir):
        yield log_dir


def _tag(x: torch.Tensor) -> torch.Tensor:
    """One bit of ``x``: the parity of the sum of ``x[..., :1, :8]`` (the
    reference's ``_tag``), as an int64 scalar on x's device."""
    return x[..., :1, :8].to(torch.int64).sum() & 1


def op_latency(fn, data: torch.Tensor, iters: int = 10) -> float:
    """Seconds per call of ``fn(data ^ tag) -> tensor``, where each tag
    comes from the previous call's output (one warm-up call with tag 0
    first)."""
    def step(tag):
        return _tag(fn(data ^ tag.to(data.dtype)))

    tag = step(torch.zeros((), dtype=torch.int64, device=data.device))
    if data.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            tag = step(tag)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        tag = step(tag)
    return (time.perf_counter() - t0) / iters
