"""The profiler's reading of a traced slice of the window.

``torch.profiler`` (CPU and CUDA activity) over the first calls of the
window; its Chrome trace is parsed for the device's operations (kernels,
copies, sets) and the benchmark's own spans (``record_function`` around
each call into a layer: ``request``, ``upload``, ``evaluate``,
``download``, ``fold``).  Each kernel is put under the innermost span
open on the host when it was launched (by the trace's correlation ids);
each idle gap of the device under the span open when it began.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from bisect import bisect_right
from dataclasses import dataclass, field
from pathlib import Path

import torch

SPANS = ("request", "upload", "evaluate", "download", "fold")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def span(name: str, on: bool):
    if on:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def package_kernels(csrc: Path) -> frozenset:
    """The ``__global__`` function names of the program's CUDA sources."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
    names = set()
    for src in sorted(csrc.glob("*.cu")):
        names.update(pat.findall(src.read_text()))
    return frozenset(names)


@dataclass
class Op:
    name: str
    cat: str
    start: float                 # µs on the trace's clock
    dur: float
    span: str = "none"


@dataclass
class Trace:
    ops: list                    # device operations in the window
    gaps: list                   # (seconds, span) idle gaps, longest first
    window_s: float
    busy_s: float
    calls: int                   # calls made while tracing
    units: int                   # operations those calls carried
    package: frozenset = field(default_factory=frozenset)

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o.cat == "kernel"]

    def is_package(self, op: Op) -> bool:
        return any(t in self.package for t in re.findall(r"\w+", op.name))


def profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def read(prof, calls: int, units: int, package: frozenset) -> Trace:
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return parse(events, calls, units, package)


def parse(events: list, calls: int, units: int, package: frozenset) -> Trace:
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e["name"] in SPANS]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    req = [s for s in spans if s["name"] == "request"]
    if not req:
        return Trace([], [], 0.0, 0.0, calls, units, package)
    t0 = min(s["ts"] for s in req)
    t1 = max([s["ts"] + s["dur"] for s in req]
             + [e["ts"] + e["dur"] for e in dev])
    at = _innermost(spans)
    ops = [Op(e["name"], e["cat"], e["ts"], e["dur"],
              at(launch.get(e.get("args", {}).get("correlation"), e["ts"])))
           for e in dev if e["ts"] >= t0]
    busy, gaps, end = 0.0, [], t0
    for o in sorted(ops, key=lambda o: o.start):
        if o.start > end:
            gaps.append(((o.start - end) / 1e6, at(end)))
        busy += max(0.0, o.start + o.dur - max(o.start, end))
        end = max(end, o.start + o.dur)
    if t1 > end:
        gaps.append(((t1 - end) / 1e6, at(end)))
    gaps.sort(key=lambda g: -g[0])
    return Trace(ops, gaps, (t1 - t0) / 1e6, busy / 1e6, calls, units,
                 package)


def _innermost(spans: list):
    """ts → name of the innermost benchmark span open at ts ("none")."""
    marks = []                   # (ts, open span names innermost last)
    edges = sorted([(s["ts"], 1, s) for s in spans]
                   + [(s["ts"] + s["dur"], 0, s) for s in spans],
                   key=lambda e: (e[0], e[1]))
    stack = []
    for ts, opening, s in edges:
        if opening:
            stack.append(s["name"])
        elif s["name"] in stack:
            del stack[len(stack) - 1 - stack[::-1].index(s["name"])]
        marks.append((ts, stack[-1] if stack else "none"))
    times = [m[0] for m in marks]

    def at(ts: float) -> str:
        i = bisect_right(times, ts) - 1
        return marks[i][1] if i >= 0 else "none"
    return at


def breakdown(t: Trace) -> dict:
    """The ten device operations that took most time, by name, and the ten
    longest idle gaps, by the host's span; seconds."""
    by = {}
    for o in t.ops:
        by[o.name] = by.get(o.name, 0.0) + o.dur / 1e6
    top = sorted(by.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[s, g] for g, s in t.gaps[:10]]}
