"""Device time under a program span at any depth.

``hebench.stages`` puts each kernel under the innermost ``hetpu/`` span
open when it was launched.  A span that encloses others
(``hetpu/rot.step`` ⊃ ``hetpu/rot.galois``, ``hetpu/ks.inner``,
``hetpu/ks.mod_down``) is read here instead: every kernel of
``evaluate`` whose launch lies inside a span of that name counts, at
whatever depth.  The events come from the profiler the harness holds,
as :mod:`.stages` finds it; a program that opens no such span gives
nothing.
"""

from __future__ import annotations

from bisect import bisect_right

from . import stages
from . import trace as tr

_cache: list = [None, None]      # [profiler, its parse]


def parse(events: list) -> tuple[list, dict]:
    """Chrome-trace events → the window's kernels of ``evaluate`` as
    (launch time, µs), and each ``hetpu/`` span name's intervals, sorted
    and merged.  The window is ``hebench.trace.parse``'s."""
    xs = [e for e in events if e.get("ph") == "X"]
    user = [e for e in xs if e.get("cat") == "user_annotation"]
    spans = [e for e in user if e["name"] in tr.SPANS]
    req = [s for s in spans if s["name"] == "request"]
    if not req:
        return [], {}
    t0 = min(s["ts"] for s in req)
    launch = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    span_at = tr._innermost(spans)
    kernels = []
    for e in xs:
        if e.get("cat") != "kernel" or e["ts"] < t0:
            continue
        ts = launch.get(e.get("args", {}).get("correlation"), e["ts"])
        if span_at(ts) == "evaluate":
            kernels.append((ts, e["dur"]))
    named = {}
    for e in sorted(user, key=lambda e: e["ts"]):
        if e["name"].startswith(stages.PREFIX):
            iv = named.setdefault(e["name"], [])
            end = e["ts"] + e["dur"]
            if iv and e["ts"] <= iv[-1][1]:
                iv[-1] = (iv[-1][0], max(iv[-1][1], end))
            else:
                iv.append((e["ts"], end))
    return kernels, named


def device_us_within(kernels: list, intervals: list) -> float:
    """µs of the ``kernels`` whose launch lies inside one of the sorted,
    disjoint ``intervals``."""
    starts = [a for a, _ in intervals]
    total = 0.0
    for ts, dur in kernels:
        i = bisect_right(starts, ts) - 1
        if i >= 0 and ts <= intervals[i][1]:
            total += dur
    return total


def us_per_op_within(run, name: str) -> float | None:
    """Device µs an op in the kernels of ``evaluate`` launched while the
    program's span ``name`` was open, at any depth; None where none
    ran."""
    if run.trace is None or not run.trace.units:
        return None
    prof = stages._profiler_in_callers()
    if prof is None:
        return None
    if _cache[0] is not prof:
        _cache[:] = [prof, parse(stages.events_of(prof))]
    kernels, named = _cache[1]
    us = device_us_within(kernels, named.get(name, []))
    return us / run.trace.units if us else None
