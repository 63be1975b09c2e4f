"""Structured metrics/event log.

Counterpart of ``hetpu/utils/metrics.py``, host-only and identical in
behaviour: one JSON line per event, append-only.  Sink selection:
``HETPU_METRICS=<path>`` appends to a file, ``HETPU_METRICS=-`` writes to
stderr, unset disables (no cost beyond a dict lookup).

``Timer.toc`` emits a ``timer`` event through here, so stage timings
become a structured log.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time

_lock = threading.Lock()
_counters: dict[str, float] = {}


def _sink():
    return os.environ.get("HETPU_METRICS", "")


def enabled() -> bool:
    return bool(_sink())


def emit(event: str, **fields) -> None:
    """Append one JSON event line: {ts, event, **fields}."""
    dst = _sink()
    if not dst:
        return
    line = json.dumps({"ts": round(time.time(), 6), "event": event,
                       **fields}, default=str)
    with _lock:
        if dst == "-":
            print(line, file=sys.stderr, flush=True)
        else:
            with open(dst, "a") as f:
                f.write(line + "\n")


def count(name: str, value: float = 1.0) -> None:
    """In-process counter (flushed by ``dump_counters``)."""
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def dump_counters() -> dict[str, float]:
    """Emit and return a snapshot of all counters."""
    with _lock:
        snap = dict(_counters)
    emit("counters", **snap)
    return snap
