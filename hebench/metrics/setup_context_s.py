"""Seconds of set-up in the program's phase ``context``: the preset's
prime search, the context's tables and their upload, and every plan,
per-level view and BFV level built on a cache miss, wherever it is built
(the keys', encryption's and warm-up's included).  Self time on the host
clock, from ``hetpu_torch.utils.profiling.host_s``; None where the program
keeps no ``host_s``.  ``host_s`` is read when the harness reads its
metrics, after the window and the judge: a cell whose window opens a phase
counts that work here as set-up, and ``setup_rest_s`` falls by as much."""

from hetpu_torch.utils import profiling


def read(run):
    host_s = getattr(profiling, "host_s", None)
    if host_s is None:
        return None
    return host_s.get("context", 0.0)
