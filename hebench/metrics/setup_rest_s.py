"""Seconds of set-up outside every phase of the program: ``setup_s`` less
the seconds of ``hetpu_torch.utils.profiling.host_s``.  Imports, the
harness's and the cell entry's own work (value draws, stacking), the warm-up
call's kernels and lazy loads, device work that a phase's host clock did
not wait for, and the profiler's start: per-layer metrics are read only in
a ``--trace 1`` run, whose ``setup_s`` is read after the profiler has
started (about 9 s on an H100), time that an untraced ``setup_s`` never
holds and that no change to the program moves.  ``host_s`` is read at the
end of the run, after the window and the judge, so a phase opened in the
window is counted as set-up and lowers this by as much, below zero if it
must.  With the other four ``setup_*_s`` it sums to ``setup_s``; None
where the program keeps no ``host_s``."""

from hetpu_torch.utils import profiling


def read(run):
    host_s = getattr(profiling, "host_s", None)
    if host_s is None:
        return None
    return run.setup_s - sum(host_s.values())
