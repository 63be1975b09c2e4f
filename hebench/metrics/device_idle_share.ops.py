"""Share of the traced window's wall with no device operation running,
%, in the op streams.

The profiler sets most of this number, not the program: untraced, the
streams keep the card 96-98% busy (their ops a second against the device
time a call), while the profiler's host cost leaves 2-40% of a traced
window idle, and that share swings from run to run.  Read it as the
traced run's idle share; a change of the program shows in the device
time a call (``plain_kernel_us_per_op``, ``pkg_kernel_us_per_op``)."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
