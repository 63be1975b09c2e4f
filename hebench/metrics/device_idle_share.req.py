"""Share of the traced window's wall with no device operation running,
%, in the served pipelines."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
