"""Device kernel time over the traced requests, ms a request."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.calls:
        return None
    return sum(k.dur for k in t.kernels) / 1e3 / t.calls
