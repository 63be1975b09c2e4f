"""Device kernels a request, counted in the trace."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or not t.calls:
        return None
    return len(t.kernels) / t.calls
