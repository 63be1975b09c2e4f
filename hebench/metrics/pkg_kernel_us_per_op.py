"""Device µs an op in the package's own kernels (K1–K8, by name)."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ks = [k for k in t.kernels if k.span == "evaluate" and t.is_package(k)]
    return sum(k.dur for k in ks) / t.units if ks else None
