"""Device µs an op in kernels that are not the package's own (every
kernel launched inside the ``evaluate`` span whose name is not a
``__global__`` of the program's CUDA sources): the evaluator's plain
passes."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ks = [k for k in t.kernels if k.span == "evaluate" and not t.is_package(k)]
    return sum(k.dur for k in ks) / t.units if t.kernels else None
