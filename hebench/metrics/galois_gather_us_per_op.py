"""Device µs an op in the kernels of ``evaluate`` launched inside the
program's ``hetpu/rot.galois`` span (``hebench.stages``, innermost): the
Galois automorphisms' gathers, of c0 and of the hoisted digits."""

from hebench import stages


def read(run):
    return stages.us_per_op(run, "hetpu/rot.galois")
