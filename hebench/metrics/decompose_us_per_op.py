"""Device µs an op in the kernels of ``evaluate`` launched inside the
program's ``hetpu/ks.decompose`` span (``hebench.stages``): the digit
decomposition's copy, inverse NTT (K1), lift (K2, or K6), own-prime Shoup
pass and ``cat``/``stack``."""

from hebench import stages


def read(run):
    return stages.us_per_op(run, "hetpu/ks.decompose")
