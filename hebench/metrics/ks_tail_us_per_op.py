"""Device µs an op in the kernels of ``evaluate`` launched inside the
program's ``hetpu/ks.tail`` span (``hebench.stages``): the fused relin +
rescale divide, K8 ``tail_src``, K1 inverse, K3 (or K6), K8 ``tail_out``."""

from hebench import stages


def read(run):
    return stages.us_per_op(run, "hetpu/ks.tail")
