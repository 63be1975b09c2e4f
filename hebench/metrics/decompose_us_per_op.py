"""Device µs an op in the kernels of ``evaluate`` launched inside the
program's ``hetpu/ks.decompose`` span (``hebench.stages``): the digit
decomposition, three package launches into the digits — the inverse NTT
(K1) reading the switched part where it lies, the lift (K2, or K6)
storing the foreign limbs, and K8 ``own_limbs`` storing the own ones."""

from hebench import stages


def read(run):
    return stages.us_per_op(run, "hetpu/ks.decompose")
