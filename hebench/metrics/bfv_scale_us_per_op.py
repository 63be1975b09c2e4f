"""Device µs an op in the kernels of ``evaluate`` launched inside the
program's ``hetpu/bfv.scale`` span (``hebench.stages``): the BFV
multiply's scale-and-round outside its conversions — the inverse NTTs of
the products over both bases, the t·x and Q⁻¹ Shoup passes, the
subtraction and the forward NTT of the result over the data basis."""

from hebench import stages


def read(run):
    return stages.us_per_op(run, "hetpu/bfv.scale")
