"""Device µs an op in the kernels of ``evaluate`` launched inside the
program's ``hetpu/bfv.convert`` span (``hebench.stages``): the BFV
multiply's four precise base conversions between the data basis and the
auxiliary basis (each operand to B, t·x to B, the scaled value back)."""

from hebench import stages


def read(run):
    return stages.us_per_op(run, "hetpu/bfv.convert")
