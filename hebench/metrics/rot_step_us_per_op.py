"""Device µs an op in the kernels of ``evaluate`` launched while the
program's ``hetpu/rot.step`` span was open, at any depth
(``hebench.spans``): each hoisted rotation step's gathers of c0 and of
the digits, its key's inner product (K4), the mod-down (K1, K3, K8
``sub_mul``), the add and the stack; the caller's multiply of the
step's rotation lies outside it."""

from hebench import spans


def read(run):
    return spans.us_per_op_within(run, "hetpu/rot.step")
