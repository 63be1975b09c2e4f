"""Device µs a transform in the kernels of ``evaluate`` launched while the
program's ``hetpu/fft.masks`` span was open, at any depth
(``hebench.spans``): each in-slot FFT stage's plaintext mask products
(``Evaluator.multiply_plain``) and the ``mod_add``s of their sum.  A
program that opens no such span gives nothing."""

from hebench import spans


def read(run):
    return spans.us_per_op_within(run, "hetpu/fft.masks")
