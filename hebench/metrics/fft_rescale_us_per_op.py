"""Device µs a transform in the kernels of ``evaluate`` launched while the
program's ``hetpu/fft.rescale`` span was open, at any depth
(``hebench.spans``): each in-slot FFT stage's rescale, in the paired mode
the mod-down of ``ks.mod_down`` (K1, K3, K8 ``sub_mul``) and its copy.
A program that opens no such span gives nothing."""

from hebench import spans


def read(run):
    return spans.us_per_op_within(run, "hetpu/fft.rescale")
