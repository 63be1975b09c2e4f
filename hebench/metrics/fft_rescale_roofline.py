"""The in-slot FFT rescales' share of their roofline, %: their least bytes
a call (``hebench.counts_fft``: each stage's sum read once, its output
over L − g limbs written once) over the card's memory rate, divided by
the device time a call of the kernels launched inside the program's
``hetpu/fft.rescale`` span at any depth (``hebench.spans``)."""

from hebench import counts, counts_fft, spans


def read(run):
    us = spans.us_per_op_within(run, "hetpu/fft.rescale")
    if not us:
        return None
    p = run.params
    least = counts.bound_seconds(counts_fft.rescale_bytes(
        run.config, p["batch"], p["n"]))
    return 100.0 * least / (us * p["batch"] / 1e6)
