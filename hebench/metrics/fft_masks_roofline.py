"""The in-slot FFT masks' share of their roofline, %: their least bytes a
call (``hebench.counts_fft``, from the configuration's shapes, never from
the program's counter) over the card's memory rate, divided by the device
time a call of the kernels launched inside the program's
``hetpu/fft.masks`` span at any depth (``hebench.spans``).  It counts the
same work whatever implements the masks, so it cannot pass 100."""

from hebench import counts, counts_fft, spans


def read(run):
    us = spans.us_per_op_within(run, "hetpu/fft.masks")
    if not us:
        return None
    p = run.params
    least = counts.bound_seconds(counts_fft.mask_bytes(
        run.config, p["batch"], p["n"]))
    return 100.0 * least / (us * p["batch"] / 1e6)
