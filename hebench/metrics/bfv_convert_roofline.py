"""The BFV multiply's precise conversions' share of their roofline, %:
their least bytes a call (``hebench.counts_bfv``, from the
configuration's shapes, never from the program's counter) over the
card's memory rate, divided by the device time a call of the kernels of
``evaluate`` launched inside the program's ``hetpu/bfv.convert`` span.
It counts the same work whatever implements the conversions, so it
cannot pass 100."""

from hebench import counts, counts_bfv, stages


def read(run):
    us = stages.us_per_op(run, "hetpu/bfv.convert")
    if not us:
        return None
    batch = run.params["batch"]
    least = counts.bound_seconds(counts_bfv.convert_call_bytes(run.config,
                                                               batch))
    return 100.0 * least / (us * batch / 1e6)
