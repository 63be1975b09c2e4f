"""The hoisted rotation steps' share of their roofline, %: their least
bytes an op (``hebench.counts_matmul``, from the configuration's shapes,
never from the program's counter) over the card's memory rate, divided
by the device time an op of the kernels launched inside the program's
``hetpu/rot.step`` span at any depth (``hebench.spans``).  It counts the
same work whatever implements the steps, so it cannot pass 100."""

from hebench import counts, counts_matmul, spans


def read(run):
    us = spans.us_per_op_within(run, "hetpu/rot.step")
    if not us:
        return None
    least = counts.bound_seconds(counts_matmul.rot_steps_bytes(
        run.config, run.params["dim"]))
    return 100.0 * least / (us / 1e6)
