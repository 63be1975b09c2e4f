"""The op's share of its roofline, %: the least bytes of a call
(``hebench.counts``) over the card's memory rate, divided by the device
time a call in every kernel launched inside ``evaluate``.  It counts the
same bytes whatever kernels implement the op, so it cannot pass 100."""

from hebench import counts


def read(run):
    t = run.trace
    if t is None or not t.calls:
        return None
    us = sum(k.dur for k in t.kernels if k.span == "evaluate")
    if not us:
        return None
    least = counts.bound_seconds(counts.mul_call_bytes(
        run.config, run.params["batch"]))
    return 100.0 * least / (us / 1e6 / t.calls)
