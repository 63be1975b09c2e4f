"""The Galois gathers' share of their roofline, %: the bytes the gathers
of the traced slice moved by the program's own reckoning
(``hetpu_torch.core.galois.gather_bytes``, counted only while a profiler
records: every plane read once and written once) over the card's memory
rate, divided by the device time of the kernels of ``evaluate``
launched inside ``hetpu/rot.galois`` in the traced slice.  A program
without that counter gives nothing."""

from hebench import counts, stages


def read(run):
    us = stages.us_per_op(run, "hetpu/rot.galois")
    if not us:
        return None
    from hetpu_torch.core import galois
    nbytes = sum(getattr(galois, "gather_bytes", {}).values())
    if not nbytes:
        return None
    return 100.0 * counts.bound_seconds(nbytes) / (us * run.trace.units
                                                   / 1e6)
