"""The package kernels' share of their roofline, %: the bytes their
launches in the traced slice moved, by the program's own reckoning
(``hetpu_torch.core.cuda_lib.launch_bytes``, counted only while a
profiler records: each operand limb read once, each output limb written
once), over the card's memory rate, divided by the device time of the
package's kernels (K1-K8, by name) in the traced slice.  A kernel that
moves its bytes slowly lowers it; a kernel that moves more bytes than
its operands does not raise it."""

from hebench import counts


def read(run):
    t = run.trace
    if t is None:
        return None
    from hetpu_torch.core import cuda_lib
    nbytes = sum(getattr(cuda_lib, "launch_bytes", {}).values())
    us = sum(k.dur for k in t.kernels if t.is_package(k))
    if not nbytes or not us:
        return None
    return 100.0 * counts.bound_seconds(nbytes) / (us / 1e6)
