"""Debug audits: determinism and storage aliasing.

Counterpart of ``hetpu/utils/debug.py``.  HE kernels are exact integer
math, so two runs of one function on one input must agree bit for bit;
and an op that returns a tensor sharing an input's storage lets a later
in-place update corrupt the caller's retained ciphertext silently.

* ``determinism_check`` — run a function ``reps`` times on the same
  inputs and require bit-identical outputs (``torch.equal``).
* ``alias_audit`` — count the outputs whose storage overlaps an input's
  (the port's form of the reference's ``donation_audit``, which read the
  declared input→output buffer aliases of the compiled XLA program;
  eager PyTorch has no such declaration, so the audit looks at where the
  returned tensors live).  ``donation_audit`` is the same function under
  the reference's name.
"""

from __future__ import annotations

import torch

from . import leaves, tensor_leaves


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
    return a == b


def determinism_check(fn, *args, reps: int = 2) -> None:
    """Raise AssertionError unless ``fn(*args)`` is bit-identical across
    ``reps`` executions (tensors are snapshotted after each run)."""
    def run():
        return [x.detach().clone() if isinstance(x, torch.Tensor) else x
                for x in leaves(fn(*args))]
    ref = run()
    for rep in range(1, reps):
        again = run()
        if len(again) != len(ref) or not all(map(_same, ref, again)):
            raise AssertionError(f"run {rep + 1} of {reps} differs from "
                                 "run 1: the function is not deterministic")


def _span(t: torch.Tensor):
    s = t.untyped_storage()
    return t.device, s.data_ptr(), s.data_ptr() + s.nbytes()


def alias_audit(fn, *args, expect_aliases: int = 0) -> int:
    """Run ``fn(*args)`` and count the output tensors whose storage
    overlaps the storage of an input tensor.  Returns the count; raises
    if it differs from ``expect_aliases``."""
    ins = [_span(t) for t in tensor_leaves(args)
           if t.untyped_storage().nbytes()]
    n = 0
    for t in tensor_leaves(fn(*args)):
        if not t.untyped_storage().nbytes():
            continue
        dev, lo, hi = _span(t)
        n += any(d == dev and lo < h and l < hi for d, l, h in ins)
    if n != expect_aliases:
        raise AssertionError(
            f"fn returns {n} outputs aliasing an input's storage "
            f"(expected {expect_aliases}) — an evaluator op must not "
            f"silently share caller ciphertext buffers")
    return n


# hetpu's name (``hetpu/utils/debug.py``): there it counts the aliases a
# compiled function declares; eagerly, the storage an output shares with an
# input is the same question
donation_audit = alias_audit
