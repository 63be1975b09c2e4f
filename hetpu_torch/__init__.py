"""hetpu_torch — the PyTorch/CUDA port of hetpu (CKKS on an NVIDIA H100).

Module layout follows ``hetpu`` (``core/params.py``, ``core/ntt.py``,
``core/evaluator.py``, ``session.py``, …) so each module's counterpart is
easy to find; ``core/fused_ntt.py`` stands for ``core/mxu_ntt.py``.  The
package imports ``torch`` and never JAX or ``hetpu``; importing it builds
nothing — the CUDA kernels in ``csrc/`` are compiled at their first launch
(see :mod:`hetpu_torch.core.cuda_lib`).

Entry point::

    from hetpu_torch.session import Session
    sess = Session.create("bench_n14", seed=b"\\x21" * 32, device="cuda")
    out = sess.ev.multiply_relin_rescale(sess.encrypt(x), sess.encrypt(y),
                                         sess.rk)
    sess.decrypt(out)
"""
