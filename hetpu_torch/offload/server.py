"""Blind evaluator (counterpart of ``hetpu/offload/server.py``; the
reference's ``src/demos/server.cpp``).

Builds its session from the wire on ``device``, computes on encrypted
operands only and returns encrypted results; it has no decryption path.
Operands that form one batch are stacked on the session's device (hetpu
shards that stack over its local device mesh; the port runs on one card).

Note: the reference's ``server_side_inv_sqrt_twice`` calls ``signed_inv``,
a copy-paste bug (``server.cpp:356``, SURVEY.md §2c); like hetpu, this
server computes the intended 1/√(2x).

    python -m hetpu_torch.offload.server   # one request on 127.0.0.1:8080-8100
"""

from __future__ import annotations

import torch

from .. import fft as hefft
from .. import math as hemath
from ..linalg.matrix import Matrix
from ..runtime import native
from . import recv_request, send_reply


def _stack(cts):
    """Operand list → one batched ciphertext."""
    return cts[0].with_(data=torch.stack([c.data for c in cts]))


def _unstack(ct, count: int) -> list:
    return [ct.with_(data=ct.data[i]) for i in range(count)]


def handle(header, sess, cts):
    """Dispatch one workload (the reference's server_side_* bodies)."""
    w = header["workload"]
    if w == "simple":                          # server.cpp:131-137
        return [sess.ev.multiply_relin_rescale(cts[0], cts[1], sess.rk)]
    if w == "batch_matmul":                    # server.cpp:161-237
        m, n, p = header["dims"]
        a = Matrix(sess, _stack(cts[: m * n]), m, n)
        b = Matrix(sess, _stack(cts[m * n:]), n, p)
        return _unstack(a.matmul(b).ct, m * p)
    if w == "inv":                             # server.cpp:289
        return [hemath.signed_inv(sess, cts[0], header["guess"],
                                  header["iters"])]
    if w == "inv_sqrt_twice":                  # server.cpp:356 (bug fixed)
        return [hemath.inv_sqrt_twice(sess, cts[0], header["guess"],
                                      header["iters"])]
    if w == "abs":                             # server.cpp:422
        return [hemath.abs_(sess, cts[0], header["guess"], header["iters"])]
    if w == "twice_max":                       # server.cpp:489-503
        return [hemath.twice_max(sess, cts[0], cts[1], header["guess"],
                                 header["iters"])]
    if w == "fft":                             # server.cpp:569
        out = hefft.fft(sess, _stack(cts))
        return _unstack(out, out.data.shape[0])
    raise ValueError(f"unknown workload {w!r}")


def serve_once(transport=None, device="cuda") -> str:
    """Accept one connection (or use the given transport) and answer one
    request on ``device``.  Returns the workload name."""
    t = transport
    if t is None:
        t, _ = native.serve()
    try:
        header, sess, cts = recv_request(t, device)
        send_reply(t, handle(header, sess, cts))
        return header["workload"]
    finally:
        if transport is None:
            t.close()


def main(workload: str | None = None) -> None:
    """Serve one request, whichever workload it names (``workload`` is
    hetpu's argument, which its ``main`` does not read either)."""
    print(f"hetpu_torch server: listening on "
          f"127.0.0.1:{native.PORT_LO}-{native.PORT_HI}")
    w = serve_once()
    print(f"hetpu_torch server: served workload {w!r}")


if __name__ == "__main__":
    main()
