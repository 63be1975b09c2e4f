"""Client / server / rookie demos (reference ``client.cpp`` /
``server.cpp`` / ``client_server_rookie.cpp``; counterpart of
``hetpu/demos/offload_demos.py``): run ``server <name>`` in one shell and
``client <name>`` in another (loopback port scan 8080-8100), or
``client_server_rookie <name>`` for the in-process pipe."""

from __future__ import annotations

import threading

import numpy as np

from ..offload.client import Client
from ..offload.server import serve_once
from ..runtime import native
from ..utils.timer import Timer


def _params_for(name, small):
    if name in ("inv", "inv_sqrt_twice", "abs", "twice_max"):
        return "test_deep" if small else "ckks_deep"
    if name == "fft":
        return "test_deep" if small else "ckks_fft"
    return "test_tiny" if small else "ckks_small"


def _run_client(name, t, small, device="cuda"):
    cl = Client(_params_for(name, small), galois_steps=[1], device=device)
    rng = np.random.default_rng(0)
    slots = cl.sess.slots
    tm = Timer()
    if name == "simple":
        x1, x2 = rng.uniform(-1, 1, slots), rng.uniform(-1, 1, slots)
        got = cl.simple(t, x1, x2)
        tm.toc("offload simple time")
        print("op1*op2 =", got.real[:4], "\nexpected =", (x1 * x2)[:4])
    elif name == "batch_matmul":
        a = rng.uniform(-1, 1, (5, 5, slots))
        b = rng.uniform(-1, 1, (5, 5, slots))
        got = cl.batch_matmul(t, a, b)
        tm.toc("offload batch_matmul time")
        want = np.einsum("ikb,kjb->ijb", a, b)
        print("max err =", np.abs(got.real[:, :, :slots] - want).max())
    elif name == "inv":
        x = rng.uniform(0.5, 1.5, slots)
        got = cl.inv(t, x, 0.8, 5)
        tm.toc("offload inv time")
        print("1/x =", got.real[:4], "\nexpected =", (1 / x)[:4])
    elif name == "inv_sqrt_twice":
        x = rng.uniform(0.4, 0.7, slots)
        got = cl.inv_sqrt_twice(t, x, 1.0, 4)
        tm.toc("offload inv_sqrt_twice time")
        print("1/sqrt(2x) =", got.real[:4], "\nexpected =",
              (1 / np.sqrt(2 * x))[:4])
    elif name == "abs":
        x = rng.uniform(0.5, 1.0, slots) * rng.choice([-1, 1], slots)
        got = cl.abs(t, x, 1.0, 4)
        tm.toc("offload abs time")
        print("|x| =", got.real[:4], "\nexpected =", np.abs(x)[:4])
    elif name == "twice_max":
        x1, x2 = rng.uniform(-1, 1, slots), rng.uniform(-1, 1, slots)
        got = cl.twice_max(t, x1, x2, 1.0, 4)
        tm.toc("offload twice_max time")
        print("2max =", got.real[:4], "\nexpected =",
              (2 * np.maximum(x1, x2))[:4])
    elif name == "fft":
        n = 8 if small else 32
        sig = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
        got = cl.fft(t, sig)
        tm.toc("offload fft time")
        print("max err =", np.abs(got - np.fft.fft(sig)).max())
    else:
        raise SystemExit(f"unknown client demo {name!r}")


def demo_client(name, small=False, device="cuda"):
    t = native.connect()
    try:
        _run_client(name, t, small, device)
    finally:
        t.close()


def demo_server(name=None, small=False, device="cuda"):
    """Answer one request.  The listening line is printed once the socket
    listens, so a client started on that line finds it."""
    t, _ = native.serve(on_listen=lambda port: print(
        f"listening on 127.0.0.1:{native.PORT_LO}-{native.PORT_HI} ...",
        flush=True))
    try:
        w = serve_once(t, device=device)
    finally:
        t.close()
    print(f"served workload {w!r}")


def demo_rookie(name, small=False, device="cuda"):
    """Both roles in one process over a socketpair (reference
    client_server_rookie.cpp).  A server that fails closes its end, which
    ends the client's wait, and its error is the one raised; a client that
    fails closes its own, which ends the server's."""
    ta, tb = native.pipe_pair()
    err = []

    def serve():
        try:
            serve_once(tb, device=device)
        except Exception as e:
            err.append(e)
            tb.close()

    th = threading.Thread(target=serve)
    th.start()
    try:
        _run_client(name, ta, small, device)
    except Exception:
        if err:                  # the server failed first
            raise err[0]
        raise
    finally:
        ta.close()
        th.join()
        tb.close()


CLIENT_DEMOS = ("simple", "batch_matmul", "inv", "inv_sqrt_twice", "abs",
                "twice_max", "fft")
