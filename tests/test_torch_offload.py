"""The port's offload protocol, blind server and client
(``hetpu_torch.offload``) against hetpu's on the CPU.

* One fixed set of request frames per workload, built once from hetpu
  clients (test_tiny: simple, batch_matmul; test_deep: inv,
  inv_sqrt_twice, abs, twice_max, fft), served by hetpu's
  ``recv_request`` + ``handle`` + ``send_reply`` and by the port's: the
  reply frames are equal byte for byte, and decrypt within
  tests/test_offload.py's bounds (simple 1e-3, batch_matmul 1e-2), the
  same iterations on the plain values (1e-3) or ``numpy.fft`` (1e-3).
* A hetpu client and the port's client against the port's server over an
  in-process socket pair, the server in a thread.
* The server is blind: its session has no decryptor and no encryptor.
"""

import threading

import numpy as np
import pytest

from hetpu.offload import recv_request as ref_recv_request
from hetpu.offload import send_reply as ref_send_reply
from hetpu.offload import send_request as ref_send_request
from hetpu.offload.client import Client as RefClient
from hetpu.offload.server import handle as ref_handle
from hetpu_torch.offload import recv_request, send_reply
from hetpu_torch.offload.client import Client
from hetpu_torch.offload.server import handle, serve_once
from hetpu_torch.runtime import native
from torch_app_cases import (abs_replica, fixed_seeds, inv_replica,
                             inv_sqrt_twice_replica)

SEED = b"\x05" * 32
ITERS, INV_ITERS, N_FFT = 1, 2, 4


class Wire:
    """A transport that records the frames sent and hands out the given
    frames in order."""

    def __init__(self, frames=()):
        self.sent = []
        self._frames = list(frames)

    def send(self, payload: bytes) -> None:
        self.sent.append(bytes(payload))

    def recv(self) -> bytes:
        return self._frames.pop(0)


def _request(client, workload, operands, meta=None):
    """The frames hetpu's client sends for one workload."""
    ops = [client._encrypt_seeded(v) for v in operands]
    w = Wire()
    ref_send_request(w, workload, client.sess.ctx.params, rk=client.sess.rk,
                     cts=[c for c, _ in ops], seeds=[s for _, s in ops],
                     meta=meta)
    return w.sent


@pytest.fixture(scope="module")
def requests():
    """workload → (hetpu client, request frames, expected values, bound)."""
    tiny = RefClient("test_tiny", seed=SEED, galois_steps=[1])
    deep = RefClient("test_deep", seed=SEED, galois_steps=[1])
    rng = np.random.default_rng(0)
    slots = tiny.sess.slots
    x1, x2 = rng.uniform(-1, 1, (2, slots))
    a = rng.uniform(-1, 1, (2, 3, 8))
    b = rng.uniform(-1, 1, (3, 2, 8))
    ds = deep.sess.slots
    inv = rng.uniform(0.5, 1.5, ds)
    isq = rng.uniform(0.4, 0.7, ds)
    ab = rng.uniform(0.5, 1.0, ds) * rng.choice([-1, 1], ds)
    base = rng.uniform(-0.5, 0.5, ds)
    diff = rng.uniform(0.6, 1.0, ds) * rng.choice([-1, 1], ds)
    m1, m2 = base + diff / 2, base - diff / 2
    sig = rng.uniform(-1, 1, N_FFT) + 1j * rng.uniform(-1, 1, N_FFT)
    g = {"guess": 1.0, "iters": ITERS}
    with fixed_seeds("offload"):
        out = {
            "simple": (tiny, _request(tiny, "simple", [x1, x2]), x1 * x2,
                       1e-3),
            "batch_matmul": (tiny, _request(
                tiny, "batch_matmul",
                [a[i, j] for i in range(2) for j in range(3)]
                + [b[i, j] for i in range(3) for j in range(2)],
                {"dims": [2, 3, 2]}), np.einsum("ikb,kjb->ijb", a, b), 1e-2),
            "inv": (deep, _request(deep, "inv", [inv], {"guess": 0.8,
                                                        "iters": INV_ITERS}),
                    inv_replica(inv, 0.8, INV_ITERS), 1e-3),
            "inv_sqrt_twice": (deep, _request(deep, "inv_sqrt_twice", [isq],
                                              g),
                               inv_sqrt_twice_replica(isq, 1.0, ITERS), 1e-3),
            "abs": (deep, _request(deep, "abs", [ab], g),
                    abs_replica(ab, 1.0, ITERS), 1e-3),
            "twice_max": (deep, _request(deep, "twice_max", [m1, m2], g),
                          m1 + m2 + abs_replica(m1 - m2, 1.0, ITERS), 1e-3),
            "fft": (deep, _request(deep, "fft", list(sig), {"n": N_FFT}),
                    np.fft.fft(sig), 1e-3),
        }
    return out


def _serve(recv, handle_fn, send, frames, **kw):
    header, sess, cts = recv(Wire(frames), **kw)
    w = Wire()
    send(w, handle_fn(header, sess, cts))
    return w.sent, sess


def _decrypt(client, workload, replies):
    """The client's decrypt of the reply frames, shaped as its workload
    method returns them."""
    from hetpu.core import serial as ref_serial
    cts = [ref_serial.load_ciphertext(f, client.sess.ctx)
           for f in replies[1:]]
    vals = [client.sess.decrypt(c) for c in cts]
    if workload == "batch_matmul":
        return np.stack(vals).reshape(2, 2, -1)[:, :, :8].real
    if workload == "fft":
        return np.array([v[0] for v in vals])
    return vals[0].real


@pytest.mark.parametrize("workload", ["simple", "batch_matmul", "inv",
                                      "inv_sqrt_twice", "abs", "twice_max",
                                      "fft"])
def test_reply_frames_equal_hetpu(requests, workload):
    client, frames, expect, bound = requests[workload]
    want, _ = _serve(ref_recv_request, ref_handle, ref_send_reply, frames)
    got, sess = _serve(recv_request, handle, send_reply, frames,
                       device="cpu")
    assert sess.decryptor is None and sess.encryptor is None
    assert len(got) == len(want)
    assert got == want
    np.testing.assert_allclose(_decrypt(client, workload, got), expect,
                               rtol=0, atol=bound)


def test_unknown_workload_refused(requests):
    frames = list(requests["simple"][1])
    frames[0] = frames[0].replace(b'"simple"', b'"train"')
    header, sess, cts = recv_request(Wire(frames), device="cpu")
    with pytest.raises(ValueError, match="unknown workload"):
        handle(header, sess, cts)


def _offload(fn):
    """One request/reply across a socket pair, the port's server on the
    CPU in a thread."""
    ta, tb = native.pipe_pair()
    err = []

    def srv():
        try:
            serve_once(tb, device="cpu")
        except Exception as e:          # surface server-side errors
            err.append(e)
            tb.close()                  # unblock the client

    th = threading.Thread(target=srv)
    th.start()
    try:
        out = fn(ta)
    finally:
        th.join(timeout=300)
        ta.close()
        tb.close()
    assert not th.is_alive()
    if err:
        raise err[0]
    assert ta.kind == "python"
    return out


def test_hetpu_client_against_port_server(requests):
    """hetpu's Client, frames unchanged, answered by the port's server."""
    client = requests["simple"][0]
    rng = np.random.default_rng(1)
    x1, x2 = rng.uniform(-1, 1, (2, client.sess.slots))
    got = _offload(lambda t: client.simple(t, x1, x2))
    np.testing.assert_allclose(got.real, x1 * x2, atol=1e-3)


def test_port_client_against_port_server():
    client = Client("test_tiny", seed=SEED, galois_steps=[1], device="cpu")
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (2, 2, 4))
    b = rng.uniform(-1, 1, (2, 2, 4))
    got = _offload(lambda t: client.batch_matmul(t, a, b))
    np.testing.assert_allclose(got[:, :, :4].real,
                               np.einsum("ikb,kjb->ijb", a, b), atol=1e-2)
