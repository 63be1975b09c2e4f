"""Client/server encrypted-compute offload.

Counterpart of ``hetpu/offload/__init__.py`` (the reference's
``client.cpp`` / ``server.cpp`` / ``client_server_rookie.cpp``): the
trusted client keeps the secret key; the blind server builds its session
from the wire (``Session.from_wire``: no decryptor, no encryptor), computes
on ciphertexts only, and replies with ciphertexts.  Frames are those of
hetpu byte for byte (``core/serial``), so either package's client talks to
either package's server.

Wire protocol per request (all frames size-prefixed, runtime/native.py):
  1. JSON header  {workload, num_cts, meta...}
  2. params blob
  3. relin-keys blob          (empty frame if not needed)
  4. galois-keys blob         (empty frame if not needed)
  5..n operand ciphertext blobs (symmetric-seeded: half wire size)
Reply: a JSON header frame {num_cts}, then that many ciphertext frames.
:mod:`.pipeline` holds the encrypted inference layer.
"""

from __future__ import annotations

import json

from ..core import serial
from ..runtime.native import Transport
from ..session import Session

__all__ = ["send_request", "recv_request", "send_reply", "recv_reply"]


def send_request(t: Transport, workload: str, params, rk=None, gk=None,
                 cts=(), seeds=None, meta=None) -> None:
    header = {"workload": workload, "num_cts": len(cts), **(meta or {})}
    t.send(json.dumps(header).encode())
    t.send(serial.dump_params(params))
    t.send(serial.dump_relin_keys(rk) if rk is not None else b"")
    t.send(serial.dump_galois_keys(gk) if gk is not None else b"")
    for i, ct in enumerate(cts):
        seed = seeds[i] if seeds else None
        t.send(serial.dump_ciphertext(ct, seed=seed))


def recv_request(t: Transport, device="cuda"):
    """One request → (header, blind session on ``device``, operands)."""
    header = json.loads(t.recv().decode())
    params = serial.load_params(t.recv())
    rk_blob = t.recv()
    gk_blob = t.recv()
    sess = Session.from_wire(params, device=device)
    if rk_blob:
        sess.rk = serial.load_relin_keys(rk_blob, sess.ctx)
    if gk_blob:
        sess.gk = serial.load_galois_keys(gk_blob, sess.ctx)
    cts = [serial.load_ciphertext(t.recv(), sess.ctx)
           for _ in range(header["num_cts"])]
    return header, sess, cts


def send_reply(t: Transport, cts) -> None:
    t.send(json.dumps({"num_cts": len(cts)}).encode())
    for ct in cts:
        t.send(serial.dump_ciphertext(ct))


def recv_reply(t: Transport, ctx):
    header = json.loads(t.recv().decode())
    return [serial.load_ciphertext(t.recv(), ctx)
            for _ in range(header["num_cts"])]
