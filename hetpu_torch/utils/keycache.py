"""On-disk session/key cache.

Counterpart of ``hetpu/utils/keycache.py``, with the same file format, the
same ``HETPU_KEY_CACHE`` variable and the same tag, so a cache file that
either package writes loads in the other.  Keygen for deep chains costs
minutes on the host; benchmarks and demos that re-create identical
deterministic sessions (same preset and seed) reload the keys instead,
through the wire format (:mod:`..core.serial`).

The directory defaults to ``hetpu_keycache`` under the system's temporary
directory (``TMPDIR``, else ``/tmp``, where the reference keeps it).

SECURITY: the cache stores the RAW SECRET KEY on disk (0o700 directory,
0o600 files, but still plaintext).  It is for benchmarks, demos and tests
with throwaway deterministic keys; a real deployment checkpoints only
public material (pk/rk/gk through ``core.serial``)."""

from __future__ import annotations

import hashlib
import os
import pathlib
import tempfile

import numpy as np

from ..core import serial
from ..core.context import Context
from ..core.encoding import CkksEncoder
from ..core.encrypt import Decryptor, Encryptor
from ..core.evaluator import Evaluator
from ..core.keys import SecretKey
from ..core.modular import from_u32, to_u32
from ..core.params import HeParams, preset as get_preset
from ..session import Session

CACHE_DIR = pathlib.Path(os.environ.get(
    "HETPU_KEY_CACHE", pathlib.Path(tempfile.gettempdir()) / "hetpu_keycache"))


def cached_session(params: HeParams | str, *, seed: bytes,
                   galois_steps=None, device="cuda") -> Session:
    """Session.create with a disk cache keyed on (params, seed, steps);
    the keys land on ``device``."""
    if isinstance(params, str):
        params = get_preset(params)
    tag = hashlib.sha256(
        repr((params, seed, tuple(galois_steps or ()))).encode()).hexdigest()[:16]
    path = CACHE_DIR / f"sess_{tag}.npz"
    ctx = Context(params, device)
    if path.exists():
        try:
            z = np.load(path, allow_pickle=False)
            sk = SecretKey(data=from_u32(z["sk"], ctx.device), seed=seed)
            pk = serial.load_public_key(z["pk"].tobytes(), ctx.device)
            rk = serial.load_relin_keys(z["rk"].tobytes(), ctx)
            gk = serial.load_galois_keys(z["gk"].tobytes(), ctx)
            return Session(
                ctx=ctx, encoder=CkksEncoder(ctx), ev=Evaluator(ctx),
                rk=rk, gk=gk,
                encryptor=Encryptor(ctx, public_key=pk, secret_key=sk),
                decryptor=Decryptor(ctx, sk),
            )
        except ValueError:
            path.unlink()      # stale wire version — regenerate below
    sess = Session.create(params, seed=seed, galois_steps=galois_steps,
                          device=device)
    CACHE_DIR.mkdir(parents=True, exist_ok=True, mode=0o700)
    os.chmod(CACHE_DIR, 0o700)        # pre-existing dir: tighten it too
    # open with 0o600 BEFORE any bytes are written: np.savez(path) under
    # the default umask would leave a window where the plaintext sk is
    # world-readable
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as fh:
        np.savez(
            fh,
            sk=to_u32(sess.decryptor.sk.data),
            pk=np.frombuffer(serial.dump_public_key(
                sess.encryptor.pk), dtype=np.uint8),
            rk=np.frombuffer(serial.dump_relin_keys(sess.rk), dtype=np.uint8),
            gk=np.frombuffer(serial.dump_galois_keys(sess.gk), dtype=np.uint8),
        )
    return sess
