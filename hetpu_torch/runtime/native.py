"""ctypes bindings to the C++ transport runtime (native/hetpu_io.cpp).

Counterpart of ``hetpu/runtime/native.py``, copied because importing
``hetpu.runtime`` runs ``hetpu/__init__.py``, which imports JAX.  The
transport concerns no device.  The shared library is built on first use
(g++) into ``build/hetpu_torch/``, named by a hash of the source, so the
port never writes under ``native/``; without a compiler, a pure-Python
socket implementation keeps the API identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import socket as pysocket
import struct
import subprocess

from ..core.cuda_lib import BUILD_DIR

_SRC = pathlib.Path(__file__).resolve().parents[2] / "native" / "hetpu_io.cpp"

_lib = None


def _build() -> pathlib.Path:
    """Compile native/hetpu_io.cpp into build/hetpu_torch/ unless the
    library for this source exists (named by the source's hash; written to
    a temporary name, then renamed, so a concurrent process never loads a
    partial file)."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libhetpu_io_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.part")
        try:
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                            str(_SRC)], check=True, capture_output=True)
            os.replace(tmp, so)
        finally:
            tmp.unlink(missing_ok=True)
    return so


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(_build()))
        lib.hetpu_read_all.restype = ctypes.c_int64
        lib.hetpu_read_all.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int64]
        lib.hetpu_write_all.restype = ctypes.c_int64
        lib.hetpu_write_all.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                        ctypes.c_int64]
        lib.hetpu_send_frame.restype = ctypes.c_int64
        lib.hetpu_send_frame.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_int64]
        lib.hetpu_recv_frame_size.restype = ctypes.c_int64
        lib.hetpu_recv_frame_size.argtypes = [ctypes.c_int]
        lib.hetpu_listen.restype = ctypes.c_int
        lib.hetpu_listen.argtypes = [ctypes.c_int, ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.hetpu_accept.restype = ctypes.c_int
        lib.hetpu_accept.argtypes = [ctypes.c_int]
        lib.hetpu_connect.restype = ctypes.c_int
        lib.hetpu_connect.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.hetpu_close.argtypes = [ctypes.c_int]
        _lib = lib
    except (subprocess.CalledProcessError, OSError):
        _lib = False
    return _lib


PORT_LO, PORT_HI = 8080, 8100     # reference port-scan range


class Transport:
    """A connected, framed byte channel.  Native C++ when available."""

    def __init__(self, fd: int | None = None, sock: pysocket.socket | None = None):
        self.fd = fd
        self.sock = sock          # python fallback / in-process pair

    @property
    def kind(self) -> str:
        """Which runtime carries the frames: "native" (the C++ library)
        or "python" (the socket fallback, and every in-process pair)."""
        return "native" if self.fd is not None and _load() else "python"

    # -- framing -------------------------------------------------------
    def send(self, payload: bytes) -> None:
        lib = _load()
        if self.fd is not None and lib:
            buf = ctypes.create_string_buffer(payload, len(payload))
            if lib.hetpu_send_frame(self.fd, buf, len(payload)) != len(payload):
                raise IOError("send_frame failed")
        else:
            self.sock.sendall(struct.pack("<Q", len(payload)) + payload)

    def recv(self) -> bytes:
        lib = _load()
        if self.fd is not None and lib:
            size = lib.hetpu_recv_frame_size(self.fd)
            if size < 0:
                raise IOError("recv_frame_size failed")
            buf = ctypes.create_string_buffer(size)
            if lib.hetpu_read_all(self.fd, buf, size) != size:
                raise IOError("short read")
            return buf.raw
        hdr = self._read_exact(8)
        (size,) = struct.unpack("<Q", hdr)
        return self._read_exact(size)

    def _read_exact(self, size: int) -> bytes:
        out = b""
        while len(out) < size:
            chunk = self.sock.recv(size - len(out))
            if not chunk:
                raise IOError("EOF")
            out += chunk
        return out

    def close(self):
        lib = _load()
        if self.fd is not None and lib:
            lib.hetpu_close(self.fd)
        elif self.sock is not None:
            self.sock.close()


def serve(port_lo=PORT_LO, port_hi=PORT_HI, on_listen=None):
    """Bind/listen/accept one connection (reference setup_server).
    ``on_listen(port)`` is called once the socket listens, before the
    accept.  Returns (transport, port)."""
    lib = _load()
    if lib:
        port = ctypes.c_int(0)
        lfd = lib.hetpu_listen(port_lo, port_hi, ctypes.byref(port))
        if lfd < 0:
            raise IOError("no free port in range")
        try:
            if on_listen is not None:
                on_listen(port.value)
            cfd = lib.hetpu_accept(lfd)
        finally:
            lib.hetpu_close(lfd)
        if cfd < 0:
            raise IOError("accept failed")
        return Transport(fd=cfd), port.value
    # python fallback
    for port in range(port_lo, port_hi + 1):
        try:
            srv = pysocket.create_server(("127.0.0.1", port))
            break
        except OSError:
            continue
    else:
        raise IOError("no free port in range")
    with srv:
        if on_listen is not None:
            on_listen(port)
        conn, _ = srv.accept()
    return Transport(sock=conn), port


def connect(port_lo=PORT_LO, port_hi=PORT_HI, *, retries: int = 0,
            backoff: float = 0.2) -> Transport:
    """Connect with a port scan (reference setup_client).

    ``retries`` > 0 adds failure recovery the reference lacks (SURVEY.md
    §5: socket errors there are perror+exit): the scan is retried with
    exponential backoff, so a client may start before its server."""
    import time

    attempt = 0
    while True:
        try:
            return _connect_once(port_lo, port_hi)
        except IOError:
            if attempt >= retries:
                raise
            time.sleep(backoff * (2 ** attempt))
            attempt += 1


def _connect_once(port_lo: int, port_hi: int) -> Transport:
    lib = _load()
    if lib:
        fd = lib.hetpu_connect(port_lo, port_hi)
        if fd < 0:
            raise IOError("connect scan failed")
        return Transport(fd=fd)
    for port in range(port_lo, port_hi + 1):
        try:
            return Transport(sock=pysocket.create_connection(("127.0.0.1", port)))
        except OSError:
            continue
    raise IOError("connect scan failed")


def pipe_pair():
    """In-process transport pair (the reference's stringstream 'rookie'
    harness, client_server_rookie.cpp:11-181)."""
    a, b = pysocket.socketpair()
    return Transport(sock=a), Transport(sock=b)
