"""Build, load and launch the package's hand-written CUDA kernels.

The sources in ``hetpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` (Hopper), one ``nvcc`` per source, all started together, and
linked into ONE shared library with a plain C interface, loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  The build
happens at first use, never at import, into ``build/hetpu_torch/`` at the
repository root; the library's file name carries a hash of the sources
and flags, so an edited source rebuilds.

Each kernel wrapper (``ntt.py``, ``fused_ntt.py``, ``ip_kernel.py``,
``centered_fbc.py``, ``parallel/peer.py``, and the probes' ``copy.py``,
``overhead2.py``, ``dot.py`` and ``kernel_parts.py``) checks its tensors,
allocates outputs with ``torch.empty`` (``peer.py`` stores into exchange
buffers the library allocates), launches on
``torch.cuda.current_stream()``, raises on a non-zero
``cudaGetLastError()`` and adds one to its entry in :data:`launches`.  A call made inside :func:`recording` (a CUDA graph
capture) does not launch: it records the kernel into the graph and counts
there instead; each replay of that graph launches the recorded kernels
and counts them in :data:`launches` (:func:`count_replay`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hetpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")

# kernel name → launches made by its wrapper (one per kernel launch)
launches = {"ntt": 0, "ntt_fwd_lifted": 0, "ntt_fwd_fbc": 0,
            "ntt_fwd_centered": 0, "inner_product": 0, "centered_fbc": 0,
            "copy_planes": 0, "muladd_u32": 0, "dot_i8": 0,
            "plane_parts": 0, "peer_permute": 0}

_lock = threading.Lock()
_lib = None
_recorded = None           # counts of the capture in progress (recording)

_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_Q = ctypes.c_ulonglong
_SIGNATURES = {
    # x, out, rows, L, logn, w, ws, q, c1, c2, inverse, stream
    "hetpu_ntt": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P),
    # y, out, rows, Ly, F, A, logn, lw, lws, dig, w, ws, q, c1, stream
    "hetpu_ntt_fwd_lifted": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                             _P, _P, _P, _P),
    # u, out, rows, A, F, logn, phat, phat_shoup, recip, ptot,
    # ptot_shoup, w, ws, q, c1, stream
    "hetpu_ntt_fwd_fbc": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _P),
    # y, out, rows, Ly, F, A, logn, cw, cws, wf, wi, dig, q_src, recip,
    # pm, pms, w, ws, q, c1, stream
    "hetpu_ntt_fwd_centered": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                               _P, _P, _P, _P, _P, _P, _P, _P, _P, _P),
    # ext, k, ks, q, out, B, J, R, n, bt, stream
    "hetpu_inner_product": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # y, out, rows, S, F, n, consts, has_alpha, has_extra, stream
    "hetpu_centered_fbc": (_P, _P, _I, _I, _I, _I, _P, _I, _I, _P),
    # x, out, R, L, e4, rb, lb, stream
    "hetpu_copy_planes": (_P, _P, _I, _I, _I, _I, _I, _P),
    # x, out, n4, stream
    "hetpu_muladd_u32": (_P, _P, ctypes.c_longlong, _P),
    # a, b, out, M, K, batch, ppb, a_unsigned, b_unsigned, stream
    "hetpu_dot_i8": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w, tw, tws, out, planes, L, q, variant, stream
    "hetpu_plane_parts": (_P, _P, _P, _P, _P, _I, _I, _U, _I, _P),
    # bases, n, me, cap, srcs, ranks, offs, bytes (host arrays of nseg),
    # nseg, send_mask, epoch, stream
    "hetpu_peer_store": (_P, _I, _I, _Q, _P, _P, _P, _P, _I, _U, _U, _P),
    # bases, n, me, cap, out, out_bytes, recv_mask, progress, epoch, stream
    "hetpu_peer_read": (_P, _I, _I, _Q, _P, _Q, _U, _P, _U, _P),
    # the exchange buffers of parallel/peer.py (no launch, not counted):
    "hetpu_peer_wait_value": (_P, _U, _P),  # word, value, stream
    "hetpu_peer_alloc": (_Q, _P),          # slot bytes, &ptr
    "hetpu_peer_free": (_P,),
    "hetpu_peer_progress": (_P, _P),       # &host ptr, &device ptr
    "hetpu_peer_free_host": (_P,),
    "hetpu_peer_abort": (_P, _Q, _U),      # own buffer, slot bytes, poison
    "hetpu_peer_handle": (_P, _P),         # ptr, 64-byte handle out
    "hetpu_peer_open": (_P, _P),           # 64-byte handle, &ptr
    "hetpu_peer_close": (_P,),
    "hetpu_peer_copy": (_P, _P, _Q, _P),   # dst, src, bytes, stream
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


@contextlib.contextmanager
def recording():
    """Wrap a CUDA graph capture: the wrapper calls inside record their
    kernels into the graph instead of launching them, so they count in
    the dict this yields (name → calls), not in :data:`launches`."""
    global _recorded
    _recorded = dict.fromkeys(launches, 0)
    try:
        yield _recorded
    finally:
        _recorded = None


def count_replay(kernels: dict) -> None:
    """Count one replay of a CUDA graph whose capture recorded ``kernels``
    (name → launches): the replay launches each of them."""
    for k, n in kernels.items():
        launches[k] += n


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from hetpu_torch/csrc at first use")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libhetpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu into the shared library unless it exists: one
    ``nvcc -c`` per source, run in parallel, then one link.  nvcc's output
    (``-Xptxas -v``: registers, shared memory, spills) is kept beside the
    library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    log, failed = [], []
    for src, proc in zip(_sources(), procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}"
                   f"{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n"
                           + "".join(log))
    os.replace(tmp, so)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = list(args)
                fn.restype = ctypes.c_int
            handle.hetpu_error_string.argtypes = [ctypes.c_int]
            handle.hetpu_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def on_card(*tensors: torch.Tensor) -> bool:
    """True when the tensors lie on a CUDA device (the kernel path), False
    on the CPU (the plain path); raises on a mix or another device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def check_i32(name: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels move planes with 16-byte vector loads and stores."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call C entry ``fn_name`` on ``device``'s current stream, raise on a
    launch error, and count the launch under ``kernel`` (inside
    :func:`recording`, as recorded)."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(handle, fn_name)(*args, stream)
    if err != 0:
        msg = handle.hetpu_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
    (launches if _recorded is None else _recorded)[kernel] += 1
