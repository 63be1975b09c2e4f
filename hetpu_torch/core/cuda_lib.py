"""Build, load and launch the package's hand-written CUDA kernels.

The sources in ``hetpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` (Hopper) into ONE shared library with a plain C interface and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.
The build happens at first use, never at import, into
``build/hetpu_torch/`` at the repository root; the library's file name
carries a hash of the sources and flags, so an edited source rebuilds.

Each kernel wrapper (``ntt.py``, ``fused_ntt.py``, ``ip_kernel.py``)
checks its tensors, allocates outputs with ``torch.empty``, launches on
``torch.cuda.current_stream()``, raises on a non-zero
``cudaGetLastError()`` and adds one to its entry in :data:`launches`.
"""

from __future__ import annotations

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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

# kernel name → launches made by its wrapper (one per kernel launch)
launches = {"ntt": 0, "ntt_fwd_lifted": 0, "ntt_fwd_fbc": 0,
             "inner_product": 0}

_lock = threading.Lock()
_lib = None

_P, _I = ctypes.c_void_p, ctypes.c_int
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
    # ext, k, ks, q, out, B, J, R, n, stream
    "hetpu_inner_product": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
    """Compile csrc/*.cu into the shared library unless it exists.
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
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


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call C entry ``fn_name`` on ``device``'s current stream, raise on a
    launch error, and count the launch under ``kernel``."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(handle, fn_name)(*args, stream)
    if err != 0:
        msg = handle.hetpu_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
    launches[kernel] += 1
