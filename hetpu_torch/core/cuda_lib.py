"""Build, load and launch the package's hand-written CUDA kernels.

The sources in ``hetpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` (Hopper), one ``nvcc`` per source, all started together, and
linked into ONE shared library with a plain C interface, loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds.  The build
happens at first use, never at import, into ``build/hetpu_torch/`` at the
repository root; the library's file name carries a hash of the sources
and flags, so an edited source rebuilds.

:data:`KERNELS` is the one list of the package's kernels, with their C
entry points and ``__global__`` device functions; :data:`launches`, the
library's signatures and :func:`package_kernel` derive from it, so a new
kernel is its source in ``csrc/``, its wrapper module and one entry
there.  Each wrapper checks its tensors, allocates outputs with
``torch.empty`` (``parallel/peer.py`` stores into exchange buffers the
library allocates), launches on
``torch.cuda.current_stream()``, raises on a non-zero
``cudaGetLastError()`` and adds one to its entry in :data:`launches`.  A
call made inside :func:`recording` (a CUDA graph capture) does not launch:
it records the kernel into the graph and counts there instead; each
replay of that graph launches the recorded kernels and counts them in
:data:`launches` (:func:`count_replay`).

:data:`launch_bytes`, with the same keys, adds each launch's device-memory
bytes, which the wrapper reckons from the shapes it checks
(:func:`plane_bytes`): every operand limb (plane of N words) that the
kernel's index maps address is read once and every output limb written
once, as int32 words, wherever the kernel reads it more often; key values
and their Shoup companions count where the kernel reads both; twiddle
tables and per-prime constants do not count.  Bytes are added only while
a torch profiler records (``utils.profiling.profiler_on``), so the
traced slice's launches carry them and an untraced launch pays one check;
a capture records its launches' bytes, and a replay adds them under the
same check.  :func:`reset_launches` clears both, and every counter
registered with :func:`register_counter`: ``rns.convert_bytes`` (the
precise conversions' bytes by the same rule on either route),
``galois.gather_bytes``, ``fft.mask_bytes`` and the set-up phases' host
seconds ``utils.profiling.host_s``.  :func:`lib`'s first call, which
builds or loads the library, is the set-up phase ``card``
(``utils.profiling.phase``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..utils.profiling import host_s, phase, profiler_on

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hetpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--fmad=false", "-Xptxas", "-v")


@dataclass(frozen=True)
class Kernel:
    """A package kernel: its ``name`` (a key of :data:`launches`), its
    ``__global__`` device functions as ``csrc/*.cu`` names them, and its C
    entry points (name → ctypes argument types, the stream last)."""
    name: str
    functions: tuple[str, ...]
    entries: dict[str, tuple]


_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_Q = ctypes.c_ulonglong
# each entry point's argument types follow its prototype in csrc/
KERNELS = (
    Kernel("ntt", ("ntt_kernel",), {
        "hetpu_ntt": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _P)}),
    Kernel("ntt_fwd_lifted", ("lifted_kernel",), {
        "hetpu_ntt_fwd_lifted": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                 _P, _P, _P, _P, _I, _P)}),
    Kernel("ntt_fwd_fbc", ("fbc_kernel",), {
        "hetpu_ntt_fwd_fbc": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _P)}),
    Kernel("ntt_fwd_centered", ("centered_kernel",), {
        "hetpu_ntt_fwd_centered": (_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _I,
                                   _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _P)}),
    Kernel("inner_product", ("ip_kernel",), {
        "hetpu_inner_product": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P)}),
    Kernel("centered_fbc", ("centered_fbc_kernel",), {
        "hetpu_centered_fbc": (_P, _P, _I, _I, _I, _I, _P, _I, _I, _P)}),
    Kernel("tensor_product", ("tensor_product_kernel",), {
        "hetpu_tensor_product": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P)}),
    Kernel("ks_tail", ("ks_tail_kernel",), {
        "hetpu_ks_tail_src": (_P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I, _I,
                              _I, _P, _P, _P, _P),
        "hetpu_ks_tail_out": (_P, _I, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                              _P, _P, _P, _P, _P, _P),
        "hetpu_ks_tail_sub_mul": (_P, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P),
        "hetpu_ks_tail_lift_last": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                                    _P),
        "hetpu_ks_tail_own_limbs": (_P, _I, _P, _I, _I, _I, _P, _I, _P, _P, _P,
                                    _P)}),
    Kernel("fbc_precise", ("fbc_precise_kernel",), {
        "hetpu_fbc_precise": (_P, _P, _I, _I, _I, _I, _P, _P)}),
    Kernel("copy_planes", ("copy_planes_kernel",), {
        "hetpu_copy_planes": (_P, _P, _I, _I, _I, _I, _I, _P)}),
    Kernel("muladd_u32", ("muladd_kernel",), {
        "hetpu_muladd_u32": (_P, _P, ctypes.c_longlong, _P)}),
    Kernel("dot_i8", ("dot_i8_kernel",), {
        "hetpu_dot_i8": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P)}),
    Kernel("plane_parts", ("elem_kernel", "plane_dot_kernel"), {
        "hetpu_plane_parts": (_P, _P, _P, _P, _P, _I, _I, _U, _I, _P)}),
    Kernel("peer_permute", ("peer_store", "peer_read"), {
        "hetpu_peer_store": (_P, _I, _I, _Q, _P, _P, _P, _P, _I, _U, _U, _P),
        "hetpu_peer_read": (_P, _I, _I, _Q, _P, _Q, _U, _P, _U, _P)}),
    Kernel("tensor_product_acc", ("tensor_product_acc_kernel",), {
        "hetpu_tensor_product_acc": (_P, _P, ctypes.c_longlong, _P, _P, _P,
                                     _I, _I, _I, _I, _P)}),
    Kernel("plain_mul_sum", ("plain_mul_sum_kernel",), {
        "hetpu_plain_mul_sum": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                ctypes.c_longlong, _P, _P, _I, _I, _I, _I,
                                _P)}),
)
# the C entry points that launch nothing and count nowhere: the error
# text (a char*) and the exchange buffers of parallel/peer.py
HELPERS = {"hetpu_error_string": (_I,), "hetpu_peer_wait_value": (_P, _U, _P),
           "hetpu_peer_alloc": (_Q, _P), "hetpu_peer_free": (_P,),
           "hetpu_peer_progress": (_P, _P), "hetpu_peer_free_host": (_P,),
           "hetpu_peer_abort": (_P, _Q, _U), "hetpu_peer_handle": (_P, _P),
           "hetpu_peer_open": (_P, _P), "hetpu_peer_close": (_P,),
           "hetpu_peer_copy": (_P, _P, _Q, _P)}

# kernel name → launches made by its wrapper (one per kernel launch)
launches = {k.name: 0 for k in KERNELS}
# kernel name → device-memory bytes of its launches made while a profiler
# recorded (the rule in the module docstring)
launch_bytes = dict.fromkeys(launches, 0)
WORD = 4                   # bytes an int32 residue

_lock = threading.Lock()
_lib = None
_recorded = None           # counts of the capture in progress (recording)
_counters = []             # wrapper modules' counters (register_counter)
_KERNEL_OF = {f: k.name for k in KERNELS for f in k.functions}
_FUNCTION = re.compile(r"(\w+)(?=[<(])")   # a demangled name's function


def package_kernel(name: str) -> str | None:
    """The package kernel whose device function a profiler's kernel name
    calls (``void (anonymous namespace)::fbc_kernel<8>(…)`` →
    ``"ntt_fwd_fbc"``), by the function's whole identifier; None for any
    other kernel (PyTorch's own)."""
    m = _FUNCTION.search(name)
    return _KERNEL_OF.get(m.group(1)) if m else None


def register_counter(counter: dict) -> dict:
    """Have :func:`reset_launches` clear ``counter``, a wrapper module's
    own count (``rns.convert_bytes``); returns it."""
    _counters.append(counter)
    return counter


register_counter(host_s)   # the set-up phases' seconds (utils.profiling)


def reset_launches() -> None:
    """Zero :data:`launches`, :data:`launch_bytes` and each counter of
    :func:`register_counter`."""
    for counter in (launches, launch_bytes, *_counters):
        for k in counter:
            counter[k] = 0


def plane_bytes(n: int, *planes: int) -> int:
    """Bytes of ``sum(planes)`` int32 planes of ``n`` words each: a
    launch's reckoning, its operand planes read and output planes
    written."""
    return WORD * n * sum(planes)


class Recorded(dict):
    """The launches a capture recorded (name → calls), with their bytes
    (:attr:`nbytes`, name → bytes)."""

    def __init__(self):
        super().__init__(dict.fromkeys(launches, 0))
        self.nbytes = dict.fromkeys(launches, 0)


@contextlib.contextmanager
def recording():
    """Wrap a CUDA graph capture: the wrapper calls inside record their
    kernels into the graph instead of launching them, so they count in
    the :class:`Recorded` this yields, not in :data:`launches`."""
    global _recorded
    _recorded = Recorded()
    try:
        yield _recorded
    finally:
        _recorded = None


def count_replay(kernels: dict, nbytes: dict | None = None) -> None:
    """Count one replay of a CUDA graph whose capture recorded ``kernels``
    (name → launches) and ``nbytes`` (name → bytes): the replay launches
    each of them."""
    for k, n in kernels.items():
        launches[k] += n
    if nbytes and profiler_on():
        for k, b in nbytes.items():
            launch_bytes[k] += b


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
            with phase("card"):
                handle = ctypes.CDLL(str(build()))
                entries = [e for k in KERNELS for e in k.entries.items()]
                for name, args in entries + list(HELPERS.items()):
                    fn = getattr(handle, name)
                    fn.argtypes = list(args)
                    fn.restype = ctypes.c_int
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


def row_stride(t: torch.Tensor) -> int | None:
    """The planes between consecutive rows of ``t`` [..., L, N] when the
    kernels can read it in place: its last two axes contiguous and its
    leading axes one run of rows a fixed multiple of N words apart, as a
    part ``ct[..., p, :, :]`` of a contiguous ciphertext (3L planes a row)
    is; L for a contiguous ``t``.  None for any other layout."""
    if t.dim() < 2:
        return None
    L, n = t.shape[-2:]
    if t.is_contiguous():
        return L
    if t.stride(-1) != 1 or (L > 1 and t.stride(-2) != n):
        return None
    lead = [(s, st) for s, st in zip(t.shape[:-2], t.stride()[:-2]) if s > 1]
    if not lead or lead[-1][1] % n or lead[-1][1] < L * n:
        return None
    step = lead[-1][1]
    for s, st in reversed(lead):
        if st != step:
            return None
        step = st * s
    return lead[-1][1] // n


def check_rows(name: str, t: torch.Tensor) -> int:
    """``t``'s :func:`row_stride` for an int32 ``t``; raises as
    :func:`check_i32` where there is none."""
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 tensors, got {t.dtype}")
    stride = row_stride(t)
    if stride is None:
        raise ValueError(f"{name}: tensors must be contiguous, or rows of "
                         f"contiguous planes one stride apart")
    return stride


@dataclass(frozen=True)
class RowMap:
    """Where a kernel stores its output rows: output row f of a launch at
    limb ``rows[f]`` of an output row of ``limbs`` limbs.  ``rows`` (int32
    [F], on the kernel's device) is checked once, on the host, when the map
    is made: its entries are distinct and lie in [0, limbs).  The kernels
    store through it unchecked, so a map reaches them only as a RowMap."""
    rows: torch.Tensor
    limbs: int

    def __post_init__(self):
        r = self.rows.cpu().numpy()
        if self.rows.dtype != torch.int32 or r.ndim != 1 \
                or not self.rows.is_contiguous() \
                or len(np.unique(r)) != r.size \
                or (r.size and (r.min() < 0 or r.max() >= self.limbs)):
            raise ValueError(f"RowMap: {tuple(self.rows.shape)} "
                             f"{self.rows.dtype} rows must be distinct int32 "
                             f"limbs in [0, {self.limbs})")


def check_map(name: str, out: torch.Tensor, out_rows: RowMap,
              lead: tuple, count: int, n: int, device) -> int:
    """The limbs M of ``out`` [*lead, M, N] (int32, contiguous, on
    ``device``), into which ``count`` rows are stored through ``out_rows``
    (a :class:`RowMap` of ``count`` rows into M limbs); raises otherwise."""
    if not isinstance(out_rows, RowMap):
        raise TypeError(f"{name}: out_rows must be a cuda_lib.RowMap, got "
                        f"{type(out_rows).__name__}")
    check_i32(name, out)
    if tuple(out.shape[:-2]) != tuple(lead) or out.shape[-1] != n \
            or out.shape[-2] != out_rows.limbs \
            or out_rows.rows.shape != (count,) \
            or out.device != device or out_rows.rows.device != device:
        raise ValueError(f"{name}: out {tuple(out.shape)} on {out.device} "
                         f"and a map of {tuple(out_rows.rows.shape)} rows "
                         f"into {out_rows.limbs} limbs on "
                         f"{out_rows.rows.device} for {count} rows of "
                         f"{(*lead, n)} on {device}")
    return out_rows.limbs


def check_aligned(name: str, *tensors: torch.Tensor) -> None:
    """The kernels move planes with 16-byte vector loads and stores."""
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def launch(kernel: str, fn_name: str, device: torch.device, *args,
           nbytes: int) -> None:
    """Call C entry ``fn_name`` on ``device``'s current stream, raise on a
    launch error, and count the launch and its ``nbytes`` under ``kernel``
    (inside :func:`recording`, as recorded)."""
    handle = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(handle, fn_name)(*args, stream)
    if err != 0:
        msg = handle.hetpu_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({err})")
    if _recorded is not None:
        _recorded[kernel] += 1
        _recorded.nbytes[kernel] += nbytes
        return
    launches[kernel] += 1
    if profiler_on():
        launch_bytes[kernel] += nbytes
