"""Probes ``u8_dot``, ``pallas_s8`` and ``int8_mxu``: 8-bit integer
products with int32 sums on the tensor cores.

Port of ``scripts/probe_u8_dot.py`` (``try_pair`` :20: u8×s8, s8×u8,
s8×s8, u8×u8 at [128,256]@[256,128]), ``scripts/probe_pallas_s8.py`` (:14:
s8 [512,512]@[512,128]) and ``scripts/probe_int8_mxu.py`` (``pl_dot`` :59
one plane a step, ``pl_dot8`` :93 eight planes a step; w [512,512] s8
against B = 288 planes [512,128], chained through an int8 cast), through
kernel P3 ``dot_i8`` (``csrc/dot_i8.cu``, ``wgmma`` m64n128k32).

On the card a persistent grid (one CTA an SM) walks tiles of (slab of A,
``planes_per_block`` planes of B): a slab is 256 rows of A (128 where
K > 512 or M < 256), brought in by TMA once and kept for the CTA's tiles
of that slab; a producer warpgroup transposes each plane of B, 128 rows of
K at a time, into the K-major swizzled layout ``wgmma`` reads; two consumer
warpgroups run the products and write each m64×n128 int32 tile through a
swizzled shared-memory staging tile with TMA stores.  ``tests/test_torch_probe_tiles.py``
rebuilds that decomposition on the host.

The Pallas kernels of ``probe_int8_mxu.py`` contract ``a[b]`` [512,128]
on its axis 1 with ``w`` on its axis 0 (:54-56, :88-90); those shapes do
not match, so as written they fail to trace (the script's own comment at
:71-72 calls the shape "moot").  The port computes the product that the
script's XLA chain times (:37-41): out[b] = w @ a[b].

Casts wrap as the reference's ``astype`` does: int32 → int8 keeps the low
8 bits (:func:`..core.mxu_digits.wrap_i8`, explicit masks).

A CUDA tensor launches the kernel; a CPU tensor takes
:func:`dot_i8_plain`.  Bound at the int8_mxu shape: bytes (18.9 MB in,
75.5 MB out); its 9.66 G multiply-adds take 9.8 µs at the int8 dense
peak.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cuda_lib
from ..core.mxu_digits import wrap_i8
from . import chain, device_of, header

_INT8 = (torch.int8, torch.uint8)
ROWS_PER_BLOCK = 64             # M must be a multiple of one wgmma's rows
N_COLS = 128                    # the kernel's plane width


def _check(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """(M, K, batch) of A [M, K] and B [batch, K, N]."""
    if a.dtype not in _INT8 or b.dtype not in _INT8:
        raise TypeError(f"dot_i8: expected int8/uint8, got {a.dtype}, "
                        f"{b.dtype}")
    if a.dim() != 2 or b.dim() != 3 or a.shape[1] != b.shape[1]:
        raise ValueError(f"dot_i8: A [M, K] and B [batch, K, N], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("dot_i8: tensors must be contiguous")
    return a.shape[0], a.shape[1], b.shape[0]


def matmul_i32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.matmul`` of 8-bit integer tensors as int32, through float64:
    every product and partial sum is an integer below 2^53 (|Σ| ≤ K·255²
    for K ≤ 2^37), so the result is exact; torch has no integer matmul on
    CUDA."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)) \
        .to(torch.int32)


def dot_i8_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """out[p] = a @ b[p] as int32 (:func:`matmul_i32`)."""
    _check(a, b)
    return matmul_i32(a, b)


def dot_i8(a: torch.Tensor, b: torch.Tensor,
           planes_per_block: int = 1) -> torch.Tensor:
    """out [batch, M, N] int32 = a [M, K] @ b[p] [K, N] for u8/s8 a and b
    (signedness from the dtypes); kernel ``dot_i8`` on CUDA tensors, whose
    tiles are ``planes_per_block`` planes of b against one slab of a (256
    rows, or 128 where K > 512 or M < 256).  The kernel needs
    M % 64 == 0, K % 32 == 0, K ≤ 1024, N = 128."""
    M, K, batch = _check(a, b)
    if not cuda_lib.on_card(a, b):
        return dot_i8_plain(a, b)
    N = b.shape[2]
    if M % ROWS_PER_BLOCK or K % 32 or K > 1024 or N != N_COLS \
            or planes_per_block < 1:
        raise ValueError(f"dot_i8: the kernel takes M % 64 == 0, K % 32 == "
                         f"0, K <= 1024, N == 128; got M={M}, K={K}, N={N}")
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("dot_i8: tensors must be 16-byte aligned")
    out = torch.empty((batch, M, N), dtype=torch.int32, device=a.device)
    if batch:
        cuda_lib.launch("dot_i8", "hetpu_dot_i8", a.device, a.data_ptr(),
                        b.data_ptr(), out.data_ptr(), M, K, batch,
                        planes_per_block, int(a.dtype == torch.uint8),
                        int(b.dtype == torch.uint8),
                        nbytes=a.nbytes + b.nbytes + out.nbytes)
    return out


def pair_inputs(la: np.dtype, ra: np.dtype, seed: int = 0):
    """probe_u8_dot's operands: a from [0, 200) as ``la``, b from
    [-100, 100) as ``ra`` (numpy's astype wraps, as jnp's does)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 200, (128, 256)).astype(la)
    b = rng.integers(-100, 100, (256, 128)).astype(ra)
    return a, b


PAIRS = (("u8 x s8", np.uint8, np.int8), ("s8 x u8", np.int8, np.uint8),
         ("s8 x s8", np.int8, np.int8), ("u8 x u8", np.uint8, np.uint8))


def run_u8_dot(device="cuda") -> list[dict]:
    """Each signedness pair against numpy int64: exact or not."""
    dev = device_of(device)
    print(header(dev), flush=True)
    out = []
    for name, la, ra in PAIRS:
        a, b = pair_inputs(la, ra)
        got = dot_i8(torch.from_numpy(a).to(dev),
                     torch.from_numpy(b).to(dev)[None])[0].cpu().numpy()
        ok = np.array_equal(got.astype(np.int64),
                            a.astype(np.int64) @ b.astype(np.int64))
        print(f"{name}: kernel exact={ok}", flush=True)
        out.append({"name": name, "exact": ok})
    return out


def run_pallas_s8(device="cuda") -> dict:
    """s8 [512,512] @ [512,128] against numpy int64."""
    dev = device_of(device)
    print(header(dev), flush=True)
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (512, 512), dtype=np.int8)
    x = rng.integers(-128, 128, (512, 128), dtype=np.int8)
    got = dot_i8(torch.from_numpy(w).to(dev),
                 torch.from_numpy(x).to(dev)[None])[0].cpu().numpy()
    ok = np.array_equal(got.astype(np.int64),
                        w.astype(np.int64) @ x.astype(np.int64))
    print(f"s8 dot exact: {ok}", flush=True)
    return {"name": "s8 [512,512]@[512,128]", "exact": ok}


def int8_mxu_inputs(batch: int = 288, seed: int = 0, device="cpu"):
    """probe_int8_mxu's a [batch, 512, 128] and w [512, 512], s8."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-128, 128, (batch, 512, 128), dtype=np.int8)
    w = rng.integers(-128, 128, (512, 512), dtype=np.int8)
    return (torch.from_numpy(w).to(device), torch.from_numpy(a).to(device))


def run_int8_mxu(device="cuda", batch: int = 288, k: int = 40) -> list[dict]:
    """The chain x ← int8(w @ x) over ``batch`` planes: the plain version,
    the kernel at one plane a block (pl_dot) and eight (pl_dot8); eager
    times (a graph of this chain would hold k int32 outputs of 75 MB)."""
    dev = device_of(device)
    print(header(dev), flush=True)
    w, a = int8_mxu_inputs(batch, device=dev)
    macs = batch * 512 * 512 * 128
    out = []
    for name, f in (("plain float64 w@a", dot_i8_plain),
                    ("kernel, 1 plane a block", lambda w_, x: dot_i8(w_, x)),
                    ("kernel, 8 planes a block",
                     lambda w_, x: dot_i8(w_, x, 8))):
        r = chain(f"s8 [512,512]@[{batch},512,128] {name}",
                  lambda x, f=f: wrap_i8(f(w, x)), a, k, batch, graph=False)
        r["tmac_per_s"] = macs / (r["eager_ms"] * 1e-3) / 1e12
        print(f"{'':36s} {r['tmac_per_s']:7.1f} TMAC/s (cast included)",
              flush=True)
        out.append(r)
    return out
