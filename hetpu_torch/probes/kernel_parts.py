"""Probe ``kernel_parts``: the per-plane stages of an int8-digit NTT.

Port of ``scripts/probe_kernel_parts.py`` (Pallas kernel ``make`` :57)
through kernel P4 ``plane_parts`` (``csrc/plane_parts.cu``).  For each
[128, 128] u32 plane x of limb l of x [rows, L, 128, 128], q = 2^30 + 1:

* ``copy``    — x;
* ``dot``     — rows 0..127 of w[l] @ xs, xs = the int8 cast of x repeated
  four times along K ([512, 128]), as u32 bit patterns;
* ``dot2``    — rows 0..127 of w[l] @ int8(w[l] @ xs);
* ``extract`` — the XOR of the four balanced digits of
  ``extract_digit_list(x, q, q // 2)``, each sign-extended to 32 bits;
* ``twiddle`` — ``shoup_scalarish(x, tw[l], tws[l], q)``;
* ``recomb``  — Σ_j shoup_scalarish(x + j, tw[l,0,j], tws[l,0,j], q) for
  j < 4, with conditional-subtract modular adds (the scalars are row 0,
  columns 0..3 of limb l's twiddle plane).

The script builds ``tws`` as ``tw.astype(np.uint64) << 32`` on a JAX
array (:19), which without x64 is a uint32 shift by 32, not the Shoup
companion; the port builds ⌊tw·2^32/q⌋ with numpy uint64.

A CUDA tensor launches the kernel; a CPU tensor takes
:func:`plane_parts_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cuda_lib
from ..core.modular import from_u32, to_i32, u32
from ..core.mxu_digits import extract_digit_list, shoup_scalarish, wrap_i8
from . import chain, device_of, feedback, header
from .dot import matmul_i32

VARIANTS = ("copy", "dot", "dot2", "extract", "twiddle", "recomb")
Q = (1 << 30) + 1
ROWS, L, N1 = 32, 9, 128


def make_inputs(rows: int = ROWS, limbs: int = L, n: int = N1, seed: int = 0,
                device="cpu"):
    """The script's x [rows, L, n, n], w [L, 4n, 4n] s8 and tw [L, n, n]
    from ``seed``, with the true Shoup companions tws."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, Q, (rows, limbs, n, n), dtype=np.uint32)
    w = rng.integers(-128, 128, (limbs, 4 * n, 4 * n), dtype=np.int8)
    tw = rng.integers(0, Q, (limbs, n, n), dtype=np.uint32)
    tws = ((tw.astype(np.uint64) << np.uint64(32)) // np.uint64(Q)) \
        .astype(np.uint32)
    return (from_u32(x, device), torch.from_numpy(w).to(device),
            from_u32(tw, device), from_u32(tws, device))


def plane_parts_plain(variant: str, x, w, tw, tws, q: int = Q):
    """The stage ``variant`` of every plane of x [rows, L, n, n] (int32
    bit patterns), w [L, 4n, 4n] int8, tw/tws [L, n, n]."""
    _check(variant, x, w, tw, tws)
    n = x.shape[-2]
    if variant == "copy":
        return x.clone()
    if variant in ("dot", "dot2"):
        g = matmul_i32(w, wrap_i8(x).repeat(1, 1, 4, 1))
        if variant == "dot2":
            g = matmul_i32(w, wrap_i8(g))
        return g[..., :n, :].contiguous()
    if variant == "extract":
        ds = extract_digit_list(x, q, q // 2)
        out = ds[0].to(torch.int32)
        for d in ds[1:]:
            out = out ^ d.to(torch.int32)
        return out
    if variant == "twiddle":
        return shoup_scalarish(x, tw, tws, q)
    acc = None                                   # recomb
    for j in range(4):
        xj = to_i32((u32(x) + j) & 0xFFFFFFFF)
        t = u32(shoup_scalarish(xj, tw[None, :, :1, j: j + 1],
                                tws[None, :, :1, j: j + 1], q))
        if acc is None:
            acc = t
        else:
            s = (acc + t) & 0xFFFFFFFF
            acc = torch.where(s >= q, s - q, s)
    return to_i32(acc)


def _check(variant, x, w, tw, tws) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"plane_parts: variant {variant!r} is not one of "
                         f"{VARIANTS}")
    cuda_lib.check_i32("plane_parts", x, tw, tws)
    if w.dtype != torch.int8 or not w.is_contiguous():
        raise TypeError("plane_parts: w must be contiguous int8")
    if x.dim() != 4 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"plane_parts: x must be [rows, L, n, n], got "
                         f"{tuple(x.shape)}")
    limbs, n = x.shape[1], x.shape[-1]
    if tuple(w.shape) != (limbs, 4 * n, 4 * n) \
            or tuple(tw.shape) != (limbs, n, n) or tws.shape != tw.shape:
        raise ValueError(f"plane_parts: w {tuple(w.shape)}, tw "
                         f"{tuple(tw.shape)} do not match x {tuple(x.shape)}")


def plane_parts(variant: str, x, w, tw, tws, q: int = Q):
    """:func:`plane_parts_plain`; kernel ``plane_parts`` on CUDA tensors
    (n = 128 only)."""
    _check(variant, x, w, tw, tws)
    if not cuda_lib.on_card(x, w, tw, tws):
        return plane_parts_plain(variant, x, w, tw, tws, q)
    if x.shape[-1] != N1:
        raise ValueError(f"plane_parts: the kernel takes {N1}x{N1} planes")
    if any(t.data_ptr() % 16 for t in (x, w, tw, tws)):
        raise ValueError("plane_parts: tensors must be 16-byte aligned")
    out = torch.empty_like(x)
    planes = x.shape[0] * x.shape[1]
    if planes:
        cuda_lib.launch("plane_parts", "hetpu_plane_parts", x.device,
                        x.data_ptr(), w.data_ptr(), tw.data_ptr(),
                        tws.data_ptr(), out.data_ptr(), planes, x.shape[1],
                        q, VARIANTS.index(variant), nbytes=2 * x.nbytes)
    return out


def run(device="cuda", rows: int = ROWS, limbs: int = L, n: int = N1,
        k: int = 20) -> list[dict]:
    """Each variant's chain, eager and replayed.  (The TPU script chained
    200 steps to hide its relay's dispatch; 20 do here, and the graph of
    the chain holds their outputs.)"""
    dev = device_of(device)
    print(header(dev), flush=True)
    x, w, tw, tws = make_inputs(rows, limbs, n, device=dev)
    return [chain(v, lambda c, v=v: feedback(plane_parts(v, c, w, tw, tws)),
                  x, k, rows * limbs) for v in VARIANTS]
