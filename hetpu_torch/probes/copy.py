"""Probes ``grid`` and ``overhead``: what one block and one launch cost.

Port of ``scripts/probe_grid.py`` (Pallas copy kernels ``make`` :30 and
``make_flat`` :48) and ``scripts/probe_overhead.py`` (``copy_call`` :21),
through kernel P1 ``copy_planes`` (``csrc/probes.cu``): a u32 plane copy
whose unit of work a block is a parameter, ``rows_per_block`` planes of one
limb (the TPU's block (rb, 1, 128, 128)) or of all limbs (``all_limbs``,
the TPU's (rb, L, 128, 128)).  On the card each block is one CTA whose
planes move through a ring of 32 KB shared-memory stages by 1-D bulk
copies (TMA): one thread loads into stages (completion on one mbarrier a
stage), another stores out of them in bulk groups and frees a stage once
its store has been read, half the ring in flight each way.  The ring holds
up to 192 KB, shared by the blocks an SM holds; one block reaches ~47
GB/s each way, the rate of one SM's bulk copies.
The TPU probe's grid orders and
its parallel/arbitrary dimension semantics have no counterpart: blocks on
the card run in parallel, in no order.  Bound: bytes, 18.87 MB each way at
[32, 9, 128, 128].

A CUDA tensor launches the kernel; a CPU tensor takes
:func:`copy_planes_plain`.  ``tests/test_torch_probe_tiles.py`` rebuilds
the kernel's bulk copies on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cuda_lib
from ..core.modular import from_u32
from . import chain, device_of, feedback, header

ROWS, L, N1 = 32, 9, 128


def _check(x: torch.Tensor, rows_per_block: int) -> tuple[int, int, int]:
    """(R, L, E) of x as [R, L, H, W] or [R, H, W] (L = 1)."""
    cuda_lib.check_i32("copy_planes", x)
    if x.dim() not in (3, 4):
        raise ValueError(f"copy_planes: x must be [R, L, H, W] or [R, H, W], "
                         f"got {tuple(x.shape)}")
    R = x.shape[0]
    limbs = x.shape[1] if x.dim() == 4 else 1
    E = x.shape[-2] * x.shape[-1]
    if rows_per_block < 1 or R % rows_per_block or E % 4:
        raise ValueError(f"copy_planes: {R} rows in blocks of "
                         f"{rows_per_block}, {E} elements a plane (a "
                         "multiple of 4)")
    return R, limbs, E


def copy_planes_plain(x: torch.Tensor, rows_per_block: int = 8,
                      all_limbs: bool = False) -> torch.Tensor:
    """The copy (the block shape does not change the result)."""
    _check(x, rows_per_block)
    return x.clone()


def copy_planes(x: torch.Tensor, rows_per_block: int = 8,
                all_limbs: bool = False) -> torch.Tensor:
    """Copy of int32 x [R, L, H, W] (or [R, H, W]); on the card kernel
    ``copy_planes``, one CTA a block of ``rows_per_block`` rows of one limb
    (or of all limbs), its planes moved through the CTA's bulk-copy
    ring."""
    R, limbs, E = _check(x, rows_per_block)
    if not cuda_lib.on_card(x):
        return copy_planes_plain(x, rows_per_block, all_limbs)
    if x.data_ptr() % 16:
        raise ValueError("copy_planes: x must be 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel():
        cuda_lib.launch("copy_planes", "hetpu_copy_planes", x.device,
                        x.data_ptr(), out.data_ptr(), R, limbs, E // 4,
                        rows_per_block, limbs if all_limbs else 1,
                        nbytes=2 * x.nbytes)
    return out


def planes_u32(shape, seed: int = 0, device="cpu") -> torch.Tensor:
    """The scripts' input: uniform u32 below 2^30, from ``seed``."""
    rng = np.random.default_rng(seed)
    return from_u32(rng.integers(0, 1 << 30, shape, dtype=np.uint32), device)


def run_grid(device="cuda", rows: int = ROWS, limbs: int = L, n: int = N1,
             k: int = 20, rbs=(8, 16, 32)) -> list[dict]:
    """probe_grid: the copy at rb rows of one limb a block and rb rows of
    all limbs a block, beside the same chain without a kernel."""
    dev = device_of(device)
    print(header(dev), flush=True)
    x = planes_u32((rows, limbs, n, n), device=dev)
    planes = rows * limbs
    out = [chain("torch add+xor (no kernel)", lambda c: feedback(c + 1), x,
                 k, planes)]
    for rb in rbs:
        out.append(chain(f"copy rb={rb} one limb a block",
                         lambda c, rb=rb: feedback(copy_planes(c, rb)), x, k,
                         planes))
    for rb in rbs:
        out.append(chain(f"copy flat rb={rb} (limbs inside)",
                         lambda c, rb=rb: feedback(copy_planes(c, rb, True)),
                         x, k, planes))
    print("(the TPU probe's grid orders (L,rows)/(rows,L) and parallel/"
          "arbitrary semantics have no counterpart: blocks run in parallel "
          "in no order, so they are the one-limb rows above)", flush=True)
    return out


def run_overhead(device="cuda", rows: int = 288, n: int = N1,
                 k: int = 20) -> list[dict]:
    """probe_overhead: 1, 2 or 4 copies a step, and one copy at 2x and 4x
    the data, beside torch-only steps."""
    dev = device_of(device)
    print(header(dev), flush=True)
    xs = {m: planes_u32((rows * m, n, n), device=dev) for m in (1, 2, 4)}
    c1 = lambda v: copy_planes(v, 8)
    steps = [("torch xor only", lambda v: v ^ 1, 1),
             (f"1 copy ({rows}pl)", c1, 1),
             (f"2 copies ({rows}pl)", lambda v: c1(c1(v)), 1),
             (f"4 copies ({rows}pl)", lambda v: c1(c1(c1(c1(v)))), 1),
             (f"1 copy ({2 * rows}pl)", c1, 2),
             (f"1 copy ({4 * rows}pl)", c1, 4),
             ("torch roundtrip copy", lambda v: (v + 1) - 1, 1)]
    return [chain(name, lambda v, f=f: feedback(f(v)), xs[m], k, rows * m)
            for name, f, m in steps]
