"""Probe ``overhead2``: 1, 2 or 8 launches of an elementwise kernel a step.

Port of ``scripts/probe_overhead2.py`` (Pallas kernel ``pcall`` :45)
through kernel P2 ``muladd_u32`` (``csrc/probes.cu``): x·2654435761 + 1
mod 2^32 on u32 values held as int32 bit patterns.  Bound: bytes, 18.87 MB
each way at [32, 9, 128, 128]; no single PyTorch call computes it.

A CUDA tensor launches the kernel; a CPU tensor takes
:func:`muladd_u32_plain`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import cuda_lib
from ..core.modular import from_u32, to_i32, u32
from . import chain, device_of, feedback, header

MUL = 2654435761
Q = (1 << 30) + 1


def muladd_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """x·MUL + 1 mod 2^32 in int64: MUL = 2^16·hi + lo, so no product
    exceeds 2^48."""
    v = u32(x)
    lo = v * (MUL & 0xFFFF)
    hi = ((v * (MUL >> 16)) & 0xFFFF) << 16
    return to_i32((lo + hi + 1) & 0xFFFFFFFF)


def muladd_u32(x: torch.Tensor) -> torch.Tensor:
    """x·MUL + 1 mod 2^32 of int32 bit patterns; kernel ``muladd_u32`` on
    a CUDA tensor."""
    cuda_lib.check_i32("muladd_u32", x)
    if not cuda_lib.on_card(x):
        return muladd_u32_plain(x)
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("muladd_u32: the element count must be a multiple "
                         "of 4 and x 16-byte aligned")
    out = torch.empty_like(x)
    if x.numel():
        cuda_lib.launch("muladd_u32", "hetpu_muladd_u32", x.device,
                        x.data_ptr(), out.data_ptr(), x.numel() // 4,
                        nbytes=2 * x.nbytes)
    return out


def run(device="cuda", rows: int = 32, limbs: int = 9, n: int = 128,
        k: int = 20) -> list[dict]:
    """The chain with a torch add, 8 plain muladds, or 1, 2, 8 kernel
    launches a step."""
    dev = device_of(device)
    print(header(dev), flush=True)
    rng = np.random.default_rng(0)
    x = from_u32(rng.integers(0, Q, (rows, limbs, n, n), dtype=np.uint32),
                 dev)
    planes = rows * limbs

    def repeat(f, m):
        def step(c):
            for _ in range(m):
                c = f(c)
            return feedback(c)
        return step

    out = [chain(f"torch 1 add (ROWS={rows})", lambda c: feedback(c + 1), x,
                 k, planes),
           chain(f"torch 8 chained muladds, plain (ROWS={rows})",
                 repeat(muladd_u32_plain, 8), x, k, planes)]
    for m in (1, 2, 8):
        out.append(chain(f"{m} kernel launches/iter (ROWS={rows})",
                         repeat(muladd_u32, m), x, k, planes))
    return out
