"""Ciphertext / Plaintext: dataclasses of tensors.

Counterpart of ``hetpu/core/ciphertext.py``.  A ciphertext is one
limb-planar int32 tensor ``[parts, L, N]`` (batched: ``[..., parts, L,
N]``, e.g. ``[B, 2, L, N]``) in NTT evaluation order, Montgomery form;
``level`` and ``scale`` ride along as plain Python values.

Plaintexts are NTT-domain, standard form with Shoup companions, so a
ct·pt multiply is one Shoup multiply.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from .modular import to_u32


@dataclass(frozen=True)
class Ciphertext:
    data: torch.Tensor                   # int32 [..., parts, level+1, N]
    level: int = 0
    scale: float = 1.0

    @property
    def num_parts(self) -> int:
        return self.data.shape[-3]

    @property
    def poly_degree(self) -> int:
        return self.data.shape[-1]

    @property
    def batch_shape(self) -> tuple[int, ...]:
        return tuple(self.data.shape[:-3])

    def with_(self, **kw) -> "Ciphertext":
        return replace(self, **kw)

    def to(self, device) -> "Ciphertext":
        return replace(self, data=self.data.to(device))


@dataclass(frozen=True)
class Plaintext:
    data: torch.Tensor                   # int32 [..., level+1, N] (standard, NTT)
    shoup: torch.Tensor                  # same shape: floor(data·2^32/q)
    level: int = 0
    scale: float = 1.0

    @property
    def poly_degree(self) -> int:
        return self.data.shape[-1]


def scales_close(a: float, b: float, rel: float = 1e-6) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b))


def check_add_compat(a, b, op: str = "add") -> None:
    if a.level != b.level:
        raise ValueError(f"{op}: level mismatch {a.level} vs {b.level} "
                         "(Session.reach_level aligns them)")
    if not scales_close(a.scale, b.scale):
        raise ValueError(f"{op}: scale mismatch {a.scale} vs {b.scale}")


def np_data(ct) -> np.ndarray:
    """The residues of ``ct`` (a ciphertext or plaintext) as a host numpy
    uint32 array: hetpu's ``np.asarray(ct.data)``."""
    return to_u32(ct.data)
