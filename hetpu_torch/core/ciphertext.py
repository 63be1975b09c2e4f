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

import torch


@dataclass(frozen=True)
class Ciphertext:
    data: torch.Tensor                   # int32 [..., parts, level+1, N]
    level: int = 0
    scale: float = 1.0

    @property
    def num_parts(self) -> int:
        return self.data.shape[-3]

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
