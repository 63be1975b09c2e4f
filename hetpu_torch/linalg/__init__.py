"""Encrypted linear algebra (reference ``he::linalg``, he_linalg.h).

Counterpart of ``hetpu/linalg``."""

from .batched import BatchedMatrix, BatchedVector
from .matrix import Matrix

__all__ = ["BatchedMatrix", "BatchedVector", "Matrix"]
