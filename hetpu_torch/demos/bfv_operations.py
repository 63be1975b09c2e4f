"""BFV demo aliases (counterpart of ``hetpu/demos/bfv_operations.py``):
the reference dispatches its BFV workloads through the
``matrix_operations`` suite (``matrix_operations.cpp:1191-1199``); this
module keeps the old ``bfv_operations`` suite name working and routes to
the same implementations."""

from __future__ import annotations

from .matrix_operations import (
    demo_batch_matmul_bfv,
    demo_elemwise_square,
    demo_matpow,
)

DEMOS = {
    "elemwise_square": demo_elemwise_square,
    "batch_matmul_bfv": demo_batch_matmul_bfv,
    "matpow_bfv": demo_matpow,
}
