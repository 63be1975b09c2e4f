"""Key-switch inner product: acc_c = Σ_j digit_j ⊙ ksk_{j,c} over the key
basis (c = 0, 1) — the hot loop of every key switch.

Counterpart of ``hetpu/core/ip_kernel.py`` (``inner_product``, the jnp
twin ``inner_product_jnp`` and the Pallas kernel ``_call``).  On the TPU
the compiler fuses the elementwise twin; eager PyTorch would make every
multiply and add its own pass over device memory, so a CUDA tensor
launches the ``inner_product`` kernel (``csrc/ip_kernel.cu``) and a CPU
tensor takes :func:`inner_product_plain`.  The kernel's thread owns four
consecutive x of one limb for a tile of batch rows; :func:`ip_tiles`
chooses the tile.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .modular import add_i64, u32


def inner_product_plain(ext, k, ks, q):
    """ext int32 [..., J, R, N] standard NTT × Shoup-form keys k/ks
    [J, 2, R, N] (q [R, 1]) → [..., 2, R, N] Montgomery NTT."""
    J = ext.shape[-3]
    qq = u32(q)
    acc = None
    for j in range(J):
        prod = u32(ext[..., j, None, :, :]) * u32(k[j]) % qq
        acc = prod if acc is None else add_i64(acc, prod, qq)
    return acc.to(torch.int32)


# csrc/ip_kernel.cu: threads a block (each owns one quad of 4 x)
IP_THREADS = 128
# batch rows a thread, widest first (the kernel's instantiations)
IP_TILE_ROWS = (4, 2, 1)
# the fewest threads a launch should have: 512 on each of the H100's 132
# SMs, with 16-byte loads enough in flight to keep device memory busy
IP_MIN_THREADS = 132 * 512


def ip_tiles(B: int, R: int, N: int) -> tuple[int, int, int]:
    """The kernel's decomposition of ext [B, J, R, N]: (batch rows a
    thread, batch tiles, blocks).  The widest tile of at most B rows whose
    launch still has :data:`IP_MIN_THREADS` threads (keys are read once a
    tile), else one row."""
    quads = R * N // 4
    for bt in IP_TILE_ROWS:
        tiles = -(-B // bt)
        if bt == 1 or (bt <= B and quads * tiles >= IP_MIN_THREADS):
            return bt, tiles, -(-quads // IP_THREADS) * tiles
    raise AssertionError("unreachable")


def inner_product(ext, k, ks, q):
    """Key-switch MAC (shapes as :func:`inner_product_plain`); the
    ``inner_product`` kernel on a CUDA tensor."""
    cuda_lib.check_i32("inner_product", ext, k, ks, q)
    if not cuda_lib.on_card(ext, k, ks, q):
        return inner_product_plain(ext, k, ks, q)
    if ext.dim() < 3:
        raise ValueError("inner_product: ext must be [..., J, R, N]")
    J, R, N = ext.shape[-3:]
    if k.shape != (J, 2, R, N) or ks.shape != k.shape or q.numel() != R:
        raise ValueError(f"inner_product: keys {tuple(k.shape)} / q "
                         f"{tuple(q.shape)} do not match ext "
                         f"{tuple(ext.shape)}")
    if N % 4:
        raise ValueError(f"inner_product: N = {N} is not a multiple of 4")
    lead = ext.shape[:-3]
    B = ext.numel() // (J * R * N)
    out = torch.empty((*lead, 2, R, N), dtype=torch.int32, device=ext.device)
    if B == 0:
        return out
    cuda_lib.check_aligned("inner_product", ext, k, ks, out)
    p = cuda_lib.ptr
    cuda_lib.launch("inner_product", "hetpu_inner_product", ext.device,
                    p(ext), p(k), p(ks), p(q), p(out), B, J, R, N,
                    ip_tiles(B, R, N)[0],
                    nbytes=cuda_lib.plane_bytes(N, B * J * R, 2 * J * 2 * R,
                                                B * 2 * R))
    return out
