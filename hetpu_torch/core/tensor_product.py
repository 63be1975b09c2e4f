"""The ct·ct tensor product: out_k = Σ_{i+j=k} x_i·y_j·R⁻¹ of Montgomery-NTT
polys, the multiply of every CKKS and BFV product.

Counterpart of the Karatsuba body of hetpu's ``Evaluator.multiply``
(``hetpu/core/evaluator.py:117``) and ``square`` (``:150``), which XLA fuses
into one loop under the evaluator's ``jax.jit``.  Eager PyTorch would make
every Montgomery product and modular add its own int64 pass over device
memory, so a CUDA tensor launches the ``tensor_product`` kernel
(``csrc/tensor_product.cu``) for the 2×2 product and the square, and a CPU
tensor takes :func:`tensor_product_plain`.  The general k×m product
(deferred relinearisation) stays plain on either device.

:func:`tensor_product_acc` adds the product into a running sum in place
(the diagonal method's sum over rotation steps): on a CUDA tensor one
launch of the ``tensor_product_acc`` kernel, which reads a one-row y at a
row stride of 0; on a CPU tensor :func:`tensor_product_acc_plain`, the
product followed by ``mod_add``.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .modular import mod_add, mod_sub, mont_mul


def tensor_product_plain(x, y, q, r_inv):
    """Part-wise product of x [..., ka, L, N] and y [..., kb, L, N]
    (``y`` None: the square of a 2-part x, t1 = 2·c0·c1·R⁻¹):
    [..., ka+kb−1, L, N]; the 2×2 case uses Karatsuba (3 modular
    multiplies), as the reference."""
    if y is None:
        c0, c1 = x[..., 0, :, :], x[..., 1, :, :]
        t0 = mont_mul(c0, c0, q, r_inv)
        t2 = mont_mul(c1, c1, q, r_inv)
        t01 = mont_mul(c0, c1, q, r_inv)
        return torch.stack([t0, mod_add(t01, t01, q), t2], dim=-3)
    ka, kb = x.shape[-3], y.shape[-3]
    if ka == 2 and kb == 2:
        c0, c1 = x[..., 0, :, :], x[..., 1, :, :]
        d0, d1 = y[..., 0, :, :], y[..., 1, :, :]
        t0 = mont_mul(c0, d0, q, r_inv)
        t2 = mont_mul(c1, d1, q, r_inv)
        t1 = mod_sub(
            mod_sub(mont_mul(mod_add(c0, c1, q), mod_add(d0, d1, q), q,
                             r_inv), t0, q),
            t2, q)
        return torch.stack([t0, t1, t2], dim=-3)
    parts = []
    for k in range(ka + kb - 1):
        acc = None
        for i in range(max(0, k - kb + 1), min(ka, k + 1)):
            t = mont_mul(x[..., i, :, :], y[..., k - i, :, :], q, r_inv)
            acc = t if acc is None else mod_add(acc, t, q)
        parts.append(acc)
    return torch.stack(parts, dim=-3)


def _kernel_consts(name, x, y, q, qinv_neg):
    """q and −q⁻¹ contiguous, for a K7 launch over x and y [..., L, N];
    raises unless all four are contiguous int32, the constants one a limb
    and N a multiple of 4 (the kernels move 16-byte quads)."""
    q, qinv_neg = q.contiguous(), qinv_neg.contiguous()
    cuda_lib.check_i32(name, x, y, q, qinv_neg)
    L, N = x.shape[-2:]
    if q.numel() != L or qinv_neg.numel() != L:
        raise ValueError(f"{name}: constants {tuple(q.shape)} do not match "
                         f"{L} limbs")
    if N % 4:
        raise ValueError(f"{name}: N = {N} is not a multiple of 4")
    return q, qinv_neg


def tensor_product(x, y, q, r_inv, qinv_neg):
    """:func:`tensor_product_plain`'s function (``y`` None: the square);
    the ``tensor_product`` kernel on a CUDA tensor for the 2×2 product and
    the square.  ``q``, ``r_inv``, ``qinv_neg``: the limbs' [L, 1]
    Montgomery constants (``Context.mont``); the kernel reads q and −q⁻¹,
    the plain form q and R⁻¹."""
    ys = () if y is None else (y,)
    two = x.shape[-3] == 2 and all(t.shape[-3] == 2 for t in ys)
    if not cuda_lib.on_card(x, *ys, q, qinv_neg) or not two:
        return tensor_product_plain(x, y, q, r_inv)
    square = y is None
    if not square and y.shape != x.shape:
        x, y = torch.broadcast_tensors(x, y)
    x = x.contiguous()
    y = x if square else y.contiguous()
    q, qinv_neg = _kernel_consts("tensor_product", x, y, q, qinv_neg)
    L, N = x.shape[-2:]
    out = torch.empty((*x.shape[:-3], 3, L, N), dtype=torch.int32,
                      device=x.device)
    rows = x.numel() // (2 * L * N)
    if rows == 0:
        return out
    cuda_lib.check_aligned("tensor_product", x, y, out)
    p = cuda_lib.ptr
    cuda_lib.launch("tensor_product", "hetpu_tensor_product", x.device,
                    p(x), p(y), p(q), p(qinv_neg), p(out), rows, L, N,
                    int(square),
                    nbytes=cuda_lib.plane_bytes(
                        N, rows * 2 * L * (1 if square else 2), rows * 3 * L))
    return out


def tensor_product_acc_plain(acc, x, y, q, r_inv):
    """acc + x·y mod q: :func:`tensor_product_plain`, then ``mod_add``,
    written into ``acc`` in place and returned; ``acc`` None: x·y in a new
    tensor (the sum's first term)."""
    prod = tensor_product_plain(x, y, q, r_inv)
    if acc is None:
        return prod
    if acc.shape != prod.shape:
        raise ValueError(f"tensor_product_acc: sum {tuple(acc.shape)} vs "
                         f"product {tuple(prod.shape)}")
    return acc.copy_(mod_add(acc, prod, q))


def tensor_product_acc(acc, x, y, q, r_inv, qinv_neg):
    """:func:`tensor_product_acc_plain`'s function: acc ← acc + x·y mod q
    in place (``acc`` None: a new sum holding x·y), returned.  On a CUDA
    tensor the 2×2 product is one launch of the ``tensor_product_acc``
    kernel; a y of one row ([2, L, N], every leading axis 1) is read at a
    row stride of 0 for every row of x, with no broadcast copy.  ``acc``
    [..., 3, L, N] int32, contiguous, of x·y's broadcast shape."""
    ts = (x, y, q, qinv_neg, *(() if acc is None else (acc,)))
    if not cuda_lib.on_card(*ts) or x.shape[-3] != 2 or y.shape[-3] != 2:
        return tensor_product_acc_plain(acc, x, y, q, r_inv)
    L, N = x.shape[-2:]
    # (not torch.broadcast_shapes: its first call imports sympy, seconds)
    one = y.numel() == 2 * L * N and y.shape[-2:] == (L, N) \
        and y.dim() <= x.dim()
    if one:
        y = y.reshape(2, L, N)
    elif y.shape != x.shape:
        x, y = torch.broadcast_tensors(x, y)
    x, y = x.contiguous(), y.contiguous()
    q, qinv_neg = _kernel_consts("tensor_product_acc", x, y, q, qinv_neg)
    out_shape = (*x.shape[:-3], 3, L, N)
    init = acc is None
    if init:
        acc = torch.empty(out_shape, dtype=torch.int32, device=x.device)
    elif tuple(acc.shape) != out_shape:
        raise ValueError(f"tensor_product_acc: sum {tuple(acc.shape)} vs "
                         f"product {out_shape}")
    cuda_lib.check_i32("tensor_product_acc", acc)
    rows = x.numel() // (2 * L * N)
    if rows == 0:
        return acc
    cuda_lib.check_aligned("tensor_product_acc", x, y, acc)
    p = cuda_lib.ptr
    cuda_lib.launch("tensor_product_acc", "hetpu_tensor_product_acc",
                    x.device, p(x), p(y), 0 if one else 2 * L * N, p(q),
                    p(qinv_neg), p(acc), rows, L, N, int(init),
                    nbytes=cuda_lib.plane_bytes(
                        N, rows * 2 * L, (1 if one else rows) * 2 * L,
                        0 if init else rows * 3 * L, rows * 3 * L))
    return acc


# ----------------------------------------------------------------------
# the kernel's arithmetic, step by step in int64 (the CPU tests hold it
# against the reference's 16-bit-emulated mont_mul)
# ----------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF


def redc_u32(a, b, q, qinv_neg):
    """a·b·R⁻¹ mod q as ``csrc/tensor_product.cu`` ``mont_mul`` computes
    it: t = a·b (64 bits), m = lo(t)·(−q⁻¹) mod 2^32,
    u = hi(t) + hi(m·q) + (lo(t) ≠ 0) < 2q, one conditional subtract.
    int64 tensors of values < 2^32 in, int64 out."""
    t = a * b                                   # < 2^62: fits int64
    lo, hi = t & _MASK32, t >> 32
    m = ((lo & 0xFFFF) * qinv_neg                # lo(lo·(−q⁻¹)), each
         + ((((lo >> 16) * qinv_neg) & 0xFFFF) << 16)) & _MASK32  # < 2^48
    mq_hi = (m * q) >> 32
    u = hi + mq_hi + (lo != 0).to(torch.int64)
    return torch.where(u >= q, u - q, u)
