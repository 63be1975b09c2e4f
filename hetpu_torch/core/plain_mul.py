"""The sum of plaintext products: out = Σₖ xₖ·wₖ mod q for one to three
(source, mask, mask companion) terms, the plaintext multiply of CKKS
(``Evaluator.multiply_plain``, one term) and the in-slot FFT's masked sum
(``Evaluator.multiply_plain_sum``, two or three a stage).

Counterpart of hetpu's ``Evaluator.multiply_plain``
(``hetpu/core/evaluator.py:109``) over ``modular.shoup_mul``, which XLA
fuses into one 32-bit pass under the evaluator's ``jax.jit``, with the
``mod_add`` sum of ``bfft``'s products (``hetpu/fft/__init__.py:176-178``).
Eager PyTorch makes every product an int64 pass and every add three int32
passes, so a CUDA tensor launches the ``plain_mul_sum`` kernel
(``csrc/plain_mul.cu``) once for the whole sum, and a CPU tensor takes
:func:`plain_mul_sum_plain`.

The sources xₖ are [..., parts, L, N] of one shape; each mask wₖ (with its
Shoup companion) has a plaintext's shape, without the parts axis: one row
[L, N] (every leading axis 1), read by every row at a row stride of 0, or
one a batch row ([*lead, L, N] for sources [*lead, parts, L, N]), read at a
row stride of L·N.  On the card a mask of another broadcast into the
sources' leading axes is expanded to one a batch row, and a non-contiguous
mask made contiguous; a mask with leading axes the sources lack raises
there.  The plain route runs on the CPU alone.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .modular import mod_add, shoup_mul

MAX_TERMS = 3


def _check_terms(terms) -> list:
    terms = [tuple(t) for t in terms]
    if not 1 <= len(terms) <= MAX_TERMS:
        raise ValueError(f"plain_mul_sum: {len(terms)} terms, expected 1 to "
                         f"{MAX_TERMS}")
    shape = terms[0][0].shape
    if len(shape) < 3 or any(x.shape != shape for x, _, _ in terms):
        raise ValueError(f"plain_mul_sum: sources "
                         f"{[tuple(x.shape) for x, _, _ in terms]} must share "
                         f"one [..., parts, L, N] shape")
    return terms


def plain_mul_sum_plain(terms, q):
    """Σₖ xₖ·wₖ mod q: ``shoup_mul`` of each (x, w, ws) term, the mask
    broadcast over the parts axis, then ``mod_add`` into the sum."""
    acc = None
    for x, w, ws in _check_terms(terms):
        t = shoup_mul(x, w.unsqueeze(-3), ws.unsqueeze(-3), q)
        acc = t if acc is None else mod_add(acc, t, q)
    return acc


def _card_masks(x: torch.Tensor, masks) -> tuple[list, int]:
    """The masks as the kernel reads them, contiguous, and the words between
    their batch rows: 0 where every mask is of one row, else L·N with each
    mask expanded to ``x``'s leading axes (no copy for a mask that is one
    a batch row already).  Raises on a mask that does not broadcast into
    ``x``'s leading axes."""
    *lead, _, L, N = x.shape
    masks = [m.contiguous() for m in masks]
    if all(m.shape[-2:] == (L, N) and m.numel() == L * N
           and m.dim() < x.dim() for m in masks):
        return masks, 0
    try:
        return [m.expand(*lead, L, N).contiguous() for m in masks], L * N
    except RuntimeError as e:
        raise ValueError(f"plain_mul_sum: masks "
                         f"{[tuple(m.shape) for m in masks]} do not "
                         f"broadcast into sources {tuple(x.shape)} without "
                         f"their parts axis") from e


def plain_mul_sum(terms, q):
    """:func:`plain_mul_sum_plain`'s function over one to three (x, w, ws)
    terms, ``q`` the limbs' [L, 1] primes.  On CUDA tensors, one launch of
    the ``plain_mul_sum`` kernel into a new tensor of x's shape
    (:func:`_card_masks` for the masks); it raises unless every tensor is
    int32, the sources contiguous, every tensor 16-byte aligned, N a
    multiple of 4, and the masks broadcast into the sources' leading
    axes."""
    terms = _check_terms(terms)
    flat = [t for term in terms for t in term]
    if not cuda_lib.on_card(*flat, q):
        return plain_mul_sum_plain(terms, q)
    x0 = terms[0][0]
    masks, w_row = _card_masks(x0, [t for _, w, ws in terms for t in (w, ws)])
    flat = [t for i, (x, _, _) in enumerate(terms)
            for t in (x, *masks[2 * i: 2 * i + 2])]
    q = q.contiguous()
    cuda_lib.check_i32("plain_mul_sum", *flat, q)
    *lead, parts, L, N = x0.shape
    if q.numel() != L:
        raise ValueError(f"plain_mul_sum: primes {tuple(q.shape)} do not "
                         f"match {L} limbs")
    if N % 4:
        raise ValueError(f"plain_mul_sum: N = {N} is not a multiple of 4")
    out = torch.empty(x0.shape, dtype=torch.int32, device=x0.device)
    batch = x0.numel() // (parts * L * N) if x0.numel() else 0
    if batch == 0:
        return out
    cuda_lib.check_aligned("plain_mul_sum", *flat, out)
    k = len(terms)
    ptrs = [cuda_lib.ptr(t) for t in flat] + [None] * 3 * (MAX_TERMS - k)
    mask_rows = 1 if w_row == 0 else batch
    cuda_lib.launch("plain_mul_sum", "hetpu_plain_mul_sum", x0.device,
                    *ptrs, k, w_row, cuda_lib.ptr(q), cuda_lib.ptr(out),
                    batch, parts, L, N,
                    nbytes=cuda_lib.plane_bytes(
                        N, k * batch * parts * L, 2 * k * mask_rows * L,
                        batch * parts * L))
    return out
