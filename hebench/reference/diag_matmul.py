"""Plain math of the diagonal-method matrix product (``BatchedMatrix``
diag × col): every slot of each output column's ciphertext.

The layouts, as the benchmark encrypts them: slot i of diagonal k holds
A[i, (i + k) mod d], slot i of column j holds B[i, j], each vector placed
twice (slots [0, 2d)) and then zeros.  Rotating column j left by k and
multiplying by diagonal k, summed over k < d, puts C = A·B's column j in
slots [0, d); slots [d, 2d) hold the partial sums of the upper copy (the
terms whose rotated slot stays below 2d) and the rest are 0."""

import torch


def tile2(rows: torch.Tensor, slots: int) -> torch.Tensor:
    """Rows [m, d] placed twice in [m, slots], zeros beyond 2d."""
    m, d = rows.shape
    if 2 * d > slots:
        raise ValueError(f"2·{d} values do not fit {slots} slots")
    out = torch.zeros(m, slots, dtype=rows.dtype, device=rows.device)
    out[:, :d] = rows
    out[:, d: 2 * d] = rows
    return out


def diagonals(a: torch.Tensor) -> torch.Tensor:
    """[d, d]: row k is diagonal k, A[i, (i + k) mod d] at i."""
    d = a.shape[0]
    i = torch.arange(d, device=a.device)
    return a[i.expand(d, d), (i[None, :] + i[:, None]) % d]


def expected(inputs: dict, dtype, device) -> torch.Tensor:
    """[p, slots]: for each column j of B (d × p),
    Σ_k tile₂(diag_k(A)) ⊙ roll(tile₂(B[:, j]), −k), in ``dtype``."""
    a = torch.as_tensor(inputs["a"], device=device).to(dtype)
    b = torch.as_tensor(inputs["b"], device=device).to(dtype)
    slots = int(inputs["slots"])
    diag = tile2(diagonals(a), slots)
    col = tile2(b.T.contiguous(), slots)
    out = torch.zeros_like(col)
    for k in range(a.shape[0]):
        out = out + diag[k] * torch.roll(col, -k, dims=-1)
    return out
