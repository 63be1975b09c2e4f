"""Plain math of BFV ``multiply_relin``: the slots' product mod t."""

import torch


def expected(inputs: dict, dtype, device) -> torch.Tensor:
    """x ⊙ y mod t for each ciphertext pair, [k, slots]: exact for an
    integer ``dtype`` (shift-and-add, every partial sum below 2^63 while
    t < 2^61), else the product computed in ``dtype`` and reduced there."""
    t = int(inputs["t"])
    x = torch.as_tensor(inputs["x"], device=device)
    y = torch.as_tensor(inputs["y"], device=device)
    if dtype.is_floating_point:
        return torch.remainder(x.to(dtype) * y.to(dtype), t)
    if t >= 1 << 61:
        raise ValueError("plain modulus beyond 2^61")
    x, y = x.to(torch.int64) % t, y.to(torch.int64) % t
    out = torch.zeros_like(x)
    for bit in reversed(range(t.bit_length())):
        out = (out * 2 + x * ((y >> bit) & 1)) % t
    return out
