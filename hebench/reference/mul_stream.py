"""Plain math of ``multiply_relin_rescale``: the slots' product."""

import torch


def expected(inputs: dict, dtype, device) -> torch.Tensor:
    """x ⊙ y for each ciphertext pair, [k, slots]."""
    x = torch.as_tensor(inputs["x"], device=device).to(dtype)
    y = torch.as_tensor(inputs["y"], device=device).to(dtype)
    return x * y
