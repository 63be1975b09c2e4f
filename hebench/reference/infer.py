"""Plain math of ``infer_step``: a diagonal-method matvec against the
weights, then the activation polynomial c0 + c1·u + c2·u²."""

import torch


def expected(inputs: dict, dtype, device) -> torch.Tensor:
    """[k, slots]: u = Σ_d w_d ⊙ (x rotated left by d), then the
    polynomial, for each of the k activation vectors x."""
    x = torch.as_tensor(inputs["x"], device=device).to(dtype)
    w = torch.as_tensor(inputs["diags"], device=device).to(dtype)
    c0, c1, c2 = (float(c) for c in inputs["act"])
    u = torch.zeros_like(x)
    for d in range(w.shape[0]):
        u = u + w[d] * torch.roll(x, -d, dims=-1)
    return c0 + c1 * u + c2 * u * u
