"""Plain math of the forward in-slot FFT (``bfft``): every slot of each
ciphertext.

The layout, as the benchmark encrypts it: ciphertext j holds one n-point
complex signal x_j tiled over its slots (slot s holds x_j[s mod n]).  The
transform leaves X_j = DFT(x_j), X_j[k] = Σ_t x_j[t]·e^(−2πi·t·k/n) (as
``numpy.fft.fft``), in bit-reversed order and tiled the same way: slot s
holds X_j[br(s mod n)], br the log2(n)-bit reversal."""

import torch

# the complex type that carries a real precision class
COMPLEX = {torch.float64: torch.complex128, torch.float32: torch.complex64}


def bit_reversal(n: int) -> torch.Tensor:
    """[n] int64: index i holds i with its log2(n) bits reversed."""
    bits = n.bit_length() - 1
    i = torch.arange(n)
    out = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        out |= ((i >> b) & 1) << (bits - 1 - b)
    return out


def expected(inputs: dict, dtype, device) -> torch.Tensor:
    """[k, slots]: for each signal x_j [n] of ``inputs["x"]`` ([k, n]), its
    DFT in bit-reversed order, tiled over ``inputs["slots"]`` slots,
    computed in the complex type of ``dtype``."""
    x = torch.as_tensor(inputs["x"], device=device).to(COMPLEX[dtype])
    n, slots = x.shape[-1], int(inputs["slots"])
    if slots % n:
        raise ValueError(f"{n} points do not tile {slots} slots")
    spec = torch.fft.fft(x, dim=-1)
    return spec[:, bit_reversal(n).to(device)].repeat(1, slots // n)
