"""Plain CKKS decryption, decoding and the comparison that decides
``correct``.

Written from the scheme's definition, in plain PyTorch int64 (CPU or
card), and independent of the program under test: it imports nothing of
it and takes nothing it made.  From the benchmark it takes the key seed
and the configuration's primes; from the program only its answers, the
ciphertexts (``data`` [k, 2, L, N] int32, ``scale``), which it reads to
judge them.

Each scheme's module gives the harness the same three functions, found
by the configuration's ``scheme``: ``values`` (the program's answers as
the comparison reads them), ``control_values`` (the control's, in their
place) and ``judge`` (both against the plain math); the first two take
the configuration.  ``CALIBRATED`` names the check whose limit is set
from the sound readings and the control's (``hebench.calibrate``).

The representation it reads, each piece re-derived here:

* the secret: ternary coefficients drawn from the key seed's first domain
  of a Philox stream (the seed's meaning, shared by both sides);
* residues mod the first L primes of the configuration, each < 2^31;
* evaluation form: index i holds a(ψ^(2·br(i)+1)), br the log2(N)-bit
  reversal and ψ the least primitive 2N-th root of unity mod q;
* Montgomery form: every residue times 2^32 mod q;
* slots: slot s is the evaluation at ζ^(5^s mod 2N), ζ = e^(iπ/N), of
  the coefficients over the ciphertext's scale.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

CALIBRATED = "max_abs_err"

_MASK = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def ternary_secret(key_seed: bytes, n: int) -> np.ndarray:
    """The secret's coefficients in {-1, 0, 1}: domain 1 of the key seed's
    Philox stream (its two 64-bit key words fold the seed's four)."""
    w = np.frombuffer(key_seed, dtype=np.uint64)
    mix = (_GOLDEN * 1) & _MASK
    key = np.array([int(w[0] ^ w[2]) ^ mix, int(w[1] ^ w[3]) ^ ((mix + 1)
                                                                 & _MASK)],
                   dtype=np.uint64)
    g = np.random.Generator(np.random.Philox(key=key))
    return g.integers(-1, 2, size=n, dtype=np.int64)


def least_root_2n(q: int, n: int) -> int:
    """The least primitive 2N-th root of unity mod the prime q."""
    for x in range(2, q):
        r = pow(x, (q - 1) // (2 * n), q)
        if pow(r, n, q) == q - 1:
            break
    best, r2, cur = r, r * r % q, r
    for _ in range(n - 1):                 # every odd power r^k, k < 2N
        cur = cur * r2 % q
        best = min(best, cur)
    return best


def _powers(x: int, count: int, q: int) -> list[int]:
    out, cur = [], 1
    for _ in range(count):
        out.append(cur)
        cur = cur * x % q
    return out


@lru_cache(maxsize=None)
def _host_tables(n: int, primes: tuple[int, ...]) -> dict:
    psi, psi_inv, om, om_inv, n_inv, r_inv = [], [], [], [], [], []
    for q in primes:
        p = least_root_2n(q, n)
        pi = pow(p, -1, q)
        psi.append(_powers(p, n, q))
        psi_inv.append(_powers(pi, n, q))
        om.append(_powers(p * p % q, n // 2, q))
        om_inv.append(_powers(pi * pi % q, n // 2, q))
        n_inv.append(pow(n, -1, q))
        r_inv.append(pow((1 << 32) % q, -1, q))
    logn = n.bit_length() - 1
    br = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        br |= ((np.arange(n) >> b) & 1) << (logn - 1 - b)
    col = lambda v: np.array(v, dtype=np.int64).reshape(-1, 1)
    return dict(q=col(primes), psi=np.array(psi, dtype=np.int64),
                psi_inv=np.array(psi_inv, dtype=np.int64),
                om=np.array(om, dtype=np.int64),
                om_inv=np.array(om_inv, dtype=np.int64),
                n_inv=col(n_inv), r_inv=col(r_inv), br=br)


@dataclass(frozen=True)
class Basis:
    """NTT tables of one prime basis as int64 tensors on one device."""

    n: int
    primes: tuple[int, ...]
    t: dict

    @classmethod
    def make(cls, n: int, primes, device) -> "Basis":
        primes = tuple(int(q) for q in primes)
        h = _host_tables(n, primes)
        return cls(n, primes, {k: torch.from_numpy(v).to(device)
                               for k, v in h.items()})


def _cyclic(x: torch.Tensor, om: torch.Tensor, q: torch.Tensor,
            br: torch.Tensor) -> torch.Tensor:
    """Cyclic DFT over the last axis, x [..., L, N] in [0, q): radix-2
    decimation in time after the input's bit reversal; om [L, N/2]."""
    n = x.shape[-1]
    lead, L = x.shape[:-2], x.shape[-2]
    x = x.index_select(-1, br)
    q3 = q.reshape(L, 1, 1)
    h = 1
    while h < n:
        x = x.reshape(*lead, L, n // (2 * h), 2, h)
        w = om[:, :: n // (2 * h)][:, :h].reshape(L, 1, h)
        u, v = x[..., 0, :], x[..., 1, :] * w % q3
        x = torch.stack([(u + v) % q3, (u - v) % q3], dim=-2)
        h *= 2
    return x.reshape(*lead, L, n)


def ntt(a: torch.Tensor, b: Basis) -> torch.Tensor:
    """Coefficients [..., L, N] → evaluations in the order above."""
    t = b.t
    x = a * t["psi"] % t["q"]
    return _cyclic(x, t["om"], t["q"], t["br"]).index_select(-1, t["br"])


def intt(e: torch.Tensor, b: Basis) -> torch.Tensor:
    """Evaluations in the order above → coefficients [..., L, N]."""
    t = b.t
    x = _cyclic(e.index_select(-1, t["br"]), t["om_inv"], t["q"], t["br"])
    return x * t["n_inv"] % t["q"] * t["psi_inv"] % t["q"]


def secret_eval(key_seed: bytes, b: Basis) -> torch.Tensor:
    s = torch.from_numpy(ternary_secret(key_seed, b.n)).to(b.t["q"].device)
    return ntt(s % b.t["q"], b)


def lift(r: torch.Tensor, primes) -> tuple[torch.Tensor, torch.Tensor]:
    """Centered values of residues r [..., L, N] from their first three
    limbs (Garner, as float64), and per coefficient the number of limbs
    whose residue that value does not reproduce."""
    qs = [int(q) for q in primes]
    k = min(3, len(qs))
    t = [r[..., 0, :]]
    for j in range(1, k):
        qj, acc, base = qs[j], torch.zeros_like(t[0]), 1
        for i in range(j):                 # mixed-radix value so far mod qj
            acc = (acc + t[i] % qj * (base % qj)) % qj
            base *= qs[i]
        t.append((r[..., j, :] - acc) % qj * pow(base % qj, -1, qj) % qj)
    t[-1] = torch.where(t[-1] > qs[k - 1] // 2, t[-1] - qs[k - 1], t[-1])
    # exact in int64 while the centered top digit is 0 or ±1 (|value| <
    # 2^63); beyond that the value is far off and float64 is enough
    exact, approx, base = torch.zeros_like(t[0]), torch.zeros(
        t[0].shape, dtype=torch.float64, device=r.device), 1
    for i in range(k):
        exact = exact + t[i] * base
        approx = approx + t[i].to(torch.float64) * float(base)
        base *= qs[i]
    val = torch.where(t[-1].abs() <= 1, exact.to(torch.float64), approx)
    bad = torch.zeros(t[0].shape, dtype=torch.int64, device=r.device)
    for j in range(k, len(qs)):
        qj, acc, base = qs[j], torch.zeros_like(t[0]), 1
        for i in range(k):
            acc = (acc + t[i] % qj * (base % qj)) % qj
            base *= qs[i]
        bad += (acc != r[..., j, :]).to(torch.int64)
    return val, bad


def decode(coeffs: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Coefficients [..., N] (float64) over their scale [...] → complex
    slots [..., N/2]."""
    n = coeffs.shape[-1]
    k = torch.arange(n, device=coeffs.device, dtype=torch.float64)
    zeta = torch.polar(torch.ones_like(k), torch.pi * k / n)
    z = n * torch.fft.ifft((coeffs / scale.unsqueeze(-1)) * zeta, dim=-1)
    e = torch.from_numpy(_slot_exps(n)).to(coeffs.device)
    return z.index_select(-1, (e - 1) // 2)


@lru_cache(maxsize=None)
def _slot_exps(n: int) -> np.ndarray:
    out, e = np.empty(n // 2, dtype=np.int64), 1
    for s in range(n // 2):
        out[s] = e
        e = e * 5 % (2 * n)
    return out


def phase(data: torch.Tensor, key_seed: bytes,
          primes) -> tuple[torch.Tensor, Basis]:
    """c0 + c1·s of ciphertexts [k, 2, L, N] (int32, Montgomery evaluation
    form) over the first L primes, in evaluation form [k, L, N], and the
    basis of those primes."""
    L, n = data.shape[-2], data.shape[-1]
    b = Basis.make(n, tuple(primes)[:L], data.device)
    q, s = b.t["q"], secret_eval(key_seed, b)
    c = data.to(torch.int64) % q
    return (c[:, 0] + c[:, 1] * s % q) % q * b.t["r_inv"] % q, b


def decrypt(data: torch.Tensor, scale: torch.Tensor, key_seed: bytes,
            primes) -> tuple[torch.Tensor, torch.Tensor]:
    """Ciphertexts [k, 2, L, N] (int32, Montgomery evaluation form) over
    the first L primes → (complex slots [k, N/2], limbs that disagree
    [k, N])."""
    m, b = phase(data, key_seed, primes)
    val, bad = lift(intt(m, b), b.primes)
    return decode(val, scale), bad


@dataclass
class Answer:
    """What the program answered for one unit of work, with the inputs the
    benchmark gave it: ``data`` [k, 2, L, N] int32, one scale a ciphertext,
    ``inputs`` for the entry's plain math, and the first ``slots`` slots
    of each ciphertext compared."""

    data: torch.Tensor
    scales: list
    inputs: dict
    slots: int


def values(answers: list, key_seed: bytes, config: dict, device) -> list:
    """The program's answers as the comparison reads them: per answer its
    compared slots [k, slots] (complex) and the number of coefficients
    whose limbs disagree."""
    out = []
    for a in answers:
        data = a.data.to(device)
        scale = torch.tensor(a.scales, dtype=torch.float64, device=device)
        slots, mism = decrypt(data, scale, key_seed, config["moduli"])
        out.append((slots[:, : a.slots], int(mism.sum())))
    return out


# the precision one step below a configuration's stated class
LOWER = {"float64": torch.float32, "float32": torch.bfloat16,
         "float16": "int8", "bfloat16": "int8"}


def _int8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to symmetric int8 (one scale a tensor), back in float64."""
    s = float(x.abs().max()) or 1.0
    return torch.round(x / s * 127.0) * (s / 127.0)


def control_values(answers: list, expected, config: dict,
                   device) -> list:
    """The control, put in the program's place: the plain math itself
    computed one precision below the configuration's ``precision`` (int8:
    inputs and result rounded to int8, the products exact), with no limbs
    to disagree."""
    low = LOWER[config["precision"]]
    out = []
    for a in answers:
        if low == "int8":
            q = {k: (_int8(torch.as_tensor(v, dtype=torch.float64))
                     if isinstance(v, np.ndarray) else v)
                 for k, v in a.inputs.items()}
            got = _int8(expected(q, torch.float64, device))
        else:
            got = expected(a.inputs, low, device).to(torch.float64)
        out.append((got, 0))
    return out


def judge(vals: list, answers: list, expected, device) -> dict:
    """Each answer's values (``values`` or ``control_values``) against
    ``expected(inputs)`` in float64: per answer and over all, the widest
    gap of a compared slot and the coefficients whose limbs disagree."""
    per = []
    for (slots, mism), a in zip(vals, answers):
        want = expected(a.inputs, torch.float64, device)
        per.append({"max_abs_err": float((slots.to(device) - want)
                                         .abs().max()),
                    "limb_mismatch": mism})
    return {"checks": {"max_abs_err": max(p["max_abs_err"] for p in per),
                       "limb_mismatch": sum(p["limb_mismatch"]
                                            for p in per)},
            "per_answer": per}
