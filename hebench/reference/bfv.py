"""Plain BFV decryption, batch decoding and the comparison that decides
``correct``.

Written from the scheme's definition, in plain PyTorch int64 (CPU or
card) with Python integers where exactness needs them, and independent of
the program under test: it imports nothing of it and takes nothing it
made.  From the benchmark it takes the key seed and the configuration
(its primes, its plain modulus t and t's factors); from the program only
its answers, the ciphertexts (``data`` [k, 2, L, N] int32), which it
reads to judge them.  The transforms, the secret and the representation
are :mod:`.ckks`'s; what is BFV's own:

* the phase x = [c0 + c1·s]_Q, from every limb, is Δ·m plus noise, with
  Δ = Q/t: the message is m = round(t·x/Q) mod t, taken exactly (see
  :func:`scale_round`);
* slots (SEAL's ``BatchEncoder``): per factor f of t, slot c < N/2 is m
  evaluated at ψ^(5^c mod 2N) and slot N/2 + c at ψ^(−5^c), ψ the least
  primitive 2N-th root of unity mod f; the factors' slots combine by CRT.

The comparison is exact: ``slot_mismatch`` counts the slots that differ
from the plain result (limit 0), and ``limb_mismatch`` the coefficients
whose limbs do not describe Δ·m plus noise with a margin: |t·x/Q − m| of
1/4 or more, one bit of noise budget or less, where a corrupted limb puts
it anywhere in [0, 1/2].
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .ckks import Basis, _slot_exps, intt, ntt, phase

CALIBRATED = "slot_mismatch"

# the precision one step below a configuration's stated class
LOWER = {"exact": torch.float64}

_TIE = 1e-6              # |fraction − 1/2| below which the rounding is
                         # settled with Python integers (float64's error
                         # here is ~1e-14)


def scale_round(x: torch.Tensor, primes, t: int):
    """Coefficient residues x [..., L, N] of the phase, mod the L
    ``primes`` → (m = round(t·x/Q) mod t [..., N], |t·x/Q − m| as float64
    [..., N]), exactly, for t < 2^61.

    With y_i = x_i·(Q/q_i)^(−1) mod q_i, x = Σ y_i·Q/q_i − v·Q for an
    integer v, so t·x/Q ≡ Σ t·y_i/q_i (mod t), and t·y_i/q_i is
    y_i·⌊t/q_i⌋ + ⌊u_i/q_i⌋ + (u_i mod q_i)/q_i with u_i = y_i·(t mod q_i)
    < 2^62: an integer mod t, in int64, and a fraction whose sum over the
    limbs is rounded once.  A sum within 1e-6 of a half is rounded with
    Python integers."""
    qs = [int(q) for q in primes]
    if t >= 1 << 61:
        raise ValueError("plain modulus beyond 2^61")
    Q = 1
    for q in qs:
        Q *= q
    whole = torch.zeros(x.shape[:-2] + x.shape[-1:], dtype=torch.int64,
                        device=x.device)
    frac = torch.zeros(whole.shape, dtype=torch.float64, device=x.device)
    rem = []
    for i, q in enumerate(qs):
        y = x[..., i, :] * pow(Q // q % q, -1, q) % q
        u = y * (t % q)
        whole = (whole + y * (t // q) % t + u // q) % t
        rem.append(u % q)
        frac = frac + rem[-1].to(torch.float64) / q
    k = torch.floor(frac + 0.5)
    tie = ((frac - torch.floor(frac)) - 0.5).abs() < _TIE
    if bool(tie.any()):
        idx = tie.nonzero(as_tuple=True)
        cols = [r[idx].tolist() for r in rem]
        exact = [(2 * sum(b * (Q // q) for b, q in zip(bs, qs)) + Q)
                 // (2 * Q) for bs in zip(*cols)]
        k[idx] = torch.tensor(exact, dtype=torch.float64, device=x.device)
    m = (whole + k.to(torch.int64)) % t
    return m, (frac - k).abs()


@lru_cache(maxsize=None)
def _slot_index(n: int) -> np.ndarray:
    """The evaluation index of each slot, in :func:`.ckks.ntt`'s order
    (index i holds the exponent 2·br(i)+1)."""
    logn = n.bit_length() - 1
    br = np.zeros(n, dtype=np.int64)
    for b in range(logn):
        br |= ((np.arange(n) >> b) & 1) << (logn - 1 - b)
    e = _slot_exps(n)
    exps = np.concatenate([e, 2 * n - e])
    return br[(exps - 1) // 2]


def decode(m: torch.Tensor, t: int, factors) -> torch.Tensor:
    """Coefficients mod t [..., N] → slots mod t [..., N]: per factor its
    evaluations in slot order, combined by Garner (exact in int64 while
    t < 2^62)."""
    n = m.shape[-1]
    idx = torch.from_numpy(_slot_index(n)).to(m.device)
    out, base = None, 1
    for f in (int(f) for f in factors):
        e = ntt((m % f).unsqueeze(-2), Basis.make(n, (f,), m.device))
        e = e[..., 0, :].index_select(-1, idx)
        if out is None:
            out = e
        else:                        # out + base·((e − out)·base⁻¹ mod f)
            d = (e - out % f) % f * pow(base % f, -1, f) % f
            out = out + d * base
        base *= f
    if base != t:
        raise ValueError("the plain modulus is not the product of its "
                         "factors")
    return out


def values(answers: list, key_seed: bytes, config: dict, device) -> list:
    """The program's answers as the comparison reads them: per answer its
    compared slots [k, slots] (int64, mod t) and the number of
    coefficients decrypted with no margin."""
    t = int(config["plain_modulus"])
    factors = config["plain_factors"] or [t]
    out = []
    for a in answers:
        data = a.data.to(device)
        x, b = phase(data, key_seed, config["moduli"])
        m, off = scale_round(intt(x, b), b.primes, t)
        slots = decode(m, t, factors)
        out.append((slots[:, : a.slots], int((off >= 0.25).sum())))
    return out


def control_values(answers: list, expected, config: dict, device) -> list:
    """The control, put in the program's place: the plain math computed
    one precision below the configuration's (float64 for exact integers),
    rounded to integers mod t, with no limbs to disagree."""
    low = LOWER[config["precision"]]
    t = int(config["plain_modulus"])
    out = []
    for a in answers:
        got = expected(a.inputs, low, device)
        out.append((torch.round(got).to(torch.int64) % t, 0))
    return out


def judge(vals: list, answers: list, expected, device) -> dict:
    """Each answer's values (``values`` or ``control_values``) against
    ``expected(inputs)`` exactly: per answer and over all, the slots that
    differ and the coefficients decrypted with no margin."""
    per = []
    for (slots, bad), a in zip(vals, answers):
        want = expected(a.inputs, torch.int64, device)
        per.append({"slot_mismatch": int((slots.to(device) != want).sum()),
                    "limb_mismatch": bad})
    return {"checks": {k: sum(p[k] for p in per)
                       for k in ("slot_mismatch", "limb_mismatch")},
            "per_answer": per}
