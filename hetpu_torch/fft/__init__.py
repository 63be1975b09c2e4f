"""Encrypted DFTs over CKKS slots.

Counterpart of ``hetpu/fft/__init__.py`` (the reference's ``he::fft``,
``he_fft.h``, ``he_fft.cpp``), on the session's device:

* ``fft``/``ifft`` — ciphertext-per-coefficient transform
  (``he_fft.cpp:13-87``): the n coefficient ciphertexts are ONE batched
  ciphertext [n, ...] and each of the log2(n) stages is one batched
  plaintext multiply + rescale and two leading-axis gathers, with the
  stacked twiddle plaintext built once and cached in the session.
  Natural-order output, one level per stage; ifft folds the 1/n into the
  last stage's twiddles.

* ``bfft``/``ibfft`` — all n points in one ciphertext's slots
  (``he_fft.cpp:89-223``): log2(n) stages, 3 diagonal plaintext masks and
  a ±n/2ⁱ rotation pair per stage sharing one HOISTED decomposition.  The
  first stage merges the ±n/2 rotations through the ×2 slot tiling (the
  reference's omitted-D₂ trick, ``he_fft.cpp:192-202``).  Output in
  bit-reversed order like the reference: un-reverse at decode with
  ``bit_reverse_order``.

Conventions match ``numpy.fft``: fft uses e^{-2πi/n}, ifft its conjugate
with the 1/n factor.

While a torch profiler records, each ``bfft`` stage opens the spans
``hetpu/fft.masks`` (its mask products and their sum,
``Evaluator.multiply_plain_sum``: one ``plain_mul_sum`` launch on the
card) and ``hetpu/fft.rescale`` (its rescale, ⊃ ``ks.mod_down`` in the
paired mode), beside the hoisted rotation's own spans, and adds the masks'
bytes to :data:`mask_bytes` (each source and each mask read once, the
sum written once, int32 words: the rule of ``cuda_lib.launch_bytes``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core import cuda_lib
from ..core.ciphertext import Ciphertext, Plaintext
from ..core.modular import mod_add, mod_sub
from ..session import Session
from ..utils.profiling import profiler_on, span

# the bfft mask stages' device-memory bytes while a profiler records
mask_bytes = cuda_lib.register_counter({"bfft": 0})


def _bit_reversal(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    return np.array([int(f"{i:0{bits}b}"[::-1], 2) for i in range(n)])


def bit_reverse_order(x: np.ndarray) -> np.ndarray:
    """Permute the last axis into/out of bit-reversed order."""
    return x[..., _bit_reversal(x.shape[-1])]


# ======================================================================
# ciphertext-per-coefficient FFT
# ======================================================================

def _stage_arrays(n: int, stage_m: int, inverse: bool, last: bool):
    """Twiddle vector + butterfly index/sign arrays for one DIT stage."""
    half = stage_m // 2
    pos = np.arange(n)
    inblock = pos % stage_m
    sign = -1.0 if not inverse else 1.0
    tw = np.ones(n, dtype=np.complex128)
    odd = inblock >= half
    j = inblock[odd] - half
    tw[odd] = np.exp(sign * 2j * np.pi * j / stage_m)
    if inverse and last:
        tw = tw / n            # fold 1/n into the final stage
    iu = np.where(inblock < half, pos, pos - half)
    iv = np.where(inblock < half, pos + half, pos)
    add_mask = (inblock < half)
    return tw, iu, iv, add_mask


@lru_cache(maxsize=None)
def _reversal_index(n: int, device: torch.device) -> torch.Tensor:
    """The input's bit reversal on ``device``, built once (a host array
    handed to the card is a blocking copy from pageable memory)."""
    return torch.as_tensor(_bit_reversal(n), device=device)


@lru_cache(maxsize=None)
def _stage_index(n: int, stage_m: int, device: torch.device):
    """One stage's butterfly gathers (iu, iv) and its add/subtract select
    on ``device``, built once, as :func:`_reversal_index`."""
    _, iu, iv, add_mask = _stage_arrays(n, stage_m, False, False)
    return (torch.as_tensor(iu, device=device),
            torch.as_tensor(iv, device=device),
            torch.as_tensor(add_mask, device=device)[:, None, None, None])


def fft(sess: Session, ct: Ciphertext, inverse: bool = False) -> Ciphertext:
    """DFT across the leading batch axis of `ct` ([n, parts, L, N]); each
    batch element is one 'coefficient' ciphertext whose slots carry
    independent signals (the reference packs 8192 signals, fft.cpp:42-48)."""
    n = ct.data.shape[0]
    if n & (n - 1):
        raise ValueError("fft length must be a power of two")
    ev = sess.ev
    dev = ct.data.device
    ct = ct.with_(data=ct.data[_reversal_index(n, dev)])
    m = 2
    while m <= n:
        # one batched plaintext multiply: odd positions × twiddle, even × 1
        # (the even×1 keeps levels aligned, reference he_fft.cpp:46-47);
        # the stacked plaintext is built once per (n, stage, level)
        key = ("fft_stage", n, m, inverse, m == n, ct.level)
        pt = sess._pt_cache.get(key)
        if pt is None:
            tw = _stage_arrays(n, m, inverse, last=(m == n))[0]
            pts = [sess.encode(tw[i], level=ct.level) for i in range(n)]
            pt = Plaintext(data=torch.stack([p.data for p in pts]),
                           shoup=torch.stack([p.shoup for p in pts]),
                           level=ct.level, scale=pts[0].scale)
            sess._pt_cache[key] = pt
        twisted = ev.rescale(ev.multiply_plain(ct, pt))
        d = twisted.data
        q = sess.ctx.mont(twisted.level)["q"]
        iu, iv, mask = _stage_index(n, m, dev)
        du, dv = d[iu], d[iv]
        ct = twisted.with_(data=torch.where(mask, mod_add(du, dv, q),
                                            mod_sub(du, dv, q)))
        m *= 2
    return ct


def ifft(sess: Session, ct: Ciphertext) -> Ciphertext:
    return fft(sess, ct, inverse=True)


# ======================================================================
# batched (in-slot) FFT
# ======================================================================

def _bfft_masks(n: int, h: int, inverse: bool, last: bool, tile: int):
    """The three diagonal masks for one stage (forward: DIF; inverse: DIT),
    tiled to `tile` slots.  Returns (D0, D1, D2) complex vectors; D2 None
    when mergeable (h == n/2 with a ×2-tiled layout)."""
    sign = 1.0 if inverse else -1.0
    pos = np.arange(n)
    second = (pos % (2 * h)) >= h
    j = (pos - h) % (2 * h)
    if not inverse:
        stride = n // (2 * h)
        w = np.exp(sign * 2j * np.pi * (j * stride) / n)
        D0 = np.where(second, -w, 1.0).astype(np.complex128)
        D1 = np.where(second, 0.0, 1.0).astype(np.complex128)
        D2 = np.where(second, w, 0.0).astype(np.complex128)
    else:
        stride = n // (2 * h)
        jj = pos % (2 * h)
        w = np.exp(sign * 2j * np.pi * ((jj % h) * stride) / n)
        D0 = np.where(second, -w, 1.0).astype(np.complex128)
        D1 = np.where(second, 0.0, w).astype(np.complex128)
        D2 = np.where(second, 1.0, 0.0).astype(np.complex128)
    if inverse and last:
        D0, D1, D2 = D0 / n, D1 / n, D2 / n
    if tile % n:
        raise ValueError("bfft needs slot_count divisible by n (tiled input)")
    reps = tile // n
    D0, D1, D2 = (np.tile(D, reps) for D in (D0, D1, D2))
    if 2 * h == n:
        # rot(x,-h) == rot(x,+h) on an n-periodic layout: fold D2 into D1
        D1 = D1 + D2
        D2 = None
    return D0, D1, D2


def bfft(sess: Session, ct: Ciphertext, n: int,
         inverse: bool = False) -> Ciphertext:
    """In-slot DFT of an n-point signal tiled across the slots.  Input in
    natural order; output BIT-REVERSED (forward), as the reference's
    ``bfft``.  For ``inverse=True`` the input must be bit-reversed and the
    output is natural (the exact inverse of the forward pass)."""
    if n & (n - 1):
        raise ValueError("bfft length must be a power of two")
    ev, gk = sess.ev, sess.gk
    hs = [n >> (s + 1) for s in range(n.bit_length() - 1)]   # n/2 … 1
    if inverse:
        hs = hs[::-1]
    for h in hs:
        last = h == (1 if not inverse else n // 2)
        D0, D1, D2 = _bfft_masks(n, h, inverse, last, sess.slots)
        steps = [h] if D2 is None else [h, -h]
        rots = ev.rotate_hoisted(ct, steps, gk)
        with span("fft.masks"):
            pairs = [(src, sess.cached_encode(
                          ("bfft_mask", n, h, inverse, last, di), D,
                          level=src.level))
                     for di, (D, src) in enumerate(zip((D0, D1, D2),
                                                       [ct] + rots))
                     if D is not None]
            acc = ev.multiply_plain_sum(pairs)
            if profiler_on():
                planes = acc.data[..., 0].numel()
                mask_bytes["bfft"] += cuda_lib.plane_bytes(
                    acc.data.shape[-1], (len(pairs) + 1) * planes,
                    len(pairs) * acc.data.shape[-2])
        with span("fft.rescale"):
            ct = ev.rescale(acc)
    return ct


def ibfft(sess: Session, ct: Ciphertext, n: int) -> Ciphertext:
    return bfft(sess, ct, n, inverse=True)
