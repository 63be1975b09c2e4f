"""Encrypted FFT demos (reference ``src/demos/fft.cpp``; counterpart of
``hetpu/demos/fft.py``): ``fft`` = 128 coefficient ciphertexts (the slots
batch N/2 signals), ``bfft`` = 128 points in-slot."""

from __future__ import annotations

import numpy as np
import torch

from .. import fft as hefft
from ..session import Session
from ..utils.timer import Timer


def demo_fft(small=False, device="cuda"):
    n = 16 if small else 128
    # full size: scale-2^55 pair-rescale precision (above the reference's 2^40)
    sess = Session.create("test_deep" if small else "ckks_fft_hi",
                          galois_steps=[1], device=device)
    rng = np.random.default_rng(0)
    sig = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    t = Timer()
    cts = [sess.encrypt(c) for c in sig]
    ct = cts[0].with_(data=torch.stack([c.data for c in cts]))
    t.toc("encrypt time", block_on=ct.data)
    t = Timer()
    out = hefft.fft(sess, ct)
    t.toc("HE FFT time", block_on=out.data)
    got = np.array([sess.decrypt(out.with_(data=out.data[i]))[0]
                    for i in range(n)])
    want = np.fft.fft(sig)
    err = np.abs(got - want).max()
    print(f"n={n} max err =", err)
    print("spectrum[:4] =", got[:4])
    if not small:
        assert err < 2 ** -10, f"fft error {err} above 2^-10"


def demo_bfft(small=False, device="cuda"):
    n = 16 if small else 128
    sess = Session.create(
        "test_deep" if small else "ckks_fft_hi",
        galois_steps=sorted({s for h in
                             [n >> (i + 1) for i in range(n.bit_length() - 1)]
                             for s in (h, -h)}), device=device)
    rng = np.random.default_rng(0)
    sig = rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)
    ct = sess.encrypt(np.tile(sig, sess.slots // n))
    t = Timer()
    out = hefft.bfft(sess, ct, n)
    t.toc("HE bFFT time", block_on=out.data)
    # un-reverse at decode (reference fft.cpp:224-238)
    got = sess.decrypt(out)[:n]
    want = hefft.bit_reverse_order(np.fft.fft(sig))
    err = np.abs(got - want).max()
    print(f"n={n} max err =", err)
    if not small:
        assert err < 2 ** -10, f"bfft error {err} above 2^-10"


DEMOS = {"fft": demo_fft, "bfft": demo_bfft}
