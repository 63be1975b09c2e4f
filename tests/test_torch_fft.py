"""The port's encrypted DFTs (``hetpu_torch.fft``) against hetpu's on the
CPU at test_deep, bit for bit on the ciphertext residues: ``fft`` /
``ifft`` over a batch of 4 coefficient ciphertexts, ``bfft`` / ``ibfft``
of a 4-point signal tiled over the slots (its first stage merges the ±2
rotations), each hetpu result computed once, and the decrypts against
``numpy.fft`` with tests/test_fft.py's bound (1e-3).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu import fft as ref_fft
from hetpu.session import Session as RefSession
from hetpu_torch import convert
from hetpu_torch import fft as port_fft
from hetpu_torch.session import Session
from torch_app_cases import assert_same, encrypt_pair

SEED = b"\x04" * 32
N_FFT = 4


@pytest.fixture(scope="module")
def env():
    steps = [1, -1, 2, -2]
    ref = RefSession.create("test_deep", seed=SEED, galois_steps=steps)
    port = Session.create("test_deep", seed=SEED, galois_steps=steps,
                          device="cpu")
    rng = np.random.default_rng(21)
    sig = rng.uniform(-1, 1, N_FFT) + 1j * rng.uniform(-1, 1, N_FFT)
    cts = [ref.encryptor.encrypt(ref.encode(c), seed=bytes([0x30 + i]) * 32)
           for i, c in enumerate(sig)]
    rbatch = cts[0].with_(data=jnp.stack([c.data for c in cts]))
    rtile, ptile = encrypt_pair(ref, np.tile(sig, port.slots // N_FFT),
                                b"\x3f" * 32)
    ref_out = {}
    ref_out["fft"] = ref_fft.fft(ref, rbatch)
    ref_out["ifft"] = ref_fft.ifft(ref, ref_out["fft"])
    ref_out["bfft"] = ref_fft.bfft(ref, rtile, N_FFT)
    ref_out["ibfft"] = ref_fft.ibfft(ref, ref_out["bfft"], N_FFT)
    return port, sig, convert.ciphertext(rbatch, "cpu"), ptile, ref_out


def _coeffs(sess, ct):
    return np.array([sess.decrypt(ct.with_(data=ct.data[i]))[0]
                     for i in range(ct.data.shape[0])])


def test_bit_reverse_order():
    x = np.arange(16)
    assert list(port_fft.bit_reverse_order(x)[:4]) == [0, 8, 4, 12]
    np.testing.assert_array_equal(port_fft.bit_reverse_order(x),
                                  ref_fft.bit_reverse_order(x))
    np.testing.assert_array_equal(
        port_fft.bit_reverse_order(port_fft.bit_reverse_order(x)), x)


def test_fft_and_ifft(env):
    port, sig, batch, _, ref_out = env
    fwd = port_fft.fft(port, batch)
    assert_same(fwd, ref_out["fft"])
    np.testing.assert_allclose(_coeffs(port, fwd), np.fft.fft(sig), atol=1e-3)
    back = port_fft.ifft(port, fwd)
    assert_same(back, ref_out["ifft"])
    np.testing.assert_allclose(_coeffs(port, back), sig, atol=1e-3)


def test_fft_stage_plaintexts_are_cached(env):
    """The stacked twiddle plaintext of each stage is built once per
    (n, stage, level) in the session's cache; a second call encodes
    nothing new."""
    port, _, batch, _, _ = env
    port_fft.fft(port, batch)
    keys = [k for k in port._pt_cache if k[0] == "fft_stage" and not k[3]]
    assert [k[2] for k in keys] == [2, 4]
    pt = port._pt_cache[keys[0]]
    assert pt.data.shape[0] == N_FFT
    size = len(port._pt_cache)
    port_fft.fft(port, batch)
    assert len(port._pt_cache) == size
    assert port._pt_cache[keys[0]] is pt


def test_fft_index_tensors_are_cached(env):
    """The bit reversal and each stage's gathers and add/subtract select
    are built on the device once per (n, stage, device): a second call
    builds none, and gives the same residues."""
    port, _, batch, _, _ = env
    first = port_fft.fft(port, batch)
    built = (port_fft._reversal_index.cache_info().misses,
             port_fft._stage_index.cache_info().misses)
    port_fft.fft(port, batch, inverse=True)
    again = port_fft.fft(port, batch)
    assert (port_fft._reversal_index.cache_info().misses,
            port_fft._stage_index.cache_info().misses) == built
    assert torch.equal(first.data, again.data)


def test_bfft_and_ibfft(env):
    """Forward output bit-reversed; the first stage (h = n/2) has two
    masks, the others three."""
    port, sig, _, tile, ref_out = env
    fwd = port_fft.bfft(port, tile, N_FFT)
    assert_same(fwd, ref_out["bfft"])
    np.testing.assert_allclose(port.decrypt(fwd)[:N_FFT],
                               port_fft.bit_reverse_order(np.fft.fft(sig)),
                               atol=1e-3)
    masks = [k[0] for k in port._pt_cache
             if k[0][0] == "bfft_mask" and not k[0][3]]     # forward
    per_stage = {h: sum(m[2] == h for m in masks) for h in (2, 1)}
    assert per_stage == {2: 2, 1: 3}
    back = port_fft.ibfft(port, fwd, N_FFT)
    assert_same(back, ref_out["ibfft"])
    np.testing.assert_allclose(port.decrypt(back)[:N_FFT], sig, atol=1e-3)


def test_fft_refuses_bad_lengths(env):
    port, _, batch, tile, _ = env
    with pytest.raises(ValueError, match="power of two"):
        port_fft.fft(port, batch.with_(data=batch.data[:3]))
    with pytest.raises(ValueError, match="power of two"):
        port_fft.bfft(port, tile, 3)
