"""The port's main path as a whole against hetpu, on test_dnum (N=2^10,
8 data primes, α=3 → J=3 key-switch digits):

  * Session.create with the pinned seed gives sk, pk, relin and galois
    keys (data and Shoup companions) equal to hetpu's;
  * multiply_relin_rescale on golden_pins fused_a/fused_b equals
    fused_out (bigint-generated) and hetpu's output; so does
    square_relin_rescale, and a batch equals its rows;
  * encode and seeded public / symmetric encryption equal hetpu's;
  * decrypt matches hetpu's to 1e-9 (same float64 FFT);
  * the op on hetpu's own keys and ciphertexts carried over by
    hetpu_torch.convert gives hetpu's output.
"""

import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.session import Session as RefSession
from hetpu_torch import convert
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.session import Session

torch.set_num_threads(1)

GOLD = pathlib.Path(__file__).parent / "golden"
SEED = b"\x33" * 32


@pytest.fixture(scope="module")
def sessions():
    ref = RefSession.create("test_dnum", seed=SEED, galois_steps=[1])
    port = Session.create("test_dnum", seed=SEED, galois_steps=[1],
                          device="cpu")
    return ref, port


@pytest.fixture(scope="module")
def pins():
    return np.load(GOLD / "golden_pins.npz")


def _eq(t, arr, msg=""):
    np.testing.assert_array_equal(to_u32(t), np.asarray(arr), err_msg=msg)


def test_keys_equal(sessions):
    ref, port = sessions
    _eq(port.encryptor.sk.data, ref.encryptor.sk.data, "sk")
    _eq(port.encryptor.pk.data, ref.encryptor.pk.data, "pk")
    _eq(port.rk.key.data, ref.rk.key.data, "rk data")
    _eq(port.rk.key.shoup, ref.rk.key.shoup, "rk shoup")
    assert port.gk.elts == ref.gk.elts
    for k, rk_ in zip(port.gk.keys, ref.gk.keys, strict=True):
        _eq(k.data, rk_.data, "gk data")
        _eq(k.shoup, rk_.shoup, "gk shoup")


@pytest.fixture(scope="module")
def fused_out(sessions, pins):
    ref, port = sessions
    proto = ref.encrypt(0.0)
    a = proto.with_(data=jnp.asarray(pins["fused_a"]))
    b = proto.with_(data=jnp.asarray(pins["fused_b"]))
    ref_out = ref.ev.multiply_relin_rescale(a, b, ref.rk)
    pa, pb = convert.ciphertext(a, "cpu"), convert.ciphertext(b, "cpu")
    return ref_out, port.ev.multiply_relin_rescale(pa, pb, port.rk), pa, pb


def test_multiply_relin_rescale_golden(fused_out, pins):
    ref_out, out, _, _ = fused_out
    assert (out.level, out.scale) == (ref_out.level, ref_out.scale)
    _eq(out.data, pins["fused_out"], "fused_out")
    _eq(out.data, ref_out.data, "hetpu output")


def test_batch_equals_rows(sessions, fused_out):
    _, port = sessions
    _, out, pa, pb = fused_out
    swapped = port.ev.multiply_relin_rescale(pb, pa, port.rk)
    assert torch.equal(swapped.data, out.data)        # ct·ct commutes
    ba = pa.with_(data=torch.stack([pa.data, pb.data]))
    bb = pb.with_(data=torch.stack([pb.data, pb.data]))
    batch = port.ev.multiply_relin_rescale(ba, bb, port.rk)
    row1 = port.ev.multiply_relin_rescale(pb, pb, port.rk)
    assert torch.equal(batch.data[0], out.data)
    assert torch.equal(batch.data[1], row1.data)


def test_square_relin_rescale(sessions, fused_out):
    ref, port = sessions
    _, _, pa, _ = fused_out
    proto = ref.encrypt(0.0)
    a = proto.with_(data=jnp.asarray(to_u32(pa.data)))
    want = ref.ev.square_relin_rescale(a, ref.rk)
    got = port.ev.square_relin_rescale(pa, port.rk)
    _eq(got.data, want.data)
    assert torch.equal(got.data,
                       port.ev.multiply_relin_rescale(pa, pa, port.rk).data)


@pytest.fixture(scope="module")
def encrypted(sessions):
    ref, port = sessions
    rng = np.random.default_rng(5)
    x = rng.uniform(-1, 1, port.slots)
    y = rng.uniform(-1, 1, port.slots)
    seeds = (b"\x41" * 32, b"\x42" * 32)
    ref_cts = [ref.encryptor.encrypt(ref.encode(v), seed=s)
               for v, s in zip((x, y), seeds)]
    cts = [port.encrypt(v, seed=s) for v, s in zip((x, y), seeds)]
    return x, y, ref_cts, cts


def test_encode_equal(sessions):
    ref, port = sessions
    v = np.random.default_rng(6).uniform(-1, 1, port.slots)
    for lvl in (7, 3):
        rp, pp = ref.encode(v, level=lvl), port.encode(v, level=lvl)
        _eq(pp.data, rp.data, "plaintext")
        _eq(pp.shoup, rp.shoup, "plaintext shoup")


def test_encrypt_equal(encrypted):
    _, _, ref_cts, cts = encrypted
    for rc, c in zip(ref_cts, cts):
        assert (c.level, c.scale) == (rc.level, rc.scale)
        _eq(c.data, rc.data, "public-key ciphertext")


def test_encrypt_symmetric_equal(sessions):
    ref, port = sessions
    v = np.random.default_rng(8).uniform(-1, 1, port.slots)
    seed = b"\x43" * 32
    want = ref.encryptor.encrypt_symmetric(ref.encode(v), seed=seed)
    got = port.encryptor.encrypt_symmetric(port.encode(v), seed=seed)
    _eq(got.data, want.data, "symmetric ciphertext")


def test_decrypt_matches(sessions, encrypted):
    ref, port = sessions
    x, y, ref_cts, cts = encrypted
    ref_out = ref.ev.multiply_relin_rescale(*ref_cts, ref.rk)
    out = port.ev.multiply_relin_rescale(*cts, port.rk)
    _eq(out.data, ref_out.data)
    for rc, c in ((ref_cts[0], cts[0]), (ref_out, out)):
        np.testing.assert_array_equal(port.decryptor.decrypt_to_coeffs(c),
                                      ref.decryptor.decrypt_to_coeffs(rc))
        got, want = port.decrypt(c), ref.decrypt(rc)
        assert np.abs(got - want).max() <= 1e-9
    assert np.abs(port.decrypt(out).real - x * y).max() < 1e-3


def test_op_on_converted_hetpu_state(sessions, encrypted):
    """hetpu's keys and ciphertexts, carried over by convert, through the
    port's evaluator on a fresh context give hetpu's output bit for bit."""
    ref, _ = sessions
    _, _, ref_cts, _ = encrypted
    ref_out = ref.ev.multiply_relin_rescale(*ref_cts, ref.rk)
    ev = Evaluator(Context(ref.ctx.params, "cpu"))
    rk = convert.relin_keys(ref.rk, "cpu")
    out = ev.multiply_relin_rescale(*(convert.ciphertext(c, "cpu") for c in ref_cts),
                                    rk)
    _eq(out.data, ref_out.data)
    sk = convert.secret_key(ref.encryptor.sk, "cpu")
    _eq(sk.data, ref.encryptor.sk.data)
    _eq(convert.public_key(ref.encryptor.pk, "cpu").data, ref.encryptor.pk.data)
    assert torch.equal(from_u32(np.asarray(ref.rk.key.shoup)), rk.key.shoup)
