"""The wire format of hetpu_torch (core/serial.py) against hetpu's, and the
key cache (utils/keycache.py):

  * for every blob kind — params, CKKS and BFV ciphertexts, the seeded
    (symmetric, compact) ciphertext, plaintext, public key, relin keys
    with ``count`` > 1, galois keys — both packages dump the same object
    (carried with hetpu_torch.convert) to identical bytes, and each loads
    the other's blob to equal residues;
  * a blob of another version, magic or kind is refused;
  * ``cached_session`` round-trips in a private cache directory, and a
    cache file that hetpu's keycache wrote loads in the port to equal keys.
"""

import os
import stat

import numpy as np
import pytest
import torch

from hetpu.bfv import BfvSession as RefBfvSession
from hetpu.core import serial as ref_serial
from hetpu.core.keys import KeyGenerator as RefKeyGenerator
from hetpu.core.params import preset as ref_preset
from hetpu.session import Session as RefSession
from hetpu.utils import keycache as ref_keycache
from hetpu_torch import convert
from hetpu_torch.core import serial
from hetpu_torch.core.context import Context
from hetpu_torch.core.modular import to_u32
from hetpu_torch.core.params import preset
from hetpu_torch.utils import keycache

torch.set_num_threads(1)

SEED = b"\x33" * 32


@pytest.fixture(scope="module")
def env():
    ref = RefSession.create("test_dnum", seed=SEED, galois_steps=[1, 2])
    rkg = RefKeyGenerator(ref.ctx, seed=SEED)
    rkg.create_public_key()
    rrk2 = rkg.create_relin_keys(count=2)
    ctx = Context(preset("test_dnum"), "cpu")
    v = np.random.default_rng(4).uniform(-1, 1, 8)
    ct = ref.encryptor.encrypt(ref.encode(v), seed=b"\x51" * 32)
    sym = ref.encryptor.encrypt_symmetric(ref.encode(v), seed=b"\x52" * 32)
    return ref, rrk2, ctx, ct, sym


def _host(x):
    return to_u32(x) if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    np.testing.assert_array_equal(_host(a), _host(b))


@pytest.mark.parametrize("name", ["test_dnum", "test_bfv_tiny", "ckks_hi",
                                  "test_bfv_crt", "test_bfv_scalar"])
def test_params(name):
    """load_params is hetpu's as it stands: it carries neither the CRT
    factors nor the batching flag (such BFV blobs are refused by both
    packages) nor the rescale group (ckks_hi loads with rescale_group=1 in
    both)."""
    p, rp = preset(name), ref_preset(name)
    blob = ref_serial.dump_params(rp)
    assert serial.dump_params(p) == blob
    if rp.plain_factors or not rp.plain_batching:
        for load in (serial.load_params, ref_serial.load_params):
            with pytest.raises(ValueError, match="plain factors"):
                load(blob)
        return
    want = ref_serial.load_params(blob)
    assert repr(serial.load_params(blob)) == repr(want)
    assert ref_serial.load_params(serial.dump_params(p)) == want


def _ct_eq(got, want):
    assert (got.level, got.scale) == (want.level, want.scale)
    _same(got.data, want.data)


@pytest.mark.parametrize("kind", ["ckks", "ckks_batch", "ckks_3part", "bfv"])
def test_ciphertext(env, kind):
    ref, _, ctx, ct, _ = env
    if kind == "ckks_batch":
        ct = ct.with_(data=np.stack([np.asarray(ct.data)] * 2))
    elif kind == "ckks_3part":
        ct = ref.ev.multiply(ct, ct)
    elif kind == "bfv":
        b = RefBfvSession.create("test_bfv_tiny", seed=SEED, galois_steps=[])
        ct = b.scheme.encrypt(b.encryptor, b.encode(np.arange(16)),
                              seed=b"\x53" * 32)
        ctx = Context(b.ctx.params, "cpu")
    pct = convert.ciphertext(ct, "cpu")
    blob = ref_serial.dump_ciphertext(ct)
    assert serial.dump_ciphertext(pct) == blob
    _ct_eq(serial.load_ciphertext(blob, ctx), ct)
    back = ref_serial.load_ciphertext(serial.dump_ciphertext(pct), ref.ctx)
    _ct_eq(pct, back)


def test_seeded_ciphertext(env):
    """The compact symmetric form: c0 and the seed; the loader re-expands
    `a` from the seed on either side."""
    ref, _, ctx, _, sym = env
    seed = b"\x52" * 32
    psym = convert.ciphertext(sym, "cpu")
    blob = ref_serial.dump_ciphertext(sym, seed=seed)
    assert serial.dump_ciphertext(psym, seed=seed) == blob
    assert len(blob) < len(ref_serial.dump_ciphertext(sym)) * 0.6
    _ct_eq(serial.load_ciphertext(blob, ctx), sym)
    _ct_eq(psym, ref_serial.load_ciphertext(
        serial.dump_ciphertext(psym, seed=seed), ref.ctx))
    with pytest.raises(ValueError, match="2-part"):
        serial.dump_ciphertext(psym.with_(data=psym.data[:1]), seed=seed)


def test_plaintext(env):
    ref, *_ = env
    pt = ref.encode(np.arange(8) / 8.0)
    ppt = convert.plaintext(pt, "cpu")
    blob = ref_serial.dump_plaintext(pt)
    assert serial.dump_plaintext(ppt) == blob
    got = serial.load_plaintext(blob, "cpu")
    assert (got.level, got.scale) == (pt.level, pt.scale)
    _same(got.data, pt.data)
    _same(got.shoup, pt.shoup)
    back = ref_serial.load_plaintext(serial.dump_plaintext(ppt))
    _same(ppt.shoup, back.shoup)


def test_public_key(env):
    ref, *_ = env
    pk = convert.public_key(ref.encryptor.pk, "cpu")
    blob = ref_serial.dump_public_key(ref.encryptor.pk)
    assert serial.dump_public_key(pk) == blob
    _same(serial.load_public_key(blob, "cpu").data, ref.encryptor.pk.data)
    _same(pk.data, ref_serial.load_public_key(serial.dump_public_key(pk)).data)


def _ksk_eq(got, want):
    _same(got.data, want.data)
    _same(got.shoup, want.shoup)


def test_relin_keys_count_2(env):
    ref, rrk2, ctx, _, _ = env
    prk = convert.relin_keys(rrk2, "cpu")
    blob = ref_serial.dump_relin_keys(rrk2)
    assert serial.dump_relin_keys(prk) == blob
    got = serial.load_relin_keys(blob, ctx)
    assert len(got.more) == 1
    for g, w in zip((got.key, *got.more), (rrk2.key, *rrk2.more), strict=True):
        _ksk_eq(g, w)
    back = ref_serial.load_relin_keys(serial.dump_relin_keys(prk), ref.ctx)
    for g, w in zip((prk.key, *prk.more), (back.key, *back.more), strict=True):
        _ksk_eq(g, w)


def test_galois_keys(env):
    ref, _, ctx, _, _ = env
    pgk = convert.galois_keys(ref.gk, "cpu")
    blob = ref_serial.dump_galois_keys(ref.gk)
    assert serial.dump_galois_keys(pgk) == blob
    got = serial.load_galois_keys(blob, ctx)
    assert got.elts == tuple(ref.gk.elts)
    for g, w in zip(got.keys, ref.gk.keys, strict=True):
        _ksk_eq(g, w)
    back = ref_serial.load_galois_keys(serial.dump_galois_keys(pgk), ref.ctx)
    for g, w in zip(pgk.keys, back.keys, strict=True):
        _ksk_eq(g, w)


def test_bad_blobs_refused(env):
    ref, _, ctx, ct, _ = env
    blob = serial.dump_ciphertext(convert.ciphertext(ct, "cpu"))
    for ver in (1, 3):
        with pytest.raises(ValueError, match="version"):
            serial.load_ciphertext(blob[:5] + bytes([ver]) + blob[6:], ctx)
    with pytest.raises(ValueError, match="magic"):
        serial.load_ciphertext(b"HETPX" + blob[5:], ctx)
    with pytest.raises(ValueError, match="not a"):
        serial.load_relin_keys(blob, ctx)
    with pytest.raises(ValueError, match="not a"):
        serial.load_params(blob)
    with pytest.raises(ValueError, match="not a"):
        serial.load_ciphertext(serial.dump_params(ctx.params), ctx)


def _keys_eq(sess, rsess):
    _same(sess.decryptor.sk.data, rsess.decryptor.sk.data)
    _same(sess.encryptor.pk.data, rsess.encryptor.pk.data)
    _ksk_eq(sess.rk.key, rsess.rk.key)
    assert sess.gk.elts == tuple(rsess.gk.elts)
    for g, w in zip(sess.gk.keys, rsess.gk.keys, strict=True):
        _ksk_eq(g, w)


def test_cached_session_roundtrip(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setattr(keycache, "CACHE_DIR", cache)
    seed = b"\x44" * 32
    first = keycache.cached_session("test_tiny", seed=seed, galois_steps=[1],
                                    device="cpu")
    files = list(cache.iterdir())
    assert len(files) == 1
    assert stat.S_IMODE(os.stat(cache).st_mode) == 0o700
    assert stat.S_IMODE(os.stat(files[0]).st_mode) == 0o600
    mtime = files[0].stat().st_mtime_ns
    again = keycache.cached_session("test_tiny", seed=seed, galois_steps=[1],
                                    device="cpu")
    assert files[0].stat().st_mtime_ns == mtime          # loaded, not rebuilt
    assert again.ctx.device.type == "cpu"
    _keys_eq(again, first)
    ct = again.encrypt(0.25, seed=b"\x01" * 32)
    assert abs(first.decrypt(again.ev.multiply_relin_rescale(
        ct, ct, again.rk)).real - 0.0625).max() < 1e-3


def test_cache_written_by_hetpu_loads(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_keycache, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path)
    seed = b"\x45" * 32
    rsess = ref_keycache.cached_session("test_tiny", seed=seed,
                                        galois_steps=[1])
    (path,) = tmp_path.iterdir()
    mtime = path.stat().st_mtime_ns
    sess = keycache.cached_session("test_tiny", seed=seed, galois_steps=[1],
                                   device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [path.name]
    assert path.stat().st_mtime_ns == mtime               # same tag, loaded
    _keys_eq(sess, rsess)
    assert keycache.cached_session.__kwdefaults__["device"] == "cuda"
