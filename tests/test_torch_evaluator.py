"""The rest of the port's evaluator against hetpu's jitted Evaluator, bit for
bit, on test_dnum (N=2^10, 8 data primes, α=3 → J=3 key-switch digits):

  * negate, add/sub (with part padding), add_plain, sub_plain,
    multiply_plain, mod_switch, mod_switch_to, rescale,
    multiply_plain_rescale;
  * relinearize of a 3-part and of a 4-part ciphertext
    (``create_relin_keys(count=2)``);
  * rotate with a key and by a step that needs the greedy power-of-two
    chain, conjugate, rotate_hoisted (batch of 2);
  * golden_pins ``fused_rot`` and golden_tiny ``rs_tiny`` (bigint-made);
  * the Session helpers (from_wire, with_secret, cached_encode, const_like,
    chain_index, drop_level, reach_level, align, the mat_* protocol).
Inputs are hetpu ciphertexts carried over with hetpu_torch.convert; the
port's keys are its own (equal to hetpu's, tests/test_torch_slice.py).
"""

import pathlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core.keys import KeyGenerator as RefKeyGenerator
from hetpu.session import Session as RefSession
from hetpu_torch import convert
from hetpu_torch.core import evaluator
from hetpu_torch.core.context import Context
from hetpu_torch.core.keys import KeyGenerator
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.ntt import ntt_fwd_mont, ntt_inv
from hetpu_torch.core.params import preset
from hetpu_torch.session import Session

torch.set_num_threads(1)

GOLD = pathlib.Path(__file__).parent / "golden"
SEED = b"\x33" * 32
STEPS = [1, 2, 5]


@pytest.fixture(scope="module")
def env():
    ref = RefSession.create("test_dnum", seed=SEED, galois_steps=STEPS)
    port = Session.create("test_dnum", seed=SEED, galois_steps=STEPS,
                          device="cpu")
    rng = np.random.default_rng(12)
    vals = rng.uniform(-1, 1, (3, port.slots))
    rcts = [ref.encryptor.encrypt(ref.encode(v), seed=bytes([0x50 + i]) * 32)
            for i, v in enumerate(vals)]
    rbatch = rcts[0].with_(data=jnp.stack([rcts[0].data, rcts[1].data]))
    return ref, port, vals, rcts, rbatch


def _pc(ct):
    return convert.ciphertext(ct, "cpu")


def _eq(got, want, msg=""):
    assert (got.level, got.scale) == (want.level, want.scale), msg
    np.testing.assert_array_equal(to_u32(got.data), np.asarray(want.data),
                                  err_msg=msg)


def test_linear_ops(env):
    ref, port, _, rcts, _ = env
    a, b = rcts[0], rcts[1]
    pa, pb = _pc(a), _pc(b)
    _eq(port.ev.negate(pa), ref.ev.negate(a), "negate")
    _eq(port.ev.add(pa, pb), ref.ev.add(a, b), "add")
    _eq(port.ev.sub(pa, pb), ref.ev.sub(a, b), "sub")
    a3 = ref.ev.multiply(a, b).with_(scale=a.scale)  # the residues matter
    _eq(port.ev.add(_pc(a3), pb), ref.ev.add(a3, b), "add 3+2 parts")
    _eq(port.ev.sub(pa, _pc(a3)), ref.ev.sub(a, a3), "sub 2-3 parts")
    with pytest.raises(ValueError, match="level"):
        port.ev.add(pa, port.ev.mod_switch(pb))


def test_plain_ops(env):
    ref, port, vals, rcts, _ = env
    a = rcts[0]
    pt = ref.encode(vals[2], level=a.level, scale=a.scale)
    ppt = convert.plaintext(pt, "cpu")
    _eq(port.ev.add_plain(_pc(a), ppt), ref.ev.add_plain(a, pt), "add_plain")
    _eq(port.ev.sub_plain(_pc(a), ppt), ref.ev.sub_plain(a, pt), "sub_plain")
    _eq(port.ev.multiply_plain(_pc(a), ppt), ref.ev.multiply_plain(a, pt),
        "multiply_plain")
    _eq(port.ev.multiply_plain_rescale(_pc(a), ppt),
        ref.ev.multiply_plain_rescale(a, pt), "multiply_plain_rescale")


def test_chain_ops(env):
    ref, port, _, rcts, rbatch = env
    a = rcts[0]
    _eq(port.ev.rescale(_pc(rbatch)), ref.ev.rescale(rbatch), "rescale")
    _eq(port.ev.mod_switch(_pc(a)), ref.ev.mod_switch(a), "mod_switch")
    _eq(port.ev.mod_switch_to(_pc(a), 4), ref.ev.mod_switch_to(a, 4),
        "mod_switch_to")


def test_rescale_golden_tiny():
    """golden_tiny rs_tiny, fed as tests/test_golden.py:_check_rescale."""
    z = np.load(GOLD / "golden_tiny.npz")
    ctx = Context(preset("test_tiny"), "cpu")
    assert tuple(ctx.params.moduli[:3]) == tuple(int(p) for p in
                                                 z["rs_tiny_primes"])
    x_m = ntt_fwd_mont(from_u32(z["rs_tiny_x"]), ctx.tables(2))
    out_m = evaluator._div_round_last(x_m, ctx.rescale_plan(2))
    out = ntt_inv(out_m, ctx.tables(1), strip_mont=True)
    np.testing.assert_array_equal(to_u32(out), z["rs_tiny_out"])


def test_relinearize_3_and_4_parts(env):
    ref, _, _, rcts, _ = env
    a, b = rcts[0], rcts[1]
    rkg = RefKeyGenerator(ref.ctx, seed=SEED)
    rkg.create_public_key()
    rrk = rkg.create_relin_keys(count=2)
    ctx = Context(preset("test_dnum"), "cpu")
    kg = KeyGenerator(ctx, seed=SEED)
    kg.create_public_key()
    rk = kg.create_relin_keys(count=2)
    for k, rk_ in zip((rk.key, *rk.more), (rrk.key, *rrk.more), strict=True):
        np.testing.assert_array_equal(to_u32(k.data), np.asarray(rk_.data))
    ev = evaluator.Evaluator(ctx)
    c3 = ref.ev.multiply(a, b)
    c4 = ref.ev.multiply(c3, a)
    _eq(ev.relinearize(_pc(c3), rk), ref.ev.relinearize(c3, rrk), "3 parts")
    _eq(ev.relinearize(_pc(c4), rk), ref.ev.relinearize(c4, rrk), "4 parts")
    with pytest.raises(KeyError):
        ev.relinearize(_pc(ref.ev.multiply(c4, a)), rk)


@pytest.mark.parametrize("steps", [1, 3, -511])
def test_rotate(env, steps):
    """1 has a key; 3 = 2 + 1 and −511 ≡ 1 take the key path or the
    greedy chain."""
    ref, port, _, _, rbatch = env
    _eq(port.ev.rotate(_pc(rbatch), steps, port.gk),
        ref.ev.rotate(rbatch, steps, ref.gk), f"rotate {steps}")


def test_rotate_missing_key_raises(env):
    _, port, _, rcts, _ = env
    sess = Session.create("test_dnum", seed=SEED, galois_steps=[2],
                          device="cpu")
    with pytest.raises(KeyError):
        sess.ev.rotate(_pc(rcts[0]), 1, sess.gk)


def test_conjugate_and_hoisted(env):
    ref, port, _, _, rbatch = env
    _eq(port.ev.conjugate(_pc(rbatch), port.gk),
        ref.ev.conjugate(rbatch, ref.gk), "conjugate")
    steps = [0, 1, 2, 5]
    got = port.ev.rotate_hoisted(_pc(rbatch), steps, port.gk)
    want = ref.ev.rotate_hoisted(rbatch, steps, ref.gk)
    for s, g, w in zip(steps, got, want, strict=True):
        _eq(g, w, f"rotate_hoisted {s}")


def test_fused_rot_golden():
    """golden_pins fused_rot: rotate(multiply_relin_rescale(a, b), 1) under
    the pinned key seed (tests/test_golden.py:99-100)."""
    z = np.load(GOLD / "golden_pins.npz")
    sess = Session.create("test_dnum", seed=SEED, galois_steps=[1],
                          device="cpu")
    proto = sess.encrypt(0.0)
    a = proto.with_(data=from_u32(z["fused_a"]))
    b = proto.with_(data=from_u32(z["fused_b"]))
    out = sess.ev.multiply_relin_rescale(a, b, sess.rk)
    np.testing.assert_array_equal(to_u32(out.data), z["fused_out"])
    rot = sess.ev.rotate(out, 1, sess.gk)
    np.testing.assert_array_equal(to_u32(rot.data), z["fused_rot"])


def test_session_helpers(env):
    ref, port, vals, rcts, _ = env
    a, b = rcts[0], rcts[1]
    pa, pb = _pc(a), _pc(b)
    assert port.chain_index(pa) == ref.chain_index(a) == a.level
    calls = []
    pt = port.cached_encode("k", lambda: calls.append(1) or vals[0])
    assert port.cached_encode("k", lambda: calls.append(1)) is pt
    assert calls == [1]
    np.testing.assert_array_equal(
        to_u32(pt.data), np.asarray(ref.cached_encode("k", vals[0]).data))
    np.testing.assert_array_equal(to_u32(port.const_like(pa, 0.25).data),
                                  np.asarray(ref.const_like(a, 0.25).data))
    _eq(port.drop_level(pa), ref.drop_level(a), "drop_level")
    _eq(port.reach_level(pa, 4), ref.reach_level(a, 4), "reach_level")
    low = ref.reach_level(b, 5)
    for g, w in zip(port.align(pa, _pc(low)), ref.align(a, low), strict=True):
        _eq(g, w, "align")
    c3 = ref.mat_multiply(a, b)
    _eq(port.mat_multiply(pa, pb), c3, "mat_multiply")
    _eq(port.mat_reduce_finish(_pc(c3)), ref.mat_reduce_finish(c3),
        "mat_reduce_finish")
    _eq(port.mat_mult_finish(pa, pb), ref.mat_mult_finish(a, b),
        "mat_mult_finish")


def test_from_wire_and_without_secret(env):
    ref, port, _, rcts, _ = env
    assert Session.create("test_tiny", seed=SEED, galois_steps=[],
                          with_secret=False, device="cpu").decryptor is None
    wire = Session.from_wire(ref.ctx.params,
                             convert.relin_keys(ref.rk, "cpu"),
                             convert.galois_keys(ref.gk, "cpu"), device="cpu")
    assert wire.encryptor is None and wire.decryptor is None
    a = rcts[0]
    _eq(wire.ev.rotate(_pc(a), 1, wire.gk), ref.ev.rotate(a, 1, ref.gk),
        "from_wire rotate")
    _eq(wire.mat_mult_finish(_pc(a), _pc(a)), ref.mat_mult_finish(a, a),
        "from_wire multiply")
