"""The paired-prime rescale (rescale_group=2) of hetpu_torch against hetpu's,
bit for bit, on test_hi (N=2^10, 2 anchor primes + 3 pairs, scale ≈ 2^44):

  * ``Context.group_rescale_plan`` field by field at every level it takes;
  * the standalone ``Evaluator.rescale`` (the pair's centered-FBC divide),
    the fused ``multiply_relin_rescale`` / ``square_relin_rescale`` (the
    pair and the specials in one divide), the depth-3 squaring chain down
    to the anchors, ``Session.drop_level`` and rotation — with the default
    FBC and with ``centered_fbc=True`` against hetpu under
    ``HETPU_MXU_FBC=1`` (a fresh hetpu evaluator, as in test_torch_infer);
  * the decrypts within tests/test_hiprec.py's bounds.

test_hi's prime-pair search takes about a minute, so it runs once here:
the port's parameters are made from the reference's fields.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core.evaluator import Evaluator as RefEvaluator
from hetpu.core.params import preset as ref_preset
from hetpu.session import Session as RefSession
from hetpu_torch import convert
from hetpu_torch.core.modular import to_u32
from hetpu_torch.core.params import HeParams, Scheme
from hetpu_torch.session import Session

torch.set_num_threads(1)

SEED = b"\x42" * 32
STEPS = [1, 2]


@pytest.fixture(scope="module")
def env():
    rp = ref_preset("test_hi")
    fields = {f.name: getattr(rp, f.name) for f in dataclasses.fields(rp)}
    params = HeParams(**{**fields, "scheme": Scheme(rp.scheme.value)})
    ref = RefSession.create(rp, seed=SEED, galois_steps=STEPS)
    rng = np.random.default_rng(1234)
    vals = rng.uniform(-1, 1, (3, 1 << 9))
    cts = [ref.encryptor.encrypt(ref.encode(v), seed=bytes([0x70 + i]) * 32)
           for i, v in enumerate(vals)]
    batch = cts[0].with_(data=jnp.stack([cts[0].data, cts[1].data]))
    return params, ref, vals, cts, batch


def _modes(env, centered, monkeypatch):
    """(hetpu session, port session) for one FBC mode."""
    params, ref, *_ = env
    if centered:
        monkeypatch.setenv("HETPU_MXU_FBC", "1")
    ref = dataclasses.replace(ref, ev=RefEvaluator(ref.ctx), _pt_cache={})
    port = Session.create(params, seed=SEED, galois_steps=STEPS, device="cpu",
                          centered_fbc=centered)
    return ref, port


def _pc(ct):
    return convert.ciphertext(ct, "cpu")


def _eq(got, want, msg=""):
    assert (got.level, got.scale) == (want.level, want.scale), msg
    np.testing.assert_array_equal(to_u32(got.data), np.asarray(want.data),
                                  err_msg=msg)


def test_params_and_plans(env):
    params, ref, *_ = env
    assert dataclasses.asdict(params) == {
        **dataclasses.asdict(ref.ctx.params), "scheme": Scheme.CKKS}
    assert params.rescale_group == 2 and params.num_anchor == 2
    port = Session.create(params, seed=SEED, galois_steps=STEPS, device="cpu")
    for lvl in range(params.num_anchor + 1, len(params.moduli)):
        got = port.ctx.group_rescale_plan(lvl)
        want = ref.ctx.group_rescale_plan(lvl)
        assert got.src_tables.primes == tuple(want.src_tables.primes)
        assert got.dst_tables.primes == tuple(want.dst_tables.primes)
        for f in dataclasses.fields(want.fbc):
            g, w = getattr(got.fbc, f.name), np.asarray(getattr(want.fbc,
                                                                f.name))
            if g.dtype == torch.float32:          # p_recip, the two-float
                np.testing.assert_array_equal(g.numpy(),
                                              w.astype(np.float32))
            else:
                np.testing.assert_array_equal(to_u32(g), w, err_msg=f.name)
        for f in ("p_inv", "p_inv_shoup"):
            np.testing.assert_array_equal(to_u32(getattr(got, f)),
                                          getattr(want, f))
    with pytest.raises(ValueError, match="anchor"):
        port.ctx.group_rescale_plan(params.num_anchor)
    # the keys of one seed are equal
    np.testing.assert_array_equal(to_u32(port.rk.key.data),
                                  np.asarray(ref.rk.key.data))


@pytest.mark.parametrize("centered", [False, True])
def test_rescale_pair_and_fused(env, centered, monkeypatch):
    _, _, vals, cts, batch = env
    ref, port = _modes(env, centered, monkeypatch)
    a, b = cts[0], cts[1]
    c3 = ref.ev.multiply(a, b)
    r3 = ref.ev.relinearize(c3, ref.rk)
    want = ref.ev.rescale(r3)
    got = port.ev.rescale(_pc(r3))
    _eq(got, want, "rescale")
    assert got.level == a.level - 2
    _eq(port.ev.rescale(port.ev.relinearize(port.ev.multiply(_pc(a), _pc(b)),
                                            port.rk)), want, "steps")
    fused = ref.ev.multiply_relin_rescale(a, b, ref.rk)
    pfused = port.ev.multiply_relin_rescale(_pc(a), _pc(b), port.rk)
    _eq(pfused, fused, "multiply_relin_rescale")
    _eq(port.ev.rescale(_pc(batch)), ref.ev.rescale(batch), "batched rescale")
    _eq(port.ev.square_relin_rescale(_pc(batch), port.rk),
        ref.ev.square_relin_rescale(batch, ref.rk), "square_relin_rescale")
    # tests/test_hiprec.py's bounds
    prod = vals[0] * vals[1]
    assert np.abs(port.decrypt(pfused).real - prod).max() < 1e-9
    d = np.abs(port.decrypt(pfused).real - port.decrypt(got).real).max()
    assert d < 1e-9, d


@pytest.mark.parametrize("centered", [False, True])
def test_depth3_chain(env, centered, monkeypatch):
    params, _, vals, cts, _ = env
    ref, port = _modes(env, centered, monkeypatch)
    ct, pct = cts[2], _pc(cts[2])
    for i in range(3):
        ct = ref.ev.square_relin_rescale(ct, ref.rk)
        pct = port.ev.square_relin_rescale(pct, port.rk)
        _eq(pct, ct, f"square {i}")
    assert pct.level == params.num_anchor - 1
    assert np.abs(port.decrypt(pct).real - vals[2] ** 8).max() < 1e-7
    with pytest.raises(ValueError, match="floor"):
        port.ev.multiply_relin_rescale(pct, pct, port.rk)


@pytest.mark.parametrize("centered", [False, True])
def test_drop_level_and_rotation(env, centered, monkeypatch):
    _, _, vals, cts, batch = env
    ref, port = _modes(env, centered, monkeypatch)
    a = cts[0]
    dropped = port.drop_level(_pc(a))
    _eq(dropped, ref.drop_level(a), "drop_level")
    assert np.abs(port.decrypt(dropped).real - vals[0]).max() < 5e-9
    low = ref.reach_level(cts[1], a.level - 4)
    for g, w in zip(port.align(_pc(a), _pc(low)), ref.align(a, low),
                    strict=True):
        _eq(g, w, "align")
    rot = port.ev.rotate(_pc(batch), 1, port.gk)
    _eq(rot, ref.ev.rotate(batch, 1, ref.gk), "rotate")
    dec = port.decrypt(rot).real
    assert np.abs(dec[0] - np.roll(vals[0], -1)).max() < 5e-9
