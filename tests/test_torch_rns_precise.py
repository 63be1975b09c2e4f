"""The precise (two-float) α of hetpu_torch against hetpu's, as hetpu's BFV
runs it — eagerly, outside ``jax.jit``, each f32 op rounding on its own:

  * ``twofloat.two_prod`` / ``two_sum`` / ``ds_add`` / ``ds_round`` on
    random float32 pairs and on halves;
  * the ``FbcPlan`` fields, the two-float ones included;
  * ``rns._alpha_precise`` and ``fbc_apply(precise=True)`` on random
    columns of BFV's conversions (test_bfv_crt: Q → B, B → Q, Q → G) and on
    the adversarial near-half-integer columns of tests/test_rns.py, where
    both must also equal the exact big-integer conversion.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core import nt as ref_nt
from hetpu.core import rns as ref_rns
from hetpu.core import twofloat as ref_tf
from hetpu.core.bfv import BfvScheme as RefBfvScheme
from hetpu.core.context import Context as RefContext
from hetpu.core.params import preset as ref_preset
from hetpu_torch.core import rns, twofloat
from hetpu_torch.core.modular import from_u32, to_u32
from test_rns import _craft_near_half, _digits_to_input, _expected

torch.set_num_threads(1)


def _f32(rng, n, scale):
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _eq_f32(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_twofloat_equal():
    rng = np.random.default_rng(5)
    a, b = _f32(rng, 4096, 1e4), _f32(rng, 4096, 1e-5)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.0, 1e7 + 0.5],
                      dtype=np.float32)
    tiny = np.array([1e-9, -1e-9, 0.0, 2e-8, -3e-8, 0.0, 1e-12],
                    dtype=np.float32)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for got, want in zip(twofloat.two_prod(ta, tb), ref_tf.two_prod(ja, jb),
                         strict=True):
        _eq_f32(got, want)
    for got, want in zip(twofloat.two_sum(ta, tb), ref_tf.two_sum(ja, jb),
                         strict=True):
        _eq_f32(got, want)
    p, e = twofloat.two_prod(ta, tb)
    rp, re = ref_tf.two_prod(ja, jb)
    for got, want in zip(twofloat.ds_add(ta, tb * 1e-8, p, e),
                         ref_tf.ds_add(ja, jb * np.float32(1e-8), rp, re),
                         strict=True):
        _eq_f32(got, want)
    _eq_f32(twofloat.ds_round(torch.from_numpy(halves), torch.from_numpy(tiny)),
            ref_tf.ds_round(jnp.asarray(halves), jnp.asarray(tiny)))
    _eq_f32(twofloat.ds_round(ta, tb), ref_tf.ds_round(ja, jb))


@pytest.fixture(scope="module")
def bfv_plans():
    """BFV's three conversions at test_bfv_crt's top level, both packages."""
    ref = RefBfvScheme(RefContext(ref_preset("test_bfv_crt")))
    lvl = ref._lvl(ref.ctx.num_data - 1)
    Q = list(ref.ctx.params.moduli)
    out = {}
    for name, src, dst in (("q_to_b", Q, lvl["B_primes"]),
                           ("b_to_q", lvl["B_primes"], Q),
                           ("q_to_g", Q, lvl["G_primes"])):
        out[name] = (src, ref_rns.make_fbc(src, dst),
                     rns.make_fbc(src, dst, "cpu"))
    return out


@pytest.mark.parametrize("name", ["q_to_b", "b_to_q", "q_to_g"])
def test_fbc_plan_fields_equal(bfv_plans, name):
    _, want, got = bfv_plans[name]
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        if g.dtype == torch.float32:        # p_recip and the two-float split
            np.testing.assert_array_equal(g.numpy(), w.astype(np.float32),
                                          err_msg=f.name)
        else:
            np.testing.assert_array_equal(to_u32(g), w, err_msg=f.name)


@pytest.mark.parametrize("name", ["q_to_b", "b_to_q", "q_to_g"])
def test_alpha_precise_random(bfv_plans, name):
    """Random residues, batched [2, 2, L, N]: α, and the conversion with
    and without the premultiply."""
    src, want_plan, plan = bfv_plans[name]
    rng = np.random.default_rng(len(name))
    q = np.array(src, dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, (2, 2, len(src), 512), dtype=np.uint64)
         % q).astype(np.uint32)
    np.testing.assert_array_equal(
        to_u32(rns._alpha_precise(from_u32(x), plan).to(torch.int32)),
        np.asarray(ref_rns._alpha_precise(jnp.asarray(x), want_plan))
        .astype(np.uint32))
    for premul in (True, False):
        got = rns.fbc_apply(from_u32(x), plan, precise=True, premul=premul)
        want = ref_rns.fbc_apply(jnp.asarray(x), want_plan, precise=True,
                                 premul=premul)
        np.testing.assert_array_equal(to_u32(got), np.asarray(want))


@pytest.fixture(scope="module")
def bases():
    src = ref_nt.gen_primes(30, 6, 2 * 64)
    dst = [p for p in ref_nt.gen_primes(29, 8, 2 * 64) if p not in src][:4]
    return src, dst


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_precise_near_half(bases, seed):
    """tests/test_rns.py's adversarial columns: Σ y_i/p_i within ~2^-29 of
    a half-integer.  The port equals hetpu and the exact conversion."""
    src, dst = bases
    plan = rns.make_fbc(src, dst, "cpu")
    want_plan = ref_rns.make_fbc(src, dst)
    cols = _craft_near_half(src, seed=seed, want=16)
    x = np.concatenate([np.asarray(_digits_to_input(y, src, 1))
                        for y in cols], axis=1)
    got = to_u32(rns.fbc_apply(from_u32(x), plan, correct=True,
                               precise=True))
    ref = np.asarray(ref_rns.fbc_apply(jnp.asarray(x), want_plan,
                                       correct=True, precise=True))
    np.testing.assert_array_equal(got, ref)
    for c, y in enumerate(cols):
        want, _ = _expected(y, src, dst)
        np.testing.assert_array_equal(got[:, c], want, err_msg=f"digits={y}")


def test_precise_random_exact(bases):
    """tests/test_rns.py's random digit vectors: exact conversion."""
    src, dst = bases
    plan = rns.make_fbc(src, dst, "cpu")
    rng = random.Random(3)
    cols = [[rng.randrange(p) for p in src] for _ in range(100)]
    x = np.concatenate([np.asarray(_digits_to_input(y, src, 1))
                        for y in cols], axis=1)
    got = to_u32(rns.fbc_apply(from_u32(x), plan, correct=True, precise=True))
    for c, y in enumerate(cols):
        np.testing.assert_array_equal(got[:, c], _expected(y, src, dst)[0])
