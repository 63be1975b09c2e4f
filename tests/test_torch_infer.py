"""The encrypted inference layer (offload/pipeline.py ``infer_step``: a
diagonal-method matvec with one hoisted decomposition, rescale,
square_relin_rescale and solved-scale constants) against hetpu's, at
test_dnum with a batch of 2 encrypted vectors, 4 diagonals and weight seed
7 — bit for bit, and within 5e-3 of ``infer_reference`` after decryption
(the bound of tests/test_offload.py:173).

Run twice: with the default FBC, and with ``centered_fbc=True`` against
hetpu under ``HETPU_MXU_FBC=1`` (a fresh hetpu evaluator, since hetpu reads
the switch when it traces).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from hetpu.core.evaluator import Evaluator as RefEvaluator
from hetpu.offload import pipeline as ref_pipeline
from hetpu.session import Session as RefSession
from hetpu_torch import convert
from hetpu_torch.core import cuda_lib
from hetpu_torch.core.modular import to_u32
from hetpu_torch.offload import pipeline
from hetpu_torch.session import Session

torch.set_num_threads(1)

SEED = b"\x37" * 32
B, N_DIAGS, WSEED = 2, 4, 7


@pytest.fixture(scope="module")
def ref_env():
    ref = RefSession.create("test_dnum", seed=SEED,
                            galois_steps=list(range(1, N_DIAGS)))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (B, ref.slots))
    cts = [ref.encryptor.encrypt(ref.encode(v), seed=bytes([0x60 + i]) * 32)
           for i, v in enumerate(x)]
    batch = cts[0].with_(data=jnp.stack([c.data for c in cts]))
    return ref, x, batch


@pytest.mark.parametrize("centered", [False, True])
def test_infer_step(ref_env, centered, monkeypatch):
    ref, x, batch = ref_env
    if centered:
        monkeypatch.setenv("HETPU_MXU_FBC", "1")
    ref = dataclasses.replace(ref, ev=RefEvaluator(ref.ctx), _pt_cache={})
    diags, act = ref_pipeline._infer_weights(ref.slots, N_DIAGS, WSEED)
    want = ref_pipeline.infer_step(ref, batch, diags, act)

    port = Session.create("test_dnum", seed=SEED,
                          galois_steps=list(range(1, N_DIAGS)), device="cpu",
                          centered_fbc=centered)
    pdiags, pact = pipeline._infer_weights(port.slots, N_DIAGS, WSEED)
    np.testing.assert_array_equal(pdiags, diags)
    cuda_lib.reset_launches()
    got = pipeline.infer_step(port, convert.ciphertext(batch, "cpu"), pdiags,
                              pact)
    assert sum(cuda_lib.launches.values()) == 0        # CPU: plain paths
    # the centered path built (and cached) its centered conversion plans
    assert any(k[0] == "cfbc" for k in port.ctx._memo) == centered
    assert (got.level, got.scale) == (want.level, want.scale)
    np.testing.assert_array_equal(to_u32(got.data), np.asarray(want.data))
    dec = port.decrypt(got).real
    assert dec.shape == (B, port.slots)
    for i in range(B):
        ref_out = pipeline.infer_reference(x[i], pdiags, pact)
        assert np.abs(dec[i] - ref_out).max() < 5e-3
