"""The BFV multiply's stage spans and its conversions' byte counter, on
the CPU at test_bfv_crt (one session for the module):

  * under ``torch.profiler``, ``BfvSession.multiply_relin`` opens
    ``hetpu/bfv.lift`` (each operand), ``hetpu/bfv.convert`` (four
    times: inside each lift, then twice inside the scale),
    ``hetpu/mul.tensor``, ``hetpu/bfv.scale``, then relinearize's
    ``hetpu/ks.decompose``, ``hetpu/ks.inner`` and ``hetpu/ks.mod_down``,
    inside the caller's span; the stages other than the conversions
    follow one another apart;
  * its output is bit-equal with and without the profiler;
  * ``rns.convert_bytes`` counts the four conversions' planes (every
    source limb read once, every target limb written once) on a traced
    call only, and ``cuda_lib.reset_launches`` clears it;
  * its answers, decrypted by the benchmark's plain referee
    (``hebench/reference/bfv.py``), equal the plain x·y mod t in every
    slot.
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from hebench import inputs as bench_inputs
from hebench.reference import bfv as ref_bfv
from hebench.reference import bfv_mul_stream
from hebench.reference.ckks import Answer
from hetpu_torch.bfv import BfvSession
from hetpu_torch.core import cuda_lib, rns

torch.set_num_threads(1)

SEED = 2**31 + 2021
B = 2
CONVERT = "hetpu/bfv.convert"


@pytest.fixture(scope="module")
def case():
    inp = bench_inputs.Inputs(SEED)
    sess = BfvSession.create("test_bfv_crt",
                             seed=bench_inputs.key_seed(SEED),
                             galois_steps=[], device="cpu")
    t = sess.ctx.params.plain_modulus
    x = inp.rng.integers(0, t, (B, sess.slots))
    y = inp.rng.integers(0, t, (B, sess.slots))
    return sess, x, y, inp.encrypt(sess, x), inp.encrypt(sess, y)


def _traced(fn, tmp_path):
    """``fn()`` under the profiler inside an ``evaluate`` span: the
    ``hetpu/`` spans in start order, the ``evaluate`` span and fn's
    result."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("evaluate"):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = [e for e in json.loads(path.read_text())["traceEvents"]
          if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    ev.sort(key=lambda e: e["ts"])
    outer = next(e for e in ev if e["name"] == "evaluate")
    return [e for e in ev if e["name"].startswith("hetpu/")], outer, out


def _inside(s, t):
    return t["ts"] <= s["ts"] and s["ts"] + s["dur"] <= t["ts"] + t["dur"]


def test_multiply_relin_spans(case, tmp_path):
    sess, _, _, a, b = case
    spans, outer, _ = _traced(lambda: sess.multiply_relin(a, b), tmp_path)
    assert [s["name"][len("hetpu/"):] for s in spans] == [
        "bfv.lift", "bfv.convert", "bfv.lift", "bfv.convert", "mul.tensor",
        "bfv.scale", "bfv.convert", "bfv.convert", "ks.decompose",
        "ks.inner", "ks.mod_down"]
    assert all(_inside(s, outer) for s in spans)
    stages = [s for s in spans if s["name"] != CONVERT]
    for s, t in zip(stages, stages[1:]):
        assert s["ts"] + s["dur"] <= t["ts"]
    # each conversion lies inside the stage opened last before it
    owner = {i: s for i, s in enumerate(spans) if s["name"] != CONVERT}
    for i in (i for i, s in enumerate(spans) if s["name"] == CONVERT):
        parent = owner[max(j for j in owner if j < i)]
        assert _inside(spans[i], parent)
        assert parent["name"] in ("hetpu/bfv.lift", "hetpu/bfv.scale")


def test_outputs_bit_equal_with_and_without_the_profiler(case, tmp_path):
    sess, _, _, a, b = case
    plain = sess.multiply_relin(a, b)
    _, _, traced = _traced(lambda: sess.multiply_relin(a, b), tmp_path)
    assert torch.equal(plain.data, traced.data)
    assert plain.level == traced.level


def test_convert_bytes_count_only_under_a_profiler(case, tmp_path):
    sess, _, _, a, b = case
    p = sess.ctx.params
    L = len(p.moduli)
    kb = len(sess.scheme._lvl(a.level)["B_primes"])
    cuda_lib.reset_launches()
    sess.multiply_relin(a, b)
    assert sum(rns.convert_bytes.values()) == 0
    _traced(lambda: sess.multiply_relin(a, b), tmp_path)
    # a and b Q → B (2 parts each), t·x Q → B and y B → Q (3 parts each)
    assert sum(rns.convert_bytes.values()) == \
        10 * (L + kb) * p.poly_degree * 4 * B
    cuda_lib.reset_launches()
    assert not any(rns.convert_bytes.values())


def test_answers_decrypt_to_the_plain_product(case):
    sess, x, y, a, b = case
    out = sess.multiply_relin(a, b)
    p = sess.ctx.params
    cfg = {"moduli": list(p.moduli), "plain_modulus": p.plain_modulus,
           "plain_factors": list(p.plain_factors)}
    inputs = {"x": x, "y": y, "t": p.plain_modulus}
    [(slots, no_margin)] = ref_bfv.values(
        [Answer(data=out.data, scales=[1.0] * B, inputs=inputs,
                slots=sess.slots)],
        bench_inputs.key_seed(SEED), cfg, "cpu")
    want = bfv_mul_stream.expected(inputs, torch.int64, "cpu")
    assert torch.equal(slots, want)
    assert no_margin == 0
