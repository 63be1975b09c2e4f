"""The BFV cell ``bfv_n14.mul_stream.b64``: its configuration against the
port's ``bfv_batch`` preset (auxiliary basis and key switch included),
the conversions' least bytes (``hebench.counts_bfv``) by hand and
against the program's own counter, and the three readers of the HPS
multiply's stages on a hand-made trace, on a trace without them and in
a traced run on the CPU."""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hebench import counts_bfv, harness, inputs
from hebench import trace as tr
from hebench.tests import tiny
from hebench.tests.test_hebench_stages import _FE, _x

ROOT = Path(__file__).resolve().parents[2]
CELL = "bfv_n14.mul_stream.b64"
CONFIG = json.loads((ROOT / "hebench/configs/bfv_n14_batch.json")
                    .read_text())
NEW = ["bfv_convert_us_per_op", "bfv_scale_us_per_op",
       "bfv_convert_roofline"]
PKG = frozenset({"ntt_kernel", "tensor_product_kernel", "ks_tail_kernel"})


def _aux(cfg: dict):
    """The port's context at ``cfg``'s preset and the auxiliary basis of
    its BFV multiply at the top level."""
    from hetpu_torch.core.bfv import BfvScheme
    from hetpu_torch.core.context import Context
    from hetpu_torch.core.params import preset
    ctx = Context(preset(cfg["preset"]), "cpu")
    return ctx, BfvScheme(ctx)._lvl(len(cfg["moduli"]) - 1)["B_primes"]


@pytest.fixture(scope="module")
def tiny_cfg():
    """The tiny BFV row's configuration, with its auxiliary basis."""
    cfg = tiny.cell("bfv_mul_stream").config
    return {**cfg, "aux_moduli": _aux(cfg)[1]}


def test_config_holds_the_aux_basis_and_the_key_switch():
    ctx, aux = _aux(CONFIG)
    assert CONFIG["aux_moduli"] == aux
    plan = ctx.keyswitch_plan(len(CONFIG["moduli"]) - 1)
    assert CONFIG["key_switch"] == {
        "alpha": plan.alpha, "digits": plan.num_digits,
        "key_basis": len(plan.basis_tables.primes)}
    assert CONFIG["precision"] == "exact" and CONFIG["reduced"] == []


def test_the_cell_is_listed_where_it_reads():
    """The cell reports ``ops_per_s`` and every per-layer metric that has
    something to read in it; not ``ks_tail_us_per_op``: BFV's relinearize
    ends in the mod-down."""
    c = harness.find_cell(CELL)
    assert c.config["name"] == "bfv_n14_batch"
    assert c.params["batch"] == 64 and c.params["pool"] == 4
    assert c.limits == {"slot_mismatch": 0}
    assert c.end_to_end == ["ops_per_s", "setup_s"]
    assert "ks_tail_us_per_op" not in c.per_layer
    assert set(NEW) < set(c.per_layer)


def test_convert_bytes_at_the_cell():
    """10 parts of L + K_B = 17 limbs an op at N=2^14: 11,141,120 B an
    op, 713,031,680 B a call of 64."""
    assert counts_bfv.convert_call_bytes(CONFIG, 1) == 11_141_120
    assert counts_bfv.convert_call_bytes(CONFIG, 64) == 713_031_680


def test_convert_bytes_equal_the_programs_counter(tiny_cfg):
    from hetpu_torch.bfv import BfvSession
    from hetpu_torch.core import cuda_lib, rns
    sess = BfvSession.create(tiny_cfg["preset"], seed=bytes(32),
                             galois_steps=[], device="cpu")
    a = inputs.Inputs(tiny.SEED).encrypt(sess, [[1, 2, 3], [4, 5, 6]])
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU]):
        sess.multiply_relin(a, a)
    assert sum(rns.convert_bytes.values()) == \
        counts_bfv.convert_call_bytes(tiny_cfg, 2)
    cuda_lib.reset_launches()


def _events(with_bfv=True):
    """One call of 4 ops: each operand's lift with its conversion inside,
    the tensor products, the scale with two conversions inside, the
    decompose.  Conversions 100 + 60 + 40 µs, the scale's own 20 µs."""
    spans = [("hetpu/bfv.lift", 6, 30), ("hetpu/bfv.convert", 10, 20),
             ("hetpu/mul.tensor", 42, 8), ("hetpu/bfv.scale", 52, 68),
             ("hetpu/bfv.convert", 60, 20), ("hetpu/bfv.convert", 90, 20),
             ("hetpu/ks.decompose", 125, 15)]
    launches = [(7, "void ntt_kernel<14, false>()", 10),
                (12, "void at::native::remainder_kernel()", 100),
                (45, "void tensor_product_kernel<4>()", 8),
                (55, "void ntt_kernel<14, false>()", 20),
                (65, "void at::native::mul_kernel()", 60),
                (95, "void at::native::add_kernel()", 40),
                (130, "void ntt_kernel<14, true>()", 6)]
    ev = [_x("user_annotation", "request", 0, 400),
          _x("user_annotation", "evaluate", 5, 250)]
    ev += [_x("user_annotation", n, ts, d) for n, ts, d in spans
           if with_bfv or not n.startswith("hetpu/bfv.")]
    for i, (ts, name, dur) in enumerate(launches):
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1,
                     correlation=i))
        ev.append(_x("kernel", name, 150 + 10 * i + sum(
            d for _, _, d in launches[:i]), dur, correlation=i))
    return ev


def _profiler(events):
    fe = [_FE(e, e["cat"] == "kernel") for e in events]
    prof = torch.profiler.profile.__new__(torch.profiler.profile)
    prof.events = lambda: fe
    return prof


def _run(events, cfg, batch=4):
    return harness.Run(config=cfg, params={"batch": batch}, setup_s=0.0,
                       window_s=1.0, calls=1, units=batch, latencies_s=[],
                       trace=tr.parse(events, 1, batch, PKG))


SMALL = {"poly_degree": 1024, "moduli": [1] * 3, "aux_moduli": [1] * 2}


def test_readers_read_a_hand_made_trace():
    ev = _events()
    prof = _profiler(ev)             # held here, as run_cell holds it
    run = _run(ev, SMALL)
    assert harness.reader("bfv_convert_us_per_op")(run) == 200 / 4
    assert harness.reader("bfv_scale_us_per_op")(run) == 20 / 4
    # 10 parts of 5 limbs of 1024 words, 4 ops, over 200 µs a call
    want = 100 * (4 * 10 * 5 * 1024 * 4) / 3.35e12 / 200e-6
    assert harness.reader("bfv_convert_roofline")(run) == \
        pytest.approx(want)
    assert harness.reader("decompose_us_per_op")(run) == 6 / 4
    del prof


def test_readers_read_nothing_without_a_trace_or_a_stage():
    """No trace; a program whose multiply opens no span (the parent of
    the spans), with the key switch's stages; no program stage at all."""
    run = _run(_events(), SMALL)
    run.trace = None
    assert all(harness.reader(m)(run) is None for m in NEW)
    ev = _events(with_bfv=False)
    prof = _profiler(ev)
    assert harness.reader("decompose_us_per_op")(_run(ev, SMALL)) == 6 / 4
    assert all(harness.reader(m)(_run(ev, SMALL)) is None for m in NEW)
    ev = [e for e in ev if not e["name"].startswith("hetpu/")]
    prof = _profiler(ev)
    assert all(harness.reader(m)(_run(ev, SMALL)) is None for m in NEW)
    del prof


def test_traced_cpu_run_reads_none_of_the_new_metrics(tiny_cfg):
    """The tiny BFV row through the harness, traced, with the cell's
    per-layer metrics: no device operation runs on the CPU, so the new
    readers read nothing and raise nothing."""
    c = dataclasses.replace(tiny.cell("bfv_mul_stream"), config=tiny_cfg,
                            per_layer=harness.find_cell(CELL).per_layer)
    out = harness.run_cell(c, tiny.SEED, 0.05, True, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert out["correct"], out["checks"]
    assert not set(NEW) & set(out["metrics"])
