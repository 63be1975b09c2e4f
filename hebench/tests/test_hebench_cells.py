"""Each mix's whole run on the CPU at a tiny preset (the card's look
skipped): the reference agrees with the port, the result has the
contract's keys, the control fails, and each fault that a cell can have,
planted under the timed path, makes ``correct`` false."""

import importlib

import pytest
import torch

from hebench.tests import tiny

CELLS = tiny.mixes()
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_correct_on_cpu(name):
    out = tiny.run(name)
    assert out["correct"], out["checks"]
    assert list(out) == RESULT_KEYS + ["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for k, v in out["checks"].items():
        assert set(v) == {"value", "limit"}
    assert "setup_s" in out["metrics"]
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_traced_result_keys(name):
    out = tiny.run(name, trace=True)
    assert out["correct"]
    assert list(out) == RESULT_KEYS + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    """The plain math in the program's place, one precision lower, judged
    by the comparison that decides ``correct``: not correct, where the
    program's answers are."""
    out = tiny.run(name, control=True)
    assert out["correct"]
    c = out["control"]
    assert c["correct"] is False and c["failed"] > 0
    k = importlib.import_module(
        f"hebench.reference.{tiny.cell(name).config['scheme']}").CALIBRATED
    assert c[k] > out["checks"][k]["limit"]


def _unchanged(real):
    """A step that returns its state unchanged: the first input."""
    def f(*args, **kw):
        return args[1] if not hasattr(args[0], "data") else args[0]
    return f


def _half_batch(real, ct_arg):
    """Half of the batch left out: the first half's answers twice."""
    def f(*args, **kw):
        args = list(args)
        for i in ct_arg:
            h = args[i].data.shape[0] // 2
            args[i] = args[i].with_(data=args[i].data[:h])
        out = real(*args, **kw)
        return out.with_(data=torch.cat([out.data, out.data]))
    return f


def _altered(real):
    """An answer altered where it is produced: one residue off by one."""
    def f(*args, **kw):
        out = real(*args, **kw)
        outs = out if isinstance(out, tuple) else (out,)
        d = outs[0].data.clone()
        d.view(-1)[7] += 1
        bad = (outs[0].with_(data=d),) + tuple(outs[1:])
        return bad if isinstance(out, tuple) else bad[0]
    return f


def _scale_round_off_by_one(real):
    """BFV's scale-and-round off by one in one coefficient of one limb:
    the conversion of t·x/Q from the basis B back to Q (the last of the
    HPS multiply's base conversions) returns one residue plus one."""
    from hetpu_torch.core.bfv import BfvScheme
    make, to_q = BfvScheme._make_lvl, set()

    def make_lvl(self, level):
        d = make(self, level)
        to_q.add(id(d["fbc_b_to_q"]))
        return d

    def f(x, plan, *args, **kw):
        out = real(x, plan, *args, **kw)
        if id(plan) in to_q:
            out = out.clone()
            out.view(-1)[7] += 1
        return out
    return f, (BfvScheme, "_make_lvl", make_lvl)


def _targets():
    from hetpu_torch.bfv import BfvSession
    from hetpu_torch.core import bfv
    from hetpu_torch.core.evaluator import Evaluator
    from hebench.entries import infer
    mul = (Evaluator, "multiply_relin_rescale")
    return [
        ("mul_stream", mul,
         lambda r: (lambda self, a, b, rk: a), "unchanged"),
        ("mul_stream", mul,
         lambda r: (lambda self, a, b, rk: _half_batch(
             lambda a, b: r(self, a, b, rk), (0, 1))(a, b)), "half_batch"),
        ("mul_stream", mul, _altered, "altered"),
        ("infer", (infer, "infer_step"),
         lambda r: (lambda sess, ct, d, a: ct), "unchanged"),
        ("infer", (infer, "infer_step"),
         lambda r: (lambda sess, ct, d, a: _half_batch(
             lambda ct: r(sess, ct, d, a), (0,))(ct)), "half_batch"),
        ("infer", (infer, "infer_step"), _altered, "altered"),
        ("bfv_mul_stream", (BfvSession, "multiply_relin"),
         lambda r: (lambda self, a, b: a), "unchanged"),
        ("bfv_mul_stream", (bfv.BfvScheme, "multiply"),
         lambda r: (lambda self, a, b, ev: _half_batch(
             lambda a, b: r(self, a, b, ev), (0, 1))(a, b)), "half_batch"),
        ("bfv_mul_stream", (Evaluator, "relinearize"),
         lambda r: (lambda self, ct, rk: ct), "relinearize_skipped"),
        ("bfv_mul_stream", (bfv, "fbc_apply"), _scale_round_off_by_one,
         "scale_round_off_by_one"),
    ]


@pytest.mark.parametrize("case", range(10))
def test_planted_fault_is_caught(case, monkeypatch):
    name, (owner, attr), make, fault = _targets()[case]
    planted = make(getattr(owner, attr))
    if isinstance(planted, tuple):       # the fault and a hook it needs
        planted, (o, a, hook) = planted
        monkeypatch.setattr(o, a, hook)
    monkeypatch.setattr(owner, attr, planted)
    out = tiny.run(name)
    assert not out["correct"], (name, fault, out["checks"])
    assert out["failed"] > 0
