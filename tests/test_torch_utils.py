"""hetpu_torch.utils against hetpu.utils: the same metrics events and
counters, the Timer's ``timer`` event, the chained op_latency, the
determinism check and the storage-alias audit (the port's form of
``donation_audit``)."""

import json

import numpy as np
import pytest
import torch

from hetpu.utils import metrics as ref_metrics
from hetpu.utils.timer import Timer as RefTimer
from hetpu_torch.utils import debug, leaves, metrics, profiling
from hetpu_torch.utils.timer import Timer

torch.set_num_threads(1)


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_timer_event_matches_hetpu(tmp_path, monkeypatch, capsys):
    sink = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("HETPU_METRICS", str(sink))
    RefTimer().toc("stage")
    Timer().toc("stage", block_on={"a": [torch.zeros(2)], "b": 3})
    ref, ours = _events(sink)
    assert set(ref) == set(ours) == {"ts", "event", "label", "seconds"}
    assert ref["event"] == ours["event"] == "timer"
    assert ref["label"] == ours["label"] == "stage"
    assert isinstance(ours["seconds"], float) and ours["seconds"] >= 0
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out] == ["stage", "stage"]


def test_timer_tocr_without_sink(monkeypatch):
    monkeypatch.delenv("HETPU_METRICS", raising=False)
    t = Timer()
    assert 0 <= t.tocr(torch.ones(3)) < 60
    assert not metrics.enabled()


@pytest.mark.parametrize("sink", ["file", "stderr"])
def test_counters_match_hetpu(tmp_path, monkeypatch, capsys, sink):
    path = tmp_path / "m.jsonl"
    monkeypatch.setenv("HETPU_METRICS", str(path) if sink == "file" else "-")
    names = {"a": 2.0, "b": 0.5}
    for mod in (ref_metrics, metrics):
        for k, v in names.items():
            mod.count(f"probe_{sink}_{k}", v)
            mod.count(f"probe_{sink}_{k}", v)
    want = {k: v for k, v in ref_metrics.dump_counters().items()
            if k.startswith(f"probe_{sink}_")}
    got = {k: v for k, v in metrics.dump_counters().items()
           if k.startswith(f"probe_{sink}_")}
    assert got == want == {f"probe_{sink}_a": 4.0, f"probe_{sink}_b": 1.0}
    lines = (path.read_text() if sink == "file"
             else capsys.readouterr().err).splitlines()
    ref_ev, our_ev = (json.loads(ln) for ln in lines)
    assert ref_ev["event"] == our_ev["event"] == "counters"
    assert {k: our_ev[k] for k in got} == got


def test_op_latency_chains_its_calls():
    """One warm-up call and ``iters`` timed calls; each call's input is
    data ^ (parity of the previous output's [..., :1, :8] sum)."""
    data = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 30, (1, 3, 16), dtype=np.int64).astype(np.int32))
    seen, outs = [], []

    def fn(x):
        seen.append(x.clone())
        outs.append(x.clone())
        outs[-1][0, 0, 0] += len(seen)       # flips the parity every call
        return outs[-1]

    dt = profiling.op_latency(fn, data, iters=5)
    assert dt >= 0 and len(seen) == 6
    assert torch.equal(seen[0], data)
    for prev, x in zip(outs, seen[1:]):
        tag = int(prev[..., :1, :8].to(torch.int64).sum()) & 1
        assert torch.equal(x, data ^ tag)
    assert any(not torch.equal(x, data) for x in seen[1:])


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace`` yields its directory, as hetpu's does; ``profiled`` (the
    port's own) yields the profiler.  Both write the Chrome trace."""
    with profiling.trace(str(tmp_path)) as log_dir:
        torch.ones(64).sum()
    assert log_dir == str(tmp_path)
    assert json.loads((tmp_path / "trace.json").read_text())
    (tmp_path / "trace.json").unlink()
    with profiling.profiled(str(tmp_path)) as prof:
        torch.ones(64).sum()
    assert prof.key_averages() is not None
    assert json.loads((tmp_path / "trace.json").read_text())


def test_determinism_check():
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    debug.determinism_check(lambda a: (a * 2, {"s": a.sum(), "n": 3}), x)
    calls = []

    def drifting(a):
        calls.append(1)
        return a + len(calls)
    with pytest.raises(AssertionError, match="not deterministic"):
        debug.determinism_check(drifting, x, reps=3)


@pytest.mark.parametrize("ret,expect", [
    (lambda x: x[0], 1),                   # a view of the input
    (lambda x: x.clone(), 0),
    (lambda x: (x.view(-1), x + 1, x[1:]), 2),
    (lambda x: {"k": x.clone(), "v": [x]}, 1),
])
def test_alias_audit_counts_shared_storage(ret, expect):
    x = torch.zeros((4, 8), dtype=torch.int32)
    assert debug.alias_audit(ret, x, expect_aliases=expect) == expect
    with pytest.raises(AssertionError, match="aliasing an input"):
        debug.alias_audit(ret, x, expect_aliases=expect + 1)


def test_leaves_walks_nests():
    t = torch.ones(1)
    assert leaves({"a": (1, [t]), "b": 2}) == [1, t, 2]
