"""The program's stages in a hand-made trace (``hebench.stages``): each
device operation's stage, the idle gaps' labels, the three readers of the
stages and the launch bytes, and the four older readers unchanged on the
same trace; a traced run on the CPU, where no device operation runs,
reads none of the three."""

import pytest
import torch
from torch.autograd import DeviceType

from hebench import harness, stages
from hebench import trace as tr
from hebench.tests import tiny

PKG = frozenset({"ntt_kernel", "lifted_kernel", "tensor_product_kernel",
                 "ks_tail_kernel"})


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def _events():
    """One call: the tensor product, a decompose with a plain copy and K1
    and K2, then the tail's K8; the host frees memory inside the
    decompose while the device idles (50-70), and the device idles again
    from inside the tail (100-165)."""
    ev = [_x("user_annotation", "request", 0, 200),
          _x("user_annotation", "evaluate", 5, 150),
          _x("user_annotation", "hetpu/mul.tensor", 6, 4),
          _x("user_annotation", "hetpu/ks.decompose", 12, 60),
          _x("user_annotation", "hetpu/ks.tail", 80, 40),
          _x("user_annotation", "fold", 160, 10),
          _x("cuda_runtime", "cudaLaunchKernel", 7, 1, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 13, 1, correlation=2),
          _x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=3),
          _x("cuda_runtime", "cudaFree", 52, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 70, 1, correlation=4),
          _x("cuda_runtime", "cudaLaunchKernel", 85, 1, correlation=5),
          _x("cuda_runtime", "cudaLaunchKernel", 161, 1, correlation=6),
          _x("kernel", "void tensor_product_kernel<4>()", 10, 10,
             correlation=1),
          _x("kernel", "void at::native::copy_kernel()", 20, 10,
             correlation=2),
          _x("kernel", "void ntt_kernel<14, false>()", 30, 20,
             correlation=3),
          _x("kernel", "void lifted_kernel<14>()", 70, 20, correlation=4),
          _x("kernel", "void ks_tail_kernel<0>()", 90, 10, correlation=5),
          _x("kernel", "void at::native::add_kernel()", 165, 5,
             correlation=6)]
    return ev


def test_each_op_has_its_stage_and_span():
    st = stages.parse(_events())
    assert [(o.span, o.stage) for o in st.ops] == [
        ("evaluate", "hetpu/mul.tensor"),
        ("evaluate", "hetpu/ks.decompose"),
        ("evaluate", "hetpu/ks.decompose"),
        ("evaluate", "hetpu/ks.decompose"),
        ("evaluate", "hetpu/ks.tail"),
        ("fold", "none")]
    assert sum(k.dur for k in st.kernels
               if k.stage == "hetpu/ks.decompose") == 50


def test_gaps_are_labelled_by_stage_and_runtime_call():
    st = stages.parse(_events())
    assert st.gaps[0] == (pytest.approx(65e-6), "evaluate/ks.tail")
    labels = [g[1] for g in st.gaps]
    assert "evaluate/ks.decompose@cudaFree" in labels
    assert labels.count("evaluate/ks.decompose@cudaFree") == 1
    # the lengths are hebench.trace's
    t = tr.parse(_events(), 1, 4, PKG)
    assert sorted(g[0] for g in st.gaps) == sorted(g[0] for g in t.gaps)


class _FE:
    """An event as ``torch.profiler.profile.events()`` gives it."""

    def __init__(self, e, device):
        self.name, self.id = e["name"], e["args"].get("correlation", -1)
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.time_range = type("R", (), {"start": e["ts"],
                                         "end": e["ts"] + e["dur"]})()


def _chrome(with_stages=True):
    """:func:`_events`' call with the device's copy of a span and a device
    copy, which are no kernels, and a host op whose id is a kernel's
    correlation id."""
    ev = [e for e in _events()
          if with_stages or not e["name"].startswith("hetpu/")]
    return ev + [_x("gpu_user_annotation", "evaluate", 10, 90),
                 _x("cuda_runtime", "cudaMemcpyAsync", 150, 1,
                    correlation=7),
                 _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 150, 3,
                    correlation=7),
                 _x("cpu_op", "aten::add_", 160, 2, correlation=3)]


def _profiler(with_stages=True):
    """A stopped profiler holding :func:`_chrome`'s events."""
    events = [_FE(e, e["cat"] in ("kernel", "gpu_memcpy",
                                  "gpu_user_annotation"))
              for e in _chrome(with_stages)]
    prof = torch.profiler.profile.__new__(torch.profiler.profile)
    prof.events = lambda: events
    return prof


def _run(events, batch=4):
    t = tr.parse(events, 1, batch, PKG)
    return harness.Run(config={}, params={"batch": batch}, setup_s=0.0,
                       window_s=1.0, calls=1, units=batch, latencies_s=[],
                       trace=t)


def test_events_of_the_profiler():
    """The profiler's events read as the Chrome trace's: the same stages,
    spans and gaps; the device's copies of the spans are no kernels."""
    got = stages.parse(stages.events_of(_profiler()))
    want = stages.parse(_chrome())
    assert [(o.name, o.cat, o.span, o.stage) for o in got.ops] == \
        [(o.name, o.cat, o.span, o.stage) for o in want.ops]
    assert [o.cat for o in got.ops] == ["kernel"] * 6 + ["gpu_memcpy"]
    assert got.gaps == want.gaps


def test_stage_readers(monkeypatch):
    from hetpu_torch.core import cuda_lib
    run = _run(_events())
    prof = _profiler()               # held here, as run_cell holds it
    assert isinstance(prof, torch.profiler.profile)
    assert harness.reader("decompose_us_per_op")(run) == 50 / 4
    assert harness.reader("ks_tail_us_per_op")(run) == 10 / 4
    monkeypatch.setattr(cuda_lib, "launch_bytes",
                        dict(cuda_lib.launch_bytes, ntt=6_700_000))
    # package kernels: 10 + 20 + 20 + 10 µs
    want = 100 * 6_700_000 / 3.35e12 / 60e-6
    assert harness.reader("pkg_kernel_roofline")(run) == pytest.approx(want)
    monkeypatch.setattr(cuda_lib, "launch_bytes",
                        dict.fromkeys(cuda_lib.launch_bytes, 0))
    assert harness.reader("pkg_kernel_roofline")(run) is None
    del prof


def test_older_readers_unchanged_by_stages():
    """The four readers the benchmark had read the same trace with and
    without program stages."""
    plain = [e for e in _events() if not e["name"].startswith("hetpu/")]
    for m in ("plain_kernel_us_per_op", "pkg_kernel_us_per_op",
              "mul_op_roofline", "device_idle_share.ops"):
        r = harness.reader(m)
        cfg = {"poly_degree": 1024, "moduli": [1] * 3,
               "special_moduli": [1], "rescale_group": 1, "scheme": "ckks"}
        a, b = _run(_events()), _run(plain)
        a.config = b.config = cfg
        assert r(a) == r(b) and r(a) is not None, m
    a = _run(_events())
    assert harness.reader("plain_kernel_us_per_op")(a) == 10 / 4
    assert harness.reader("pkg_kernel_us_per_op")(a) == 60 / 4


def test_no_stage_reads_nothing():
    """A program that opens no stage (the parent of the spans): the stage
    readers read nothing and raise nothing; so without a profiler."""
    plain = [e for e in _events() if not e["name"].startswith("hetpu/")]
    run = _run(plain)
    prof = _profiler(with_stages=False)
    assert harness.reader("decompose_us_per_op")(run) is None
    del prof
    assert harness.reader("ks_tail_us_per_op")(_run(_events())) is None


def test_traced_cpu_run_reads_none_of_the_new_metrics():
    new = ["decompose_us_per_op", "ks_tail_us_per_op", "pkg_kernel_roofline"]
    c = tiny.cell("mul_stream")
    assert set(new) <= set(c.per_layer)
    import time
    out = harness.run_cell(c, tiny.SEED, 0.05, True, "cpu",
                           time.perf_counter(), log=lambda s: None)
    assert out["correct"]
    assert not set(new) & set(out["metrics"])
