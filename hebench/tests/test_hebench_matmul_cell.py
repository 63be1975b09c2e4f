"""The encrypted matrix-product cell (``ckks_n14.diag_matmul.d128``) on the
CPU: its plain reference against an independent product, its least
bytes by hand, its span reader on a hand-made trace, what it imports, and
faults planted under the timed path (at the mix's tiny row, d = 8) that
must make ``correct`` false."""

import json
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from hebench import counts_matmul, spans
from hebench.reference import diag_matmul
from hebench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL = "ckks_n14.diag_matmul.d128"


def test_reference_against_numpy_at_d4():
    """Slots [0, d) of column j are (A·B)[:, j]; slot d + i holds the
    upper copy's partial sum Σ_{k < d − i} A[i, i + k]·B[i + k, j] (the
    rotated column leaves the second copy past 2d); the rest are 0."""
    d, slots = 4, 16
    rng = np.random.default_rng(44)
    a, b = rng.uniform(-1, 1, (d, d)), rng.uniform(-1, 1, (d, d))
    got = diag_matmul.expected({"a": a, "b": b, "slots": slots},
                               torch.float64, "cpu").numpy()
    assert got.shape == (d, slots)
    np.testing.assert_allclose(got[:, :d].T, a @ b, rtol=0, atol=1e-14)
    for j in range(d):
        for i in range(d):
            want = sum(a[i, i + k] * b[i + k, j] for k in range(d - i))
            assert got[j, d + i] == pytest.approx(want, abs=1e-14)
    assert not got[:, 2 * d:].any()


def test_reference_layouts_match_the_drivers():
    """The reference's diagonals are the rows the entry encrypts."""
    d = 5
    a = np.arange(d * d, dtype=np.float64).reshape(d, d)
    i = np.arange(d)
    rows = a[i[None, :], (i[None, :] + i[:, None]) % d]
    assert np.array_equal(diag_matmul.diagonals(torch.from_numpy(a))
                          .numpy(), rows)
    assert all(rows[k, r] == a[r, (r + k) % d]
               for k in range(d) for r in range(d))
    with pytest.raises(ValueError):
        diag_matmul.tile2(torch.zeros(2, 5), 8)


def test_least_bytes_of_the_rotation_steps():
    """At the cell: L = 9, K = 5, so J = 2 digits over R = 14 primes; a
    step reads c0 (128·9 planes), the digits (128·2·14) and the key (2·2·14)
    and writes the rotation (128·2·9): 7,096 planes of 2^14 int32 words,
    465,043,456 B; 127 steps are 59,060,518,912 B, 17.63 ms at 3.35 TB/s."""
    cfg = json.loads((ROOT / "hebench/configs/ckks_n14_rot128.json")
                     .read_text())
    assert counts_matmul.rot_steps_bytes(cfg, 128) == 59_060_518_912
    assert counts_matmul.rot_steps_bytes(cfg, 2, cols=128) == 465_043_456
    assert counts_matmul.rot_steps_bytes(cfg, 128) / 3.35e12 == \
        pytest.approx(17.63e-3, rel=1e-3)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_reader_counts_kernels_at_any_depth():
    """A kernel counts for ``hetpu/rot.step`` when its launch lies inside
    one, under a nested stage too; not when launched outside every step,
    nor outside ``evaluate``."""
    ev = [_x("user_annotation", "request", 0, 200),
          _x("user_annotation", "evaluate", 0, 150),
          _x("user_annotation", "fold", 150, 50),
          _x("user_annotation", "hetpu/rot.step", 10, 40),
          _x("user_annotation", "hetpu/ks.inner", 20, 10),
          _x("user_annotation", "hetpu/rot.galois", 12, 4),
          _x("user_annotation", "hetpu/rot.step", 60, 30),
          _x("user_annotation", "hetpu/mm.accumulate", 95, 20)]
    launches = {1: 13, 2: 25, 3: 45, 4: 70, 5: 100, 6: 160}
    durs = {1: 3.0, 2: 5.0, 3: 7.0, 4: 11.0, 5: 13.0, 6: 17.0}
    for c, ts in launches.items():
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1, c))
        ev.append(_x("kernel", f"k{c}", 300 + c, durs[c], c))
    kernels, named = spans.parse(ev)
    assert sorted(d for _, d in kernels) == [3.0, 5.0, 7.0, 11.0, 13.0]
    assert named["hetpu/rot.step"] == [(10, 50), (60, 90)]
    assert spans.device_us_within(kernels, named["hetpu/rot.step"]) == \
        3.0 + 5.0 + 7.0 + 11.0
    assert spans.device_us_within(kernels, named["hetpu/rot.galois"]) == 3.0
    assert spans.parse([_x("user_annotation", "evaluate", 0, 1)]) == ([], {})


@pytest.mark.parametrize("metric", ["rot_step_us_per_op",
                                    "rot_step_roofline",
                                    "galois_gather_us_per_op",
                                    "galois_gather_roofline"])
def test_new_readers_read_nothing_untraced(metric):
    from hebench import harness
    run = harness.Run(config={}, params={"dim": 8, "batch": 1},
                      setup_s=1.0, window_s=1.0, calls=1, units=1,
                      latencies_s=[], trace=None)
    assert harness.reader(metric)(run) is None


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_imports_in_a_fresh_interpreter():
    """The reference and the yardstick load nothing of the program; the
    entry and the readers load no JAX and no JAX package."""
    ref = _modules("import hebench.reference.diag_matmul\n"
                   "import hebench.reference.ckks\n"
                   "import hebench.counts_matmul, hebench.spans")
    assert not ref & {"jax", "jaxlib", "flax", "hetpu", "hetpu_torch"}
    run = _modules(
        "import hebench.entries.diag_matmul\n"
        "from hebench import harness\n"
        "harness.find_cell('" + CELL + "')\n"
        "[harness.reader(m) for m in ('rot_step_us_per_op', "
        "'rot_step_roofline', 'galois_gather_us_per_op', "
        "'galois_gather_roofline')]")
    assert "hetpu_torch" in run
    assert not run & {"jax", "jaxlib", "flax", "hetpu"}


def _step_left_out(real):
    """One rotation step's rotation replaced by zeros: its product drops
    out of the sum."""
    def f(self, ct, steps, gk):
        for i, r in enumerate(real(self, ct, steps, gk)):
            yield r.with_(data=torch.zeros_like(r.data)) if i == 1 else r
    return f


def _half_columns(real):
    """Half of B's columns multiplied, their outputs given twice."""
    from hetpu_torch.linalg import BatchedMatrix

    def f(self, other):
        h = other.cols // 2
        half = BatchedMatrix(other.sess, other.ct.with_(
            data=other.ct.data[:h]), other.rows, h, "col")
        out = real(self, half)
        return replace(out, ct=out.ct.with_(data=torch.cat(
            [out.ct.data, out.ct.data])), cols=other.cols)
    return f


def _altered(real):
    """One residue of the product off by one."""
    def f(self, other):
        out = real(self, other)
        d = out.ct.data.clone()
        d.view(-1)[7] += 1
        return replace(out, ct=out.ct.with_(data=d))
    return f


def _targets():
    from hetpu_torch.core.evaluator import Evaluator
    from hetpu_torch.linalg import BatchedMatrix
    return {
        "step_left_out": ((Evaluator, "rotate_hoisted_iter"),
                          _step_left_out),
        "half_columns": ((BatchedMatrix, "_matmul_diag_col"), _half_columns),
        "altered": ((BatchedMatrix, "matmul"), _altered),
        "relinearize_skipped": ((Evaluator, "relinearize"),
                                lambda r: (lambda self, ct, rk: ct)),
    }


@pytest.mark.parametrize("fault", ["step_left_out", "half_columns",
                                   "altered", "relinearize_skipped"])
def test_planted_fault_is_caught(fault, monkeypatch):
    (owner, attr), make = _targets()[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = tiny.run("diag_matmul")
    assert not out["correct"], (fault, out["checks"])
    assert out["failed"] > 0


def test_the_tiny_row_is_sound():
    """Unplanted, the tiny row is correct and compares every slot."""
    out = tiny.run("diag_matmul")
    assert out["correct"], out["checks"]
    assert out["checks"]["max_abs_err"]["value"] < 1e-3
    assert out["attempted"] >= 2
