"""The in-slot FFT cell (``ckks_n15.bfft1024.b64``) on the CPU: its plain
reference against numpy and the DFT's definition, its least bytes by hand
and against the program's counter at the tiny shapes, the profiler
leaving the residues alone, the span readers on a hand-made trace, what
it imports, and faults planted under the timed path (at the mix's tiny
row: test_hi, n = 8) that must make ``correct`` false.  One test runs the
tiny row traced on the card and skips here."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from hebench import counts, counts_fft, harness, inputs
from hebench import trace as tr
from hebench.reference import bfft as ref
from hebench.tests import tiny

ROOT = Path(__file__).resolve().parents[2]
CELL = "ckks_n15.bfft1024.b64"
READERS = ["fft_masks_us_per_op", "fft_masks_roofline",
           "fft_rescale_us_per_op", "fft_rescale_roofline"]


def _config(name="ckks_n15_fft") -> dict:
    return json.loads((ROOT / "hebench/configs" / f"{name}.json")
                      .read_text())


def test_reference_against_numpy():
    """Slot s of ciphertext j holds DFT(x_j)[br(s mod n)], in complex128
    for float64 and complex64 for float32; slots that n does not divide
    are refused."""
    n, slots = 8, 32
    rng = np.random.default_rng(27)
    x = rng.uniform(-1, 1, (3, n)) + 1j * rng.uniform(-1, 1, (3, n))
    got = ref.expected({"x": x, "slots": slots}, torch.float64, "cpu")
    assert got.dtype == torch.complex128 and got.shape == (3, slots)
    k = np.arange(n)
    dft = x @ np.exp(-2j * np.pi * np.outer(k, k) / n)
    br = [int(f"{i:03b}"[::-1], 2) for i in range(n)]
    for s in range(slots):
        np.testing.assert_allclose(got[:, s].numpy(), dft[:, br[s % n]],
                                   rtol=0, atol=1e-13)
    np.testing.assert_allclose(got[:, :n].numpy(), np.fft.fft(x)[:, br],
                               rtol=0, atol=1e-13)
    low = ref.expected({"x": x, "slots": slots}, torch.float32, "cpu")
    assert low.dtype == torch.complex64
    with pytest.raises(ValueError):
        ref.expected({"x": x, "slots": 12}, torch.float64, "cpu")


def test_reference_bit_reversal_is_the_programs():
    from hetpu_torch.fft import _bit_reversal
    for n in (2, 8, 1024):
        assert ref.bit_reversal(n).tolist() == _bit_reversal(n).tolist()


@pytest.mark.parametrize("seed", [2**31 + 7, 2700000001])
def test_cell_limit_below_the_transform_in_complex64(seed):
    """The precision class below float64 fails the cell's limit on the
    cell's own inputs: the transform computed in complex64 strays from
    complex128's by more than ``max_abs_err``'s limit.  (The harness's
    control casts the plain math to float64, which keeps a complex
    result's real part only, so it reads this gap and the imaginary
    parts together.)"""
    cell = harness.find_cell(CELL)
    p = cell.params
    rng = inputs.Inputs(seed).rng
    x = rng.uniform(-1, 1, (p["batch"], p["n"]))
    x = x + 1j * rng.uniform(-1, 1, (p["batch"], p["n"]))
    args = {"x": x, "slots": cell.config["poly_degree"] // 2}
    gap = (ref.expected(args, torch.float64, "cpu")
           - ref.expected(args, torch.float32, "cpu")).abs().max()
    assert gap > 10 * cell.limits["max_abs_err"]


def test_least_bytes_by_hand():
    """At the cell: 10 stages at L = 23, 21, …, 5 limbs of [64, 2, L, N]
    int32 planes, 16,777,216 B a limb.  The masks read 2 sources and write
    1 sum in the first stage, 3 and 1 after: 3·23 + 4·(21 + 19 + … + 5) =
    537 limbs, plus the 29 masks' 2·23 + 3·117 = 397 planes of 131,072 B:
    9,061,400,576 B, 2.705 ms at 3.35 TB/s.  The rescales read L and write
    L − 2: 140 + 120 = 260 limbs, 4,362,076,160 B, 1.302 ms."""
    cfg = _config()
    assert counts_fft.mask_bytes(cfg, 64, 1024) == \
        537 * 16_777_216 + 397 * 131_072 == 9_061_400_576
    assert counts_fft.rescale_bytes(cfg, 64, 1024) == 4_362_076_160
    assert counts.bound_seconds(9_061_400_576) == \
        pytest.approx(2.705e-3, rel=1e-3)
    assert counts.bound_seconds(4_362_076_160) == \
        pytest.approx(1.302e-3, rel=1e-3)


@pytest.fixture(scope="module")
def hi():
    """test_hi with the forward 8-point transform's keys, and 2 signals
    tiled over its 512 slots."""
    from hebench.entries import bfft as entry
    from hetpu_torch.session import Session
    sess = Session.create("test_hi", seed=b"\x1b" * 32,
                          galois_steps=entry.galois_steps({"n": 8}),
                          device="cpu")
    rng = np.random.default_rng(27)
    x = rng.uniform(-1, 1, (2, 8)) + 1j * rng.uniform(-1, 1, (2, 8))
    cts = [sess.encrypt(np.tile(r, sess.slots // 8)) for r in x]
    return sess, cts[0].with_(data=torch.stack([c.data for c in cts]))


def test_profiler_leaves_the_residues_and_counts_the_masks(hi):
    """Under a profiler ``bfft`` gives the same residues, opens
    ``fft.masks`` and ``fft.rescale`` once a stage (``ks.mod_down`` inside
    the rescale), and its counter equals ``counts_fft`` at these shapes;
    without a profiler the counter stays at 0."""
    from hebench import stages
    from hetpu_torch import fft
    from hetpu_torch.core import cuda_lib
    sess, ct = hi
    cuda_lib.reset_launches()
    plain = fft.bfft(sess, ct, 8)
    assert fft.mask_bytes["bfft"] == 0
    with tr.profiler() as prof:
        traced = fft.bfft(sess, ct, 8)
    assert torch.equal(plain.data, traced.data)
    assert plain.scale == traced.scale and plain.level == traced.level
    cfg = {"poly_degree": 1024, "moduli": list(sess.ctx.params.moduli),
           "rescale_group": sess.ctx.params.rescale_group}
    assert fft.mask_bytes["bfft"] == counts_fft.mask_bytes(cfg, 2, 8) > 0
    spans = [e for e in stages.events_of(prof)
             if e["name"].startswith("hetpu/")]
    names = [e["name"] for e in spans]
    assert names.count("hetpu/fft.masks") == 3
    assert names.count("hetpu/fft.rescale") == 3
    within = lambda a, b: (b["ts"] <= a["ts"]
                           and a["ts"] + a["dur"] <= b["ts"] + b["dur"])
    rescales = [e for e in spans if e["name"] == "hetpu/fft.rescale"]
    downs = [e for e in spans if e["name"] == "hetpu/ks.mod_down"
             and any(within(e, r) for r in rescales)]
    assert len(downs) == 3
    cuda_lib.reset_launches()
    assert fft.mask_bytes["bfft"] == 0


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "args": {} if corr is None else {"correlation": corr}}
    return e


def _events(with_fft=True):
    """One call of 2 transforms: a rotation step (kernel 1, 5 µs), a
    stage's masks (kernels 2 and 3, 7 + 11 µs) and its rescale with the
    mod-down inside (kernels 4 and 5, 13 + 17 µs), and the fold (19 µs)."""
    ev = [_x("user_annotation", "request", 0, 200),
          _x("user_annotation", "evaluate", 0, 150),
          _x("user_annotation", "fold", 150, 50),
          _x("user_annotation", "hetpu/rot.step", 5, 10),
          _x("user_annotation", "hetpu/fft.masks", 20, 30),
          _x("user_annotation", "hetpu/fft.rescale", 60, 40),
          _x("user_annotation", "hetpu/ks.mod_down", 65, 30)]
    if not with_fft:
        ev = [e for e in ev if not e["name"].startswith("hetpu/fft.")]
    launches = {1: 8, 2: 25, 3: 40, 4: 62, 5: 70, 6: 160}
    durs = {1: 5.0, 2: 7.0, 3: 11.0, 4: 13.0, 5: 17.0, 6: 19.0}
    for c, ts in launches.items():
        ev.append(_x("cuda_runtime", "cudaLaunchKernel", ts, 1, c))
        ev.append(_x("kernel", f"k{c}", 300 + 40 * c, durs[c], c))
    return ev


class _FE:
    """An event as ``torch.profiler.profile.events()`` gives it."""

    def __init__(self, e):
        from torch.autograd import DeviceType
        self.name, self.id = e["name"], e["args"].get("correlation", -1)
        self.device_type = (DeviceType.CUDA if e["cat"] == "kernel"
                            else DeviceType.CPU)
        self.time_range = type("R", (), {"start": e["ts"],
                                         "end": e["ts"] + e["dur"]})()


def _read(metric, events, config, batch=2, n=8):
    """``metric`` of a run whose profiler holds ``events``, as
    ``run_cell`` holds it."""
    prof = torch.profiler.profile.__new__(torch.profiler.profile)
    fe = [_FE(e) for e in events]
    prof.events = lambda: fe
    run = harness.Run(config=config, params={"batch": batch, "n": n},
                      setup_s=0.0, window_s=1.0, calls=1, units=batch,
                      latencies_s=[],
                      trace=tr.parse(events, 1, batch, frozenset()))
    return harness.reader(metric)(run)


def test_readers_on_a_hand_made_trace():
    """The masks' span holds kernels 2 and 3, the rescale's kernels 4 and
    5 at any depth; a program that opens no ``hetpu/fft.*`` span, or an
    untraced run, gives nothing."""
    cfg = _config()
    got = {m: _read(m, _events(), cfg) for m in READERS}
    assert got["fft_masks_us_per_op"] == (7.0 + 11.0) / 2
    assert got["fft_rescale_us_per_op"] == (13.0 + 17.0) / 2
    assert got["fft_masks_roofline"] == pytest.approx(
        100 * counts.bound_seconds(counts_fft.mask_bytes(cfg, 2, 8))
        / 18e-6)
    assert got["fft_rescale_roofline"] == pytest.approx(
        100 * counts.bound_seconds(counts_fft.rescale_bytes(cfg, 2, 8))
        / 30e-6)
    assert all(_read(m, _events(with_fft=False), cfg) is None
               for m in READERS)
    untraced = harness.Run(config=cfg, params={"batch": 2, "n": 8},
                           setup_s=1.0, window_s=1.0, calls=1, units=2,
                           latencies_s=[], trace=None)
    assert all(harness.reader(m)(untraced) is None for m in READERS)


def _modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_imports_in_a_fresh_interpreter():
    """The reference and the yardstick load nothing of the program; the
    entry and the readers load no JAX and no JAX package."""
    mods = _modules("import hebench.reference.bfft, hebench.reference.ckks\n"
                    "import hebench.counts_fft, hebench.spans")
    assert not mods & {"jax", "jaxlib", "flax", "hetpu", "hetpu_torch"}
    mods = _modules("import hebench.entries.bfft\n"
                    "from hebench import harness\n"
                    f"harness.find_cell('{CELL}')\n"
                    f"[harness.reader(m) for m in {READERS!r}]")
    assert "hetpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "hetpu"}


def _twiddle_flipped(real):
    """One twiddle of the second stage negated, in both masks that carry
    it (D0 = −w and D2 = w at its positions)."""
    def f(n, h, inverse, last, tile):
        D0, D1, D2 = real(n, h, inverse, last, tile)
        if h == n // 4:
            p = int(np.flatnonzero(D2[:n])[1])
            D0, D2 = D0.copy(), D2.copy()
            D0[p::n] *= -1
            D2[p::n] *= -1
        return D0, D1, D2
    return f


def _merge_dropped(real):
    """The first stage's merge dropped: D1 keeps its own half and loses
    the −n/2 rotation's term that the tiling folded into it."""
    def f(n, h, inverse, last, tile):
        D0, D1, D2 = real(n, h, inverse, last, tile)
        if D2 is None:
            D1 = D1 * (np.arange(tile) % n < h)
        return D0, D1, D2
    return f


def _stage_skipped(real):
    """The second stage's three mask products skipped: each returns its
    source with the product's scale.  A call of the tiny row (n = 8)
    makes 2 + 3 + 3 products in this order."""
    made = [0]

    def f(self, ct, pt):
        k, made[0] = made[0] % 8, made[0] + 1
        if 2 <= k < 5:
            return ct.with_(scale=ct.scale * pt.scale)
        return real(self, ct, pt)
    return f


def _targets():
    from hetpu_torch import fft
    from hetpu_torch.core.evaluator import Evaluator
    return {"twiddle_flipped": ((fft, "_bfft_masks"), _twiddle_flipped),
            "merge_dropped": ((fft, "_bfft_masks"), _merge_dropped),
            "stage_skipped": ((Evaluator, "multiply_plain"),
                              _stage_skipped)}


@pytest.mark.parametrize("fault", ["twiddle_flipped", "merge_dropped",
                                   "stage_skipped"])
def test_planted_fault_is_caught(fault, monkeypatch):
    (owner, attr), make = _targets()[fault]
    monkeypatch.setattr(owner, attr, make(getattr(owner, attr)))
    out = tiny.run("bfft")
    assert not out["correct"], (fault, out["checks"])
    assert out["failed"] > 0


def test_the_tiny_row_is_sound():
    """Unplanted, the tiny row is correct over every slot of both
    ciphertexts of each kept call, well inside its limit."""
    out = tiny.run("bfft")
    assert out["correct"], out["checks"]
    assert out["checks"]["max_abs_err"]["value"] < 1e-8
    assert out["attempted"] >= 4


@pytest.mark.cuda
def test_readers_read_a_traced_tiny_run_on_the_card():
    """The tiny row traced on the card: the four readers give numbers, the
    rooflines below 100."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    c = tiny.cell("bfft")
    c.per_layer = c.per_layer + READERS
    out = harness.run_cell(c, tiny.SEED, 0.5, True, "cuda",
                           time.perf_counter(), log=lambda s: None)
    assert out["correct"], out["checks"]
    got = {m: out["metrics"][m]["value"] for m in READERS}
    assert all(v > 0 for v in got.values()), got
    assert got["fft_masks_roofline"] < 100
    assert got["fft_rescale_roofline"] < 100
