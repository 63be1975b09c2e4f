"""What a run imports: a fresh interpreter loads the harness, every entry
and the reference, and no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``hetpu`` (compared whole: ``hetpu_torch`` is the
program); the reference alone loads nothing of the program either."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _top_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    mods = _top_modules(
        "import hebench.run, hebench.harness, hebench.calibrate\n"
        "import hebench.entries.mul_stream, hebench.entries.infer\n"
        "import hebench.entries.bfv_mul_stream\n"
        "from hebench.reference import bfv, bfv_mul_stream\n"
        "from hebench import harness\n"
        "[harness.session_class(s) for s in harness.SESSIONS]\n"
        "[harness.reader(m) for m in ('setup_s', 'mul_op_roofline')]")
    assert "hetpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "hetpu"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_modules(
        "import hebench.reference.ckks, hebench.reference.mul_stream\n"
        "import hebench.reference.infer, hebench.reference.bfv\n"
        "import hebench.reference.bfv_mul_stream")
    assert not mods & {"jax", "jaxlib", "flax", "hetpu", "hetpu_torch"}


def test_harness_forbidden_check_compares_whole_names(monkeypatch):
    from hebench import harness
    monkeypatch.setitem(sys.modules, "hetpu_torch_x", sys)
    assert "hetpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hetpu.core", sys)
    assert harness.forbidden_modules() == ["hetpu"]


def test_run_refuses_without_a_card():
    """No card here: the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "-m", "hebench.run", "--workload",
         "ckks_n14.mul_stream.b128", "--seed", str(2**31 + 7), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_with_only_the_benchmark_files(tmp_path):
    """A checkout holding only BENCHMARK.json and hebench/ has no program:
    the command fails and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "hebench", tmp_path / "hebench")
    out = subprocess.run(
        [sys.executable, "-m", "hebench.run", "--workload",
         "ckks_n14.mul_stream.b128", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout == ""
