"""Packaging contracts of hetpu_torch:

  * importing it (every module, and running the slice and the probes on
    CPU tensors) pulls in neither JAX nor hetpu and builds nothing — checked in a fresh
    interpreter with no nvcc reachable;
  * the card's scripts (``chip_smoke.py``, ``kernel_ab.py``) import
    neither JAX nor hetpu;
  * CPU tensors take the plain paths: every kernel launch counter stays 0;
  * a tensor on any other device raises instead of falling back;
  * the entry points run on the card unless given ``device="cpu"``, and
    raise where there is none;
  * the port's transport loader builds its library under
    ``build/hetpu_torch/`` only, never next to ``native/hetpu_io.cpp``.
"""

import ast
import dataclasses
import hashlib
import inspect
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from hetpu_torch import convert
from hetpu_torch.bfv import BfvSession
from hetpu_torch.core import cuda_lib, fused_ntt, ip_kernel, serial
from hetpu_torch.core.context import Context
from hetpu_torch.core.ntt import ntt_fwd, ntt_inv
from hetpu_torch.core.params import preset
from hetpu_torch.demos import (fft as fft_demos, math_operations,
                               matrix_operations, offload_demos)
from hetpu_torch.offload import pipeline, recv_request
from hetpu_torch.offload.client import Client
from hetpu_torch.offload.server import serve_once
from hetpu_torch.session import Session
from hetpu_torch.utils.keycache import cached_session

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_import_pulls_no_jax_and_builds_nothing(tmp_path):
    code = textwrap.dedent("""
        import sys
        import hetpu_torch, hetpu_torch.session, hetpu_torch.convert
        import hetpu_torch.core.centered_fbc, hetpu_torch.math
        import hetpu_torch.core.mxu_digits, hetpu_torch.probes.__main__
        import hetpu_torch.utils.debug, hetpu_torch.utils.profiling
        import hetpu_torch.utils.timer, hetpu_torch.utils.keycache
        import hetpu_torch.core.twofloat, hetpu_torch.core.serial
        from hetpu_torch import probes
        from hetpu_torch.bfv import BfvSession
        from hetpu_torch.core import serial
        from hetpu_torch.core import cuda_lib
        from hetpu_torch.offload import pipeline
        from hetpu_torch.session import Session
        import hetpu_torch.ops, hetpu_torch.linalg, hetpu_torch.fft
        import hetpu_torch.models.least_squares, hetpu_torch.offload.server
        import hetpu_torch.offload.client
        from hetpu_torch.runtime import native
        import hetpu_torch.parallel.peer, hetpu_torch.parallel.tp
        import hetpu_torch.demos, hetpu_torch.demos.__main__
        import hetpu_torch.demos.matrix_operations
        import hetpu_torch.demos.bfv_operations
        import hetpu_torch.demos.math_operations, hetpu_torch.demos.fft
        import hetpu_torch.demos.offload_demos
        import hetpu_torch.bench, hetpu_torch.bench.__main__
        import hetpu_torch.bench.headline, hetpu_torch.bench.secondary
        import hetpu_torch.bench.workloads
        import hetpu_torch.bench.profile_fused
        import hetpu_torch.bench.profile_hotpath
        import hetpu_torch.bench.op_parts_chain
        import hetpu_torch.bench.bench_sweep, hetpu_torch.bench.probe_n15
        import hetpu_torch.bench.probe_lsq_twice
        import hetpu_torch.bench.trace_op
        from hetpu_torch import parallel
        from hetpu_torch.parallel import cp
        import torch
        m = parallel.make_mesh(names=("cp",), device="cpu")
        t = cp.build_tables(2048, (12289, 40961), "cpu")
        v = torch.arange(2 * 2048, dtype=torch.int32).reshape(2, 2048) % 12289
        assert torch.equal(cp.cp_ntt_inv(cp.cp_ntt_fwd(v, t, m), t, m), v)
        s = Session.create("test_tiny", seed=b"\\x01" * 32, galois_steps=[1],
                           device="cpu", centered_fbc=True)
        ct = s.encrypt(0.5)
        out = s.ev.multiply_relin_rescale(ct, ct, s.rk)
        assert abs(s.decrypt(out).real - 0.25).max() < 1e-3
        out = s.drop_level(s.ev.rotate(ct, 1, s.gk))
        assert abs(s.decrypt(out).real - 0.5).max() < 1e-3
        b = BfvSession.create("test_bfv_tiny", seed=b"\x01" * 32,
                              galois_steps=[1], device="cpu")
        c = serial.load_ciphertext(serial.dump_ciphertext(
            b.encrypt([3, 4])), b.ctx)
        prod = b.rotate_rows(b.mod_switch(b.multiply_relin(c, c)), 1)
        d = b.decrypt(prod)
        assert (d[0], d[511], d[1:511].any()) == (16, 9, False)
        probes.run("kernel_parts", device="cpu", rows=1, limbs=1, k=1)
        probes.run("int8_mxu", device="cpu", batch=1, k=1)
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "hetpu")]
        assert not bad, bad
        assert cuda_lib._lib is None and native._lib is None
        assert sum(cuda_lib.launches.values()) == 0
        print("clean")
    """)
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH="/usr/bin:/bin",
               CUDA_HOME=str(tmp_path / "no-cuda"))
    env.pop("CUDA_PATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")
    assert not any(cuda_lib.BUILD_DIR.glob("*.tmp"))


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.stat().st_mtime_ns
            for p in root.rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_transport_loader_builds_under_build_only(tmp_path):
    """A copy of the port and of native/ whose prebuilt library is older
    than its source (the case in which hetpu's loader rebuilds
    native/libhetpu_io.so in place): loading the port's transport writes
    only under build/hetpu_torch/ and leaves native/ as it was, bytes and
    mtimes."""
    shutil.copytree(REPO / "hetpu_torch", tmp_path / "hetpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(REPO / "native", tmp_path / "native")
    so, cpp = tmp_path / "native" / "libhetpu_io.so", \
        tmp_path / "native" / "hetpu_io.cpp"
    os.utime(so, ns=(cpp.stat().st_mtime_ns - 10**9,) * 2)
    before = _tree(tmp_path)
    so_bytes = so.read_bytes()
    code = textwrap.dedent("""
        from hetpu_torch.runtime import native
        a, b = native.pipe_pair()
        a.send(b"frame")
        assert b.recv() == b"frame" and b.kind == "python"
        print("built" if native._lib else "python only")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    after = _tree(tmp_path)
    changed = {k for k in after if before.get(k) != after[k]}
    assert all(k.startswith("build/hetpu_torch/") for k in changed), changed
    assert so.read_bytes() == so_bytes
    assert after["native/libhetpu_io.so"] == before["native/libhetpu_io.so"]
    if proc.stdout.strip() == "built":         # a C++ compiler was found
        digest = hashlib.sha256(cpp.read_bytes()).hexdigest()[:16]
        assert [k for k in changed if k.endswith(".so")] == \
            [f"build/hetpu_torch/libhetpu_io_{digest}.so"]


@pytest.mark.parametrize("script", ["chip_smoke.py", "kernel_ab.py"])
def test_card_scripts_import_no_jax(script):
    """The card's scripts import hetpu_torch, never JAX or hetpu (the GPU
    host has no JAX): no import statement of theirs names either."""
    tree = ast.parse((REPO / script).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert any(m.split(".")[0] == "hetpu_torch" for m in names)
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "hetpu")]
    assert not bad, bad


def test_cpu_tensors_never_launch():
    cuda_lib.reset_launches()
    ctx = Context(preset("test_dnum"), "cpu")
    lvl = ctx.num_data - 1
    ks = ctx.keyswitch_plan(lvl)
    mdr = ctx.moddown_rescale_plan(lvl)
    x = torch.zeros((2, lvl + 1, 1024), dtype=torch.int32)
    y = ntt_inv(ntt_fwd(x, ctx.tables(lvl)), ctx.tables(lvl))
    fused_ntt.ntt_fwd_lifted(y, ks.lift_w, ks.lift_ws, ks.lift_dig,
                             ks.foreign_cat_tables)
    u = torch.zeros((2, len(mdr.src_tables.primes), 1024), dtype=torch.int32)
    fused_ntt.ntt_fwd_fbc(u, mdr.fbc, mdr.dst_tables)
    R = len(ks.basis_tables.primes)
    ext = torch.zeros((ks.num_digits, R, 1024), dtype=torch.int32)
    k = torch.zeros((ks.num_digits, 2, R, 1024), dtype=torch.int32)
    ip_kernel.inner_product(ext, k, k, ks.q)
    s = Session.create("test_tiny", seed=b"\x02" * 32, galois_steps=[],
                       device="cpu")
    ct = s.encrypt(np.ones(4))
    s.decrypt(s.ev.square_relin_rescale(ct, s.rk))
    assert cuda_lib.launches == dict.fromkeys(cuda_lib.launches, 0)


def test_other_devices_raise():
    """No silent fallback: a tensor off the CPU and off CUDA (here the
    'meta' device) is refused, and so is a mix of devices."""
    ctx = Context(preset("test_tiny"), "cpu")
    t = ctx.tables(0)
    with pytest.raises(ValueError, match="unsupported device"):
        ntt_fwd(torch.zeros((1, 1024), dtype=torch.int32, device="meta"), t)
    ext = torch.zeros((1, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        ip_kernel.inner_product(ext, torch.zeros((1, 2, 2, 8),
                                                 dtype=torch.int32,
                                                 device="meta"),
                                ext, ext)


def test_entry_points_default_to_the_card():
    """Session.create, Session.from_wire, BfvSession.create, Context,
    convert.*, the serial loaders that take no context, cached_session and
    the offload entry points (recv_request, serve_once, Client, the
    pipeline's clients) and every demo default to device="cuda"; without a
    card they raise instead of falling back."""
    demos = [*matrix_operations.DEMOS.values(),
             *math_operations.DEMOS.values(), *fft_demos.DEMOS.values(),
             offload_demos.demo_client, offload_demos.demo_server,
             offload_demos.demo_rookie]
    for fn in (Session.create, Session.from_wire, Context.__init__,
               BfvSession.create, convert.secret_key, convert.public_key,
               convert.kswitch_key, convert.relin_keys, convert.galois_keys,
               convert.ciphertext, convert.plaintext, serial.load_public_key,
               serial.load_plaintext, cached_session, recv_request,
               serve_once, Client.__init__, pipeline.run_client,
               pipeline.run_client_infer, *demos):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        assert Context(preset("test_tiny")).device.type == "cuda"
        return
    params = preset("test_tiny")
    arr = np.zeros((2, 1, 8), dtype=np.uint32)
    for call in (lambda: Context(params),
                 lambda: Session.create(params, seed=b"\x03" * 32,
                                        galois_steps=[]),
                 lambda: Session.from_wire(params),
                 lambda: BfvSession.create("test_bfv_tiny", seed=b"\x03" * 32,
                                           galois_steps=[]),
                 lambda: serial.load_public_key(serial.dump_public_key(
                     type("Pk", (), dict(data=torch.zeros(2, 1, 8,
                                                          dtype=torch.int32))))),
                 lambda: convert.ciphertext(
                     type("Ct", (), dict(data=arr, level=0, scale=1.0))),
                 lambda: Client("test_tiny", seed=b"\x03" * 32,
                                galois_steps=[])):
        with pytest.raises((RuntimeError, AssertionError)):
            call()


# ----------------------------------------------------------------------
# hetpu's public names, one by one
# ----------------------------------------------------------------------

# hetpu modules whose counterparts sit elsewhere in the port (ROADMAP,
# queue 1): the int8 matrix-unit NTT and the Pallas NTT are the CUDA
# kernels of core/fused_ntt.py and core/ntt.py, the int8 centered
# conversion is core/centered_fbc.py, the four-step split is parallel/cp.py
MAPPED = {"hetpu.core.mxu_ntt": ("hetpu_torch.core.fused_ntt",
                                 "hetpu_torch.core.ntt"),
          "hetpu.core.pallas_ntt": ("hetpu_torch.core.ntt",),
          "hetpu.core.mxu_fbc": ("hetpu_torch.core.centered_fbc",),
          "hetpu.core.ntt4": ("hetpu_torch.parallel.cp",)}
# the same object under the port's name
RENAMED = {("hetpu.core.mxu_fbc", "MxuFbcPlan"):
           ("hetpu_torch.core.centered_fbc", "CenteredFbcPlan"),
           ("hetpu.core.mxu_ntt", "mod_add_u32"):
           ("hetpu_torch.core.modular", "mod_add")}
# ROADMAP "Do not port": backend choice, jit wrappers, the TPU's own table
# layouts and its 32-bit lane arithmetic (the port computes in int64)
DO_NOT_PORT = {("hetpu.core.ip_kernel", "enabled"),
               ("hetpu.core.modular", "mulhi_u32"),
               ("hetpu.core.modular", "mullo_u32"),
               ("hetpu.core.modular", "shoup_precompute_dev"),
               ("hetpu.core.modular", "to_mont"),
               ("hetpu.core.modular", "from_mont"),
               ("hetpu.core.ip_kernel", "inner_product_jnp"),
               ("hetpu.core.ntt", "build_best_tables"),
               ("hetpu.core.mxu_ntt", "enabled"),
               ("hetpu.core.mxu_ntt", "tables_for"),
               ("hetpu.core.mxu_ntt", "MxuNttTables"),
               ("hetpu.core.pallas_ntt", "enabled"),
               ("hetpu.core.pallas_ntt", "stage_columns"),
               ("hetpu.core.mxu_fbc", "enabled"),
               ("hetpu.core.ntt4", "FourStepTables"),
               ("hetpu.core.ntt4", "ntt_fwd"),
               ("hetpu.core.ntt4", "ntt_inv")}
# parameters of hetpu's that the port does not take: the parallel layer's
# mesh for n_devices, a jit switch, the int64 Montgomery multiply's R⁻¹
# for the 32-bit form's -q⁻¹ (ROADMAP "Do not port")
PARAMS_NOT_PORTED = {
    ("hetpu.offload.pipeline", "evaluate_sharded"): {"n_devices"},
    ("hetpu.offload.pipeline", "evaluate_sharded_infer"): {"n_devices"},
    ("hetpu.offload.pipeline", "serve_pipeline"): {"n_devices"},
    ("hetpu.core.evaluator", "Evaluator.__init__"): {"enable_jit"},
    ("hetpu.core.modular", "mont_mul"): {"qinv_neg"}}
HETPU_MODULES = sorted(
    ".".join(("hetpu", *p.relative_to(REPO / "hetpu").with_suffix("").parts))
    .removesuffix(".__init__")
    for p in (REPO / "hetpu").rglob("*.py"))


def _public(mod) -> dict:
    """Functions and classes defined in ``mod`` itself, by public name."""
    return {k: v for k, v in vars(mod).items() if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__ == mod.__name__}


def _exports(mod) -> set:
    """A package's exports: ``__all__``, else the public names it binds
    that were defined in the package (not imported from elsewhere)."""
    if hasattr(mod, "__all__"):
        return set(mod.__all__)
    return {k for k, v in vars(mod).items() if not k.startswith("_")
            and not inspect.ismodule(v)
            and getattr(v, "__module__", "").startswith(mod.__name__)}


def _methods(cls) -> dict:
    """A class's own public methods and properties, and a written
    ``__init__`` (a dataclass's generated one lists its fields)."""
    out = {}
    for k, v in vars(cls).items():
        fn = v.__func__ if isinstance(v, (staticmethod, classmethod)) else v
        if k == "__init__" and dataclasses.is_dataclass(cls):
            continue
        if (not k.startswith("_") or k == "__init__") and (
                inspect.isfunction(fn) or isinstance(fn, property)):
            out[k] = fn
    return out


def _params(fn) -> set:
    return set(inspect.signature(fn).parameters)


@pytest.mark.parametrize("name", HETPU_MODULES)
def test_hetpu_public_names_exist(name):
    """Every public top-level function and class, every method and every
    ``__init__`` export of a hetpu module exists in the port, with hetpu's
    parameters (the port may add some, such as ``device``), save the
    stated exceptions."""
    import importlib
    ref = importlib.import_module(name)
    ports = [importlib.import_module(m) for m in MAPPED.get(
        name, (name.replace("hetpu", "hetpu_torch", 1),))]
    missing = []
    for k, v in _public(ref).items():
        if (name, k) in DO_NOT_PORT:
            continue
        pmod, pk = RENAMED.get((name, k), (None, k))
        where = [importlib.import_module(pmod)] if pmod else ports
        got = next((getattr(m, pk) for m in where if hasattr(m, pk)), None)
        if got is None:
            missing.append(k)
            continue
        pairs = {k: (v, got)}
        if inspect.isclass(v):
            pairs = {f"{k}.{mk}": (mv, inspect.getattr_static(got, mk, None))
                     for mk, mv in _methods(v).items()}
        for qual, (a, b) in pairs.items():
            if b is None:
                missing.append(qual)
            elif isinstance(a, property):
                if not isinstance(b, property):
                    missing.append(f"{qual} (a property)")
            else:
                b = b.__func__ if isinstance(b, (staticmethod,
                                                 classmethod)) else b
                lost = _params(a) - _params(b) \
                    - PARAMS_NOT_PORTED.get((name, qual), set())
                if lost:
                    missing.append(f"{qual}({', '.join(sorted(lost))})")
    if ref.__file__.endswith("__init__.py"):
        missing += [f"export {k}" for k in sorted(_exports(ref))
                    if not hasattr(ports[0], k)]
    assert not missing, f"{name}: the port lacks {missing}"


# dataclass fields of hetpu's that the port lays out otherwise: the tp
# plan's GSPMD-sharded and replicated halves are the port's TpShard
FIELDS_NOT_PORTED = {("hetpu.parallel.tp", "TpKeySwitchPlan"):
                     {"sharded", "repl"}}
DATACLASS_MODULES = sorted(
    name for name in HETPU_MODULES
    if any(isinstance(n, ast.ClassDef) and any(
        "dataclass" in ast.unparse(d) for d in n.decorator_list)
        for n in ast.walk(ast.parse(
            (REPO / (name.replace(".", "/") + ".py")).read_text()
            if (REPO / (name.replace(".", "/") + ".py")).exists()
            else (REPO / name.replace(".", "/") / "__init__.py")
            .read_text()))))


@pytest.mark.parametrize("name", DATACLASS_MODULES)
def test_hetpu_plan_fields_exist(name):
    """Every annotated field of every dataclass of a hetpu module exists
    in the port's counterpart, save the stated exceptions (the classes
    themselves are held by test_hetpu_public_names_exist)."""
    import importlib
    ref = importlib.import_module(name)
    ports = [importlib.import_module(m) for m in MAPPED.get(
        name, (name.replace("hetpu", "hetpu_torch", 1),))]
    classes = {k: v for k, v in vars(ref).items()
               if dataclasses.is_dataclass(v) and v.__module__ == name}
    assert classes, name
    missing = []
    for k, cls in classes.items():
        if (name, k) in DO_NOT_PORT:
            continue
        pmod, pk = RENAMED.get((name, k), (None, k))
        where = [importlib.import_module(pmod)] if pmod else ports
        got = next(getattr(m, pk) for m in where if hasattr(m, pk))
        have = {f.name for f in dataclasses.fields(got)}
        lost = {f.name for f in dataclasses.fields(cls)} - have \
            - FIELDS_NOT_PORTED.get((name, k), set())
        missing += [f"{k}.{f}" for f in sorted(lost)]
    assert not missing, f"{name}: the port lacks {missing}"


def test_exceptions_name_hetpus_own():
    """Every stated exception names something hetpu has."""
    import importlib
    for mod, k in DO_NOT_PORT | set(RENAMED):
        assert hasattr(importlib.import_module(mod), k), (mod, k)
    for (mod, qual), ps in PARAMS_NOT_PORTED.items():
        obj = importlib.import_module(mod)
        for part in qual.split("."):
            obj = getattr(obj, part)
        assert ps <= _params(obj), (mod, qual)
    assert set(MAPPED) <= set(HETPU_MODULES)
    for (mod, cls), names in FIELDS_NOT_PORTED.items():
        fields = {f.name for f in dataclasses.fields(
            getattr(importlib.import_module(mod), cls))}
        assert names <= fields, (mod, cls)


# ----------------------------------------------------------------------
# the names ROADMAP queue 3 found missing, each against hetpu
# ----------------------------------------------------------------------

def test_utils_exports_timer():
    import hetpu.utils as ref_utils
    import hetpu_torch.utils as utils
    from hetpu_torch.utils.timer import Timer
    assert ref_utils.__all__ == ["Timer"]
    assert utils.Timer is Timer
    assert _methods(ref_utils.Timer).keys() <= _methods(utils.Timer).keys()
    t = utils.Timer()
    assert 0 <= t.tocr(torch.zeros(2)) < 60


@pytest.fixture(scope="module")
def tiny_pair():
    """hetpu's and the port's test_tiny sessions from one seed, and one
    ciphertext and plaintext of the same values in each."""
    from hetpu.session import Session as RefSession
    seed = b"\x05" * 32
    ref = RefSession.create("test_tiny", seed=seed, galois_steps=[])
    port = Session.create("test_tiny", seed=seed, galois_steps=[],
                          device="cpu")
    x = np.random.default_rng(3).uniform(-1, 1, (2, port.slots))
    cts = [s.encryptor.encrypt(s.encode(x[0]), seed=b"\x06" * 32)
           if s is ref else s.encrypt(x[0], seed=b"\x06" * 32)
           for s in (ref, port)]
    pts = [ref.encode(x[1]), port.encode(x[1])]
    return cts, pts


def test_poly_degree_and_np_data(tiny_pair):
    from hetpu.core import ciphertext as ref_ct
    from hetpu_torch.core import ciphertext
    (ref, ours), (rpt, opt) = tiny_pair
    assert ours.poly_degree == ref.poly_degree == 1024
    assert opt.poly_degree == rpt.poly_degree == 1024
    got, want = ciphertext.np_data(ours), ref_ct.np_data(ref)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ciphertext.np_data(opt),
                                  ref_ct.np_data(rpt))


def test_server_main_takes_workload(monkeypatch, capsys):
    """main(workload=None) as hetpu's: serves one request whatever it
    names and prints the same two lines (package name aside)."""
    from hetpu.offload import server as ref_server
    from hetpu_torch.offload import server
    for mod in (ref_server, server):
        assert list(inspect.signature(mod.main).parameters.items())[0][1] \
            .default is None
        monkeypatch.setattr(mod, "serve_once", lambda: "sum")
        mod.main(workload="ignored")
    lines = capsys.readouterr().out.splitlines()
    assert [ln.replace("hetpu_torch", "hetpu") for ln in lines[2:]] \
        == lines[:2]


def test_donation_audit(tiny_pair):
    """donation_audit is alias_audit under hetpu's name; an evaluator op
    shares no caller buffer in either package, and an output that is a
    view of an input is counted."""
    from hetpu.utils import debug as ref_debug
    from hetpu_torch.utils import debug
    (ref, ours), _ = tiny_pair
    assert debug.donation_audit is debug.alias_audit
    assert ref_debug.donation_audit(lambda a: a.data + a.data, ref) == 0
    assert debug.donation_audit(lambda a: a.data + a.data, ours) == 0
    assert debug.donation_audit(lambda a: a.data[0], ours,
                                expect_aliases=1) == 1
    with pytest.raises(AssertionError, match="aliasing"):
        debug.donation_audit(lambda a: a.data[0], ours)
