"""Packaging contracts of hetpu_torch:

  * importing it (every module, and running the slice and the probes on
    CPU tensors) pulls in neither JAX nor hetpu and builds nothing — checked in a fresh
    interpreter with no nvcc reachable;
  * the card's scripts (``chip_smoke.py``, ``kernel_ab.py``) import
    neither JAX nor hetpu;
  * CPU tensors take the plain paths: every kernel launch counter stays 0;
  * a tensor on any other device raises instead of falling back;
  * the entry points run on the card unless given ``device="cpu"``, and
    raise where there is none.
"""

import ast
import inspect
import os
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
        assert cuda_lib._lib is None
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
    convert.*, the serial loaders that take no context and cached_session
    default to device="cuda"; without a card they raise instead of falling
    back."""
    for fn in (Session.create, Session.from_wire, Context.__init__,
               BfvSession.create, convert.secret_key, convert.public_key,
               convert.kswitch_key, convert.relin_keys, convert.galois_keys,
               convert.ciphertext, convert.plaintext, serial.load_public_key,
               serial.load_plaintext, cached_session):
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
                     type("Ct", (), dict(data=arr, level=0, scale=1.0)))):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
