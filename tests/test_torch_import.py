"""Packaging contracts of hetpu_torch:

  * importing it (and running the slice on CPU tensors) pulls in neither
    JAX nor hetpu and builds nothing — checked in a fresh interpreter with
    no nvcc reachable;
  * CPU tensors take the plain paths: every kernel launch counter stays 0;
  * a tensor on any other device raises instead of falling back.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from hetpu_torch.core import cuda_lib, fused_ntt, ip_kernel
from hetpu_torch.core.context import Context
from hetpu_torch.core.ntt import ntt_fwd, ntt_inv
from hetpu_torch.core.params import preset
from hetpu_torch.session import Session

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def test_import_pulls_no_jax_and_builds_nothing(tmp_path):
    code = textwrap.dedent("""
        import sys
        import hetpu_torch, hetpu_torch.session, hetpu_torch.convert
        from hetpu_torch.core import cuda_lib
        from hetpu_torch.session import Session
        s = Session.create("test_tiny", seed=b"\\x01" * 32, galois_steps=[])
        ct = s.encrypt(0.5)
        out = s.ev.multiply_relin_rescale(ct, ct, s.rk)
        assert abs(s.decrypt(out).real - 0.25).max() < 1e-3
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


def test_cpu_tensors_never_launch():
    cuda_lib.reset_launches()
    ctx = Context(preset("test_dnum"))
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
    s = Session.create("test_tiny", seed=b"\x02" * 32, galois_steps=[])
    ct = s.encrypt(np.ones(4))
    s.decrypt(s.ev.square_relin_rescale(ct, s.rk))
    assert cuda_lib.launches == dict.fromkeys(cuda_lib.launches, 0)


def test_other_devices_raise():
    """No silent fallback: a tensor off the CPU and off CUDA (here the
    'meta' device) is refused, and so is a mix of devices."""
    ctx = Context(preset("test_tiny"))
    t = ctx.tables(0)
    with pytest.raises(ValueError, match="unsupported device"):
        ntt_fwd(torch.zeros((1, 1024), dtype=torch.int32, device="meta"), t)
    ext = torch.zeros((1, 2, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="different devices"):
        ip_kernel.inner_product(ext, torch.zeros((1, 2, 2, 8),
                                                 dtype=torch.int32,
                                                 device="meta"),
                                ext, ext)
