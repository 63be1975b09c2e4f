"""Port-side checks of ``hetpu_torch.demos`` (hetpu's BFV takes ~46 s a
square on the CPU, so its demos run on the port alone here):

  * the four BFV demos at ``--small --cpu`` decrypt exactly (each demo
    holds its result against numpy's and prints ``exact: True``) with a
    noise budget left;
  * the CLI dispatches every suite and name of ``python -m hetpu.demos``,
    returns 1 with hetpu's messages on usage, an unknown suite or an
    unknown demo, and raises without ``--cpu`` when there is no card;
  * ``bench_he_all`` and ``bench_he_all_chained`` return six positive
    times at test_tiny;
  * the chain's tag fold equals hetpu's ``fold_into`` (the XOR reduce
    nested in its ``bench_he_all_chained``) on seeded arrays;
  * the transport's ``serve`` calls ``on_listen`` once the socket
    listens, so a client started then connects without retries.
"""

import contextlib
import io
import re
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hetpu.demos.__main__ as ref_cli
from hetpu.demos import bfv_operations as ref_bfv_ops
from hetpu.demos import fft as ref_fft
from hetpu.demos import math_operations as ref_math_ops
from hetpu.demos import matrix_operations as ref_matrix_ops
from hetpu.demos import offload_demos as ref_offload
from hetpu_torch import bench
from hetpu_torch.core.modular import from_u32
from hetpu_torch.demos import (bfv_operations, fft, math_operations,
                               matrix_operations, offload_demos)
from hetpu_torch.demos.__main__ import main
from hetpu_torch.runtime import native
from hetpu_torch.session import Session

torch.set_num_threads(1)

OPS = {"pt_ct_add", "ct_ct_add", "pt_ct_mult", "ct_ct_mult", "relin",
       "rescale"}


def printed(fn, argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("name", ["elemwise_square", "matmul",
                                  "batch_matmul_bfv", "matpow"])
def test_bfv_demo_exact(name):
    rc, text = printed(main, ["matrix_operations", name, "--small", "--cpu"])
    assert rc == 0
    assert re.findall(r"exact: (\w+)", text) == ["True"], text
    budgets = [int(b) for b in re.findall(r"noise budget [^:]*: (-?\d+) bits",
                                          text)]
    assert len(budgets) == 2 and min(budgets) > 0, text


def test_every_hetpu_demo_dispatches():
    """The same suites (the usage line) and the same names in each."""
    pairs = [(ref_matrix_ops, matrix_operations),
             (ref_bfv_ops, bfv_operations), (ref_math_ops, math_operations),
             (ref_fft, fft)]
    for ref, port in pairs:
        assert list(port.DEMOS) == list(ref.DEMOS)
    assert offload_demos.CLIENT_DEMOS == ref_offload.CLIENT_DEMOS
    assert bfv_operations.DEMOS["matpow_bfv"] is matrix_operations.demo_matpow
    ref_rc, ref_text = printed(ref_cli.main, [])
    rc, text = printed(main, [])
    suites = lambda t: [ln for ln in t.splitlines() if ln.startswith("suites")]
    assert rc == ref_rc == 1
    assert suites(text) == suites(ref_text) != []


@pytest.mark.parametrize("argv", [["no_such_suite", "op"],
                                  ["matrix_operations", "no_such_demo"],
                                  ["fft"], ["math_operations", "op"]])
def test_unknown_suite_or_demo_returns_1(argv):
    got = printed(main, argv + ["--small", "--cpu"])
    assert got == printed(ref_cli.main, argv + ["--small"])
    assert got[0] == 1 and got[1].startswith("unknown ")


def test_without_cpu_and_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the demos run on it")
    for argv in (["matrix_operations", "op", "--small"],
                 ["server", "simple", "--small"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(argv)


@pytest.fixture(scope="module")
def tiny():
    return Session.create("test_tiny", seed=b"\x45" * 32, galois_steps=[1],
                          device="cpu")


@pytest.mark.parametrize("bench,kw", [
    (math_operations.bench_he_all, dict(reps=2)),
    (math_operations.bench_he_all_chained, dict(K=2, reps=2))])
def test_bench_returns_six_positive_times(tiny, bench, kw):
    times = bench(tiny, **kw)
    assert set(times) == OPS
    assert all(np.isfinite(t) and t > 0 for t in times.values()), times


def ref_fold_into():
    """hetpu's ``fold_into``: the function nested in its
    ``bench_he_all_chained``, rebuilt from its code object with the jax
    and jnp it closes over."""
    code = next(c for c in ref_math_ops.bench_he_all_chained.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "fold_into")
    free = {"jax": jax, "jnp": jnp}
    return types.FunctionType(code, ref_math_ops.__dict__, "fold_into", None,
                              tuple(types.CellType(free[v])
                                    for v in code.co_freevars))


@pytest.mark.parametrize("x_shape,y_shape", [
    ((2, 3, 64), (2, 3, 64)),            # one chunk
    ((2, 3, 64), (3, 3, 64)),            # three chunks, no padding
    ((2, 3, 64), (3, 5, 64)),            # padded last chunk
    ((2, 4, 32), (2, 3, 4, 32))])        # the relin case: 3 parts into 2
def test_fold_equals_hetpus(x_shape, y_shape):
    rng = np.random.default_rng(sum(y_shape))
    x0 = rng.integers(0, 1 << 32, x_shape, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, y_shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(ref_fold_into()(jnp.asarray(x0), jnp.asarray(y)))
    got = bench.fold_into(from_u32(x0, "cpu"), from_u32(y, "cpu"))
    assert got.dtype == torch.int32 and tuple(got.shape) == x_shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_serve_calls_on_listen_before_accept():
    port = 18231
    listening = threading.Event()
    served = []

    def server():
        t, p = native.serve(port, port,
                            on_listen=lambda p: listening.set())
        served.append(p)
        t.send(t.recv())
        t.close()

    th = threading.Thread(target=server)
    th.start()
    try:
        assert listening.wait(timeout=30)
        t = native.connect(port, port, retries=0)
        t.send(b"frame")
        assert t.recv() == b"frame"
        t.close()
    finally:
        th.join(timeout=30)
    assert not th.is_alive() and served == [port]
