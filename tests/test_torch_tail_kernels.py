"""K7 ``tensor_product`` and K8 ``ks_tail``: their plain twins, the
evaluator functions that call them, and the kernels' 32-bit arithmetic,
each against hetpu bit for bit, at test_dnum (N=2^10, 8 data primes, 3
special primes of 31 bits) and at test_dnum with rescale_group=2 (two
anchors; the paired-prime divide):

  (a) ``tensor_product_plain`` (2×2, the square, and a 3×2 product) and
      the port's ``Evaluator.multiply`` / ``square`` against hetpu's
      jitted ``Evaluator.multiply`` / ``square``; the multiply-and-
      accumulate twin ``tensor_product_acc_plain`` against the product
      summed by hetpu's ``mod_add`` (at test_tiny and bench_n14's primes);
  (b) the K8 twins against the reference's steps (``hetpu.core.modular``
      on the same inputs, edge residues 0 and q−1 included), and the
      port's ``_relin_rescale_fused``, ``_mod_down`` and
      ``_div_round_last`` against hetpu's, at g=1 and g=2;
  (c) ``redc_u32``, ``shoup_u32`` and ``barrett_u32`` — the kernels'
      REDC, Shoup and Barrett spelled step by step in int64 (lo/hi split,
      carry, one conditional subtract) — against hetpu's 16-bit-emulated
      ``mont_mul`` / ``shoup_mul`` / ``barrett_reduce_u32`` on a seeded
      grid that holds 0, 1, q−1 and the largest prime of each preset.

The kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py): a wrong algorithm in them shows here first, through (c).
Inputs are uniform residues from numpy seeds; keys are random residues
with their true Shoup companions (the functions are exact for any keys).
"""

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core import evaluator as ref_evaluator
from hetpu.core import modular as ref_modular
from hetpu.core.ciphertext import Ciphertext as RefCiphertext
from hetpu.core.context import Context as RefContext
from hetpu.core.evaluator import Evaluator as RefEvaluator
from hetpu.core.keys import KSwitchKey as RefKSwitchKey
from hetpu.core.keys import RelinKeys as RefRelinKeys
from hetpu.core.params import preset as ref_preset
from hetpu_torch import convert
from hetpu_torch.core import cuda_lib, evaluator, ks_tail
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import (from_u32, mont_constants,
                                      shoup_precompute, to_u32, u32)
from hetpu_torch.core.params import preset
from hetpu_torch.core.tensor_product import (redc_u32, tensor_product,
                                             tensor_product_acc,
                                             tensor_product_acc_plain,
                                             tensor_product_plain)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B = 2
PRESET = "test_dnum"
G2 = dict(rescale_group=2, num_anchor=2)


@pytest.fixture(scope="module")
def env():
    """Contexts and evaluators of both packages at g=1 and g=2."""
    out = {}
    for g, kw in ((1, {}), (2, G2)):
        rp = dataclasses.replace(ref_preset(PRESET), **kw)
        pp = dataclasses.replace(preset(PRESET), **kw)
        rctx, ctx = RefContext(rp), Context(pp, "cpu")
        out[g] = (rctx, RefEvaluator(rctx), ctx, Evaluator(ctx))
    return out


def _res(rng, shape, primes, edges: bool = False) -> np.ndarray:
    """Uniform residues [..., L, N] below the per-limb primes; ``edges``
    puts 0 and q−1 at the first and last x of every plane."""
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    x = (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % q)
    if edges:
        x[..., 0] = 0
        x[..., -1] = (q - 1)[:, 0]
    return x.astype(np.uint32)


def _eq(got: torch.Tensor, want, msg=""):
    np.testing.assert_array_equal(to_u32(got), np.asarray(want), err_msg=msg)


# ----------------------------------------------------------------------
# (a) K7's twin and the evaluator's multiply / square
# ----------------------------------------------------------------------

@pytest.mark.parametrize("level", [7, 3])
@pytest.mark.parametrize("form", ["product", "square", "3x2"])
def test_tensor_product_plain_vs_hetpu(env, level, form):
    rctx, rev, ctx, ev = env[1]
    primes = ctx.params.moduli[: level + 1]
    rng = np.random.default_rng(100 + level)
    ka = 3 if form == "3x2" else 2
    x = _res(rng, (B, ka, level + 1, 1024), primes, edges=True)
    y = x if form == "square" else _res(rng, (B, 2, level + 1, 1024), primes,
                                        edges=True)
    ra = RefCiphertext(data=jnp.asarray(x), level=level, scale=2.0)
    rb = RefCiphertext(data=jnp.asarray(y), level=level, scale=2.0)
    want = rev.square(ra) if form == "square" else rev.multiply(ra, rb)
    mc = ctx.mont(level)
    xt, yt = from_u32(x), from_u32(y)
    got = tensor_product_plain(xt, None if form == "square" else yt,
                               mc["q"], mc["r_inv"])
    _eq(got, want.data, "tensor_product_plain")
    _eq(tensor_product(xt, None if form == "square" else yt, mc["q"],
                       mc["r_inv"], mc["qinv_neg"]), want.data,
        "tensor_product on the CPU")
    pa = convert.ciphertext(ra, "cpu")
    port = ev.square(pa) if form == "square" else \
        ev.multiply(pa, convert.ciphertext(rb, "cpu"))
    _eq(port.data, want.data, "Evaluator")
    assert (port.level, port.scale) == (want.level, want.scale)


def test_square_form_is_the_self_product(env):
    """The kernel's square flag reads x once; its twin must equal the
    product of x with itself (Karatsuba and 2·c0·c1 give one residue)."""
    _, _, ctx, _ = env[1]
    mc = ctx.mont(7)
    x = from_u32(_res(np.random.default_rng(7), (B, 2, 8, 1024),
                      ctx.params.moduli, edges=True))
    assert torch.equal(tensor_product_plain(x, None, mc["q"], mc["r_inv"]),
                       tensor_product_plain(x, x, mc["q"], mc["r_inv"]))


@pytest.mark.parametrize("form", ["init", "broadcast", "full_batch"])
@pytest.mark.parametrize("preset_name", ["test_tiny", "bench_n14"])
def test_tensor_product_acc_plain_is_the_product_then_mod_add(preset_name,
                                                              form):
    """K7's multiply-and-accumulate twin (and its wrapper on the CPU) over
    the preset's data primes: ``init`` one step from no sum; the others
    four steps into one sum, y a one-row diagonal [2, L, N] against x
    [B, 2, L, N] (``broadcast``) or a y of every row (``full_batch``).
    Each equals the loop of ``tensor_product_plain`` on y copied to x's
    rows and hetpu's ``mod_add``, bit for bit, and updates the sum in
    place."""
    primes = preset(preset_name).moduli
    mc = {k: from_u32(v) for k, v in mont_constants(primes).items()}
    q_np = mont_constants(primes)["q"]
    n = preset(preset_name).poly_degree
    rng = np.random.default_rng(len(primes) * 10 + len(form))
    steps = 1 if form == "init" else 4
    ylead = (B,) if form == "full_batch" else ()
    xs = [from_u32(_res(rng, (B, 2, len(primes), n), primes, edges=True))
          for _ in range(steps)]
    ys = [from_u32(_res(rng, (*ylead, 2, len(primes), n), primes,
                        edges=True)) for _ in range(steps)]
    want = None
    for x, y in zip(xs, ys):
        prod = to_u32(tensor_product_plain(
            x, y.expand_as(x).contiguous(), mc["q"], mc["r_inv"]))
        want = prod if want is None else np.asarray(
            ref_modular.mod_add(jnp.asarray(want), jnp.asarray(prod),
                                jnp.asarray(q_np)))
    for fn in (lambda acc, x, y: tensor_product_acc_plain(
                   acc, x, y, mc["q"], mc["r_inv"]),
               lambda acc, x, y: tensor_product_acc(
                   acc, x, y, mc["q"], mc["r_inv"], mc["qinv_neg"])):
        acc = None
        for x, y in zip(xs, ys):
            out = fn(acc, x, y)
            assert acc is None or out is acc          # in place
            acc = out
        assert acc.shape == (B, 3, len(primes), n)
        _eq(acc, want)


@pytest.mark.parametrize("form", ["init", "diagonal", "full_batch"])
def test_tensor_product_acc_launch_arguments(form, monkeypatch):
    """The card wrapper's launch, every tensor taken for a card tensor and
    no launch made: a one-row y (a slice of a diagonal-layout batch) is
    passed where it lies at a row stride of 0, a y of every row at one of
    2·L·N words; the sum is the caller's own tensor (or a new one, with
    init); the bytes are x, y once, the sum read unless init, the sum
    written."""
    made = []
    monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "launch", lambda kernel, fn, dev, *args,
                        nbytes: made.append((kernel, fn, args, nbytes)))
    L, n, rows = 3, 64, 5
    mc = {k: from_u32(v) for k, v in mont_constants(
        preset("test_tiny").moduli[:L]).items()}
    x = torch.zeros((rows, 2, L, n), dtype=torch.int32)
    diags = torch.zeros((4, 2, L, n), dtype=torch.int32)
    y = x.clone() if form == "full_batch" else diags[2]
    acc = None if form == "init" else torch.zeros((rows, 3, L, n),
                                                  dtype=torch.int32)
    out = tensor_product_acc(acc, x, y, mc["q"], mc["r_inv"], mc["qinv_neg"])
    assert out.shape == (rows, 3, L, n) and (acc is None or out is acc)
    [(kernel, fn, args, nbytes)] = made
    assert (kernel, fn) == ("tensor_product_acc", "hetpu_tensor_product_acc")
    y_row = 2 * L * n if form == "full_batch" else 0
    assert args == (x.data_ptr(), y.data_ptr(), y_row,
                    mc["q"].data_ptr(), mc["qinv_neg"].data_ptr(),
                    out.data_ptr(), rows, L, n, int(form == "init"))
    y_planes = (rows if form == "full_batch" else 1) * 2 * L
    acc_read = 0 if form == "init" else rows * 3 * L
    assert nbytes == 4 * n * (rows * 2 * L + y_planes + acc_read
                              + rows * 3 * L)


def test_tensor_product_acc_imports_nothing_more():
    """A card launch of the multiply-and-accumulate (faked) loads no
    module beyond the port's: ``torch.broadcast_shapes`` would import
    sympy on its first call, seconds of a cell's set-up."""
    code = textwrap.dedent("""
        import sys, torch
        from hetpu_torch.core import cuda_lib
        from hetpu_torch.core.tensor_product import tensor_product_acc
        cuda_lib.on_card = lambda *t: True
        cuda_lib.launch = lambda *a, nbytes: None
        before = set(sys.modules)
        q = torch.ones((3, 1), dtype=torch.int32)
        x = torch.zeros((4, 2, 3, 64), dtype=torch.int32)
        acc = tensor_product_acc(None, x, x[1], q, q, q)
        tensor_product_acc(acc, x, x, q, q, q)
        print(sorted(set(sys.modules) - before))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# ----------------------------------------------------------------------
# (b) K8's twins against the reference's steps, and the evaluator's tails
# ----------------------------------------------------------------------

def _j(a):
    return jnp.asarray(to_u32(a))


def _ref_shoup(x, w, ws, q):
    return ref_modular.shoup_mul(x, _j(w), _j(ws), _j(q))


@pytest.mark.parametrize("g", [1, 2])
def test_tail_twins_vs_reference_steps(env, g):
    """tail_src_plain and tail_out_plain = hetpu's steps of
    ``_relin_rescale_fused`` (:426-438) on random acc, c01 and r_m."""
    rctx, _, ctx, _ = env[g]
    level = 7
    L, k = level + 1, ctx.num_special
    plan = ctx.moddown_rescale_plan(level)
    rng = np.random.default_rng(200 + g)
    basis = ctx.params.moduli[:L] + ctx.params.special_moduli
    acc = _res(rng, (B, 2, L + k, 1024), basis, edges=True)
    ct = _res(rng, (B, 3, L, 1024), ctx.params.moduli[:L], edges=True)
    r_m = _res(rng, (B, 2, L - g, 1024), ctx.params.moduli[: L - g],
               edges=True)
    q = ctx.tables(level).q
    qj = _j(q)
    w_data = ref_modular.mod_add(
        jnp.asarray(acc)[..., :L, :],
        _ref_shoup(jnp.asarray(ct)[..., :2, :, :], plan.p_mod,
                   plan.p_mod_shoup, q), qj)
    want_src = jnp.concatenate([w_data[..., L - g: L, :],
                                jnp.asarray(acc)[..., L:, :]], axis=-2)
    q_dst = _j(plan.dst_tables.q)
    want_out = _ref_shoup(ref_modular.mod_sub(w_data[..., : L - g, :],
                                              jnp.asarray(r_m), q_dst),
                          plan.pq_inv, plan.pq_inv_shoup, plan.dst_tables.q)
    a, c, r = from_u32(acc), from_u32(ct), from_u32(r_m)
    for fn in (ks_tail.tail_src_plain, ks_tail.tail_src):
        _eq(fn(a, c, g, plan.p_mod, plan.p_mod_shoup, q), want_src,
            fn.__name__)
    for fn in (ks_tail.tail_out_plain, ks_tail.tail_out):
        _eq(fn(a, c, r, plan.p_mod, plan.p_mod_shoup, plan.pq_inv,
               plan.pq_inv_shoup, q), want_out, fn.__name__)


@pytest.mark.parametrize("case", ["moddown", "rescale"])
def test_sub_mul_and_lift_last_vs_reference_steps(env, case):
    """sub_mul_plain = hetpu's ``_mod_down`` divide (:464-465) and
    ``_div_round_last``'s (:494-495); lift_last_plain = the latter's
    middle (:490-492), on random inputs with edge residues."""
    rctx, _, ctx, _ = env[1]
    level = 6
    rng = np.random.default_rng(300)
    if case == "moddown":
        md = ctx.keyswitch_plan(level).moddown
        basis = ctx.params.moduli[: level + 1] + ctx.params.special_moduli
        x = _res(rng, (B, 2, len(basis), 1024), basis, edges=True)
        dst, w, ws = md.dst_tables.q, md.p_inv, md.p_inv_shoup
    else:
        plan = ctx.rescale_plan(level)
        x = _res(rng, (B, 2, level + 1, 1024),
                 ctx.params.moduli[: level + 1], edges=True)
        dst, w, ws = plan.dst_tables.q, plan.src_inv, plan.src_inv_shoup
    Lo = dst.shape[0]
    r = _res(rng, (B, 2, Lo, 1024), to_u32(dst)[:, 0], edges=True)
    want = _ref_shoup(ref_modular.mod_sub(jnp.asarray(x)[..., :Lo, :],
                                          jnp.asarray(r), _j(dst)),
                      w, ws, dst)
    for fn in (ks_tail.sub_mul_plain, ks_tail.sub_mul):
        _eq(fn(from_u32(x), from_u32(r), w, ws, dst), want, fn.__name__)
    if case == "rescale":
        last = _res(rng, (B, 2, 1, 1024), ctx.params.moduli[level:level + 1],
                    edges=True)
        v = ref_modular.barrett_reduce_u32(
            ref_modular.mod_add(jnp.asarray(last), _j(plan.half),
                                _j(plan.src_tables.q)), _j(dst), _j(plan.mu))
        want = ref_modular.mod_sub(v, _j(plan.half_mod), _j(dst))
        for fn in (ks_tail.lift_last_plain, ks_tail.lift_last):
            _eq(fn(from_u32(last), plan.half, plan.src_tables.q, dst,
                   plan.mu, plan.half_mod), want, fn.__name__)


def _keys(rng, ctx, rctx):
    """Random relin keys over the full key basis with true companions,
    in both packages' form."""
    basis = ctx.params.moduli + ctx.params.special_moduli
    J = ctx.keyswitch_plan(ctx.num_data - 1).num_digits
    k = _res(rng, (J, 2, len(basis), 1024), basis)
    ks = shoup_precompute(k, np.array(basis, dtype=np.uint64)
                          .reshape(-1, 1))
    rk = RefRelinKeys(key=RefKSwitchKey(data=jnp.asarray(k),
                                        shoup=jnp.asarray(ks)))
    return rk, convert.relin_keys(rk, "cpu")


@pytest.mark.parametrize("g", [1, 2])
def test_relin_rescale_fused_vs_hetpu(env, g):
    rctx, rev, ctx, ev = env[g]
    rng = np.random.default_rng(400 + g)
    rk, prk = _keys(rng, ctx, rctx)
    level = 7
    x = _res(rng, (B, 3, level + 1, 1024), ctx.params.moduli, edges=True)
    rct = RefCiphertext(data=jnp.asarray(x), level=level, scale=2.0 ** 60)
    want = jax.jit(rev._relin_rescale_fused)(rct, rk)
    got = ev._relin_rescale_fused(convert.ciphertext(rct, "cpu"), prk)
    _eq(got.data, want.data)
    assert (got.level, got.scale) == (want.level, want.scale)


@pytest.mark.parametrize("g", [1, 2])
def test_mod_down_and_div_round_last_vs_hetpu(env, g):
    """``_mod_down`` over the key basis (relinearize's) and, at g=2, the
    pair rescale's; ``_div_round_last`` at g=1 (rescale, BFV's
    mod_switch)."""
    rctx, _, ctx, _ = env[g]
    rng = np.random.default_rng(500 + g)
    level = 7
    k = ctx.num_special
    basis = ctx.params.moduli[: level + 1] + ctx.params.special_moduli
    acc = _res(rng, (B, 2, len(basis), 1024), basis, edges=True)
    md = rctx.keyswitch_plan(level).moddown
    want = jax.jit(lambda a: ref_evaluator._mod_down(a, md, k))(
        jnp.asarray(acc))
    got = evaluator._mod_down(from_u32(acc), ctx.keyswitch_plan(level).moddown,
                              k)
    _eq(got, want, "key-switch mod-down")
    data = _res(rng, (B, 2, level + 1, 1024), ctx.params.moduli, edges=True)
    if g == 2:
        md = rctx.group_rescale_plan(level)
        want = jax.jit(lambda a: ref_evaluator._mod_down(a, md, 2))(
            jnp.asarray(data))
        got = evaluator._mod_down(from_u32(data),
                                  ctx.group_rescale_plan(level), 2)
        _eq(got, want, "pair rescale")
    else:
        plan = rctx.rescale_plan(level)
        want = jax.jit(lambda a: ref_evaluator._div_round_last(a, plan))(
            jnp.asarray(data))
        got = evaluator._div_round_last(from_u32(data),
                                        ctx.rescale_plan(level))
        _eq(got, want, "div_round_last")


# ----------------------------------------------------------------------
# (c) the kernels' 32-bit arithmetic, step by step
# ----------------------------------------------------------------------

GRID_PRESETS = ("test_tiny", "test_dnum", "test_bfv_crt", "bench_n14")


def _grid(rng, q: int, top: int) -> np.ndarray:
    """0, 1, q−1, q−2, ⌊q/2⌋ and 251 seeded values below ``top``."""
    fixed = [0, 1, q - 1, q - 2, q // 2]
    return np.concatenate([np.array(fixed, dtype=np.uint64),
                           rng.integers(0, top, 251, dtype=np.uint64)])


@pytest.mark.parametrize("preset_name", GRID_PRESETS)
def test_kernel_arithmetic_vs_hetpu(preset_name):
    p = preset(preset_name)
    primes = sorted(set(p.moduli + p.special_moduli), reverse=True)
    rng = np.random.default_rng(600)
    mc = mont_constants(primes)
    for i, q in enumerate(primes):
        a = _grid(rng, q, q)
        A, Bv = np.meshgrid(a, a[::-1].copy())             # every pair
        A, Bv = A.ravel(), Bv.ravel()
        qn = int(mc["qinv_neg"][i, 0])
        want = ref_modular.mont_mul(jnp.asarray(A, jnp.uint32),
                                    jnp.asarray(Bv, jnp.uint32),
                                    jnp.uint32(q), jnp.uint32(qn))
        t = lambda v: torch.from_numpy(v.astype(np.int64))
        got = redc_u32(t(A), t(Bv), q, qn)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"REDC q={q}")
        # Shoup: x over all 32 bits, w a residue with its companion
        x = _grid(rng, q, 1 << 32)
        x[-1] = (1 << 32) - 1
        w = _grid(rng, q, q)
        X, W = (v.ravel() for v in np.meshgrid(x, w))
        ws = shoup_precompute(W.astype(np.uint32),
                              np.uint64(q)).astype(np.uint64)
        want = ref_modular.shoup_mul(jnp.asarray(X, jnp.uint32),
                                     jnp.asarray(W, jnp.uint32),
                                     jnp.asarray(ws, jnp.uint32),
                                     jnp.uint32(q))
        got = ks_tail.shoup_u32(t(X), t(W), t(ws), q)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"Shoup q={q}")
        mu = (1 << 32) // q
        want = ref_modular.barrett_reduce_u32(jnp.asarray(x, jnp.uint32),
                                              jnp.uint32(q), jnp.uint32(mu))
        got = ks_tail.barrett_u32(t(x), q, mu)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"Barrett q={q}")
        np.testing.assert_array_equal(got.numpy(), x % q)


def test_kernel_arithmetic_on_residue_tensors():
    """The emulations take the port's int32 storage through ``u32`` and
    agree with the plain twins' int64 arithmetic on whole planes."""
    ctx = Context(preset(PRESET), "cpu")
    mc = ctx.mont(7)
    rng = np.random.default_rng(700)
    a = from_u32(_res(rng, (2, 8, 1024), ctx.params.moduli, edges=True))
    b = from_u32(_res(rng, (2, 8, 1024), ctx.params.moduli, edges=True))
    q, qn, rinv = u32(mc["q"]), u32(mc["qinv_neg"]), u32(mc["r_inv"])
    got = redc_u32(u32(a), u32(b), q, qn)
    assert torch.equal(got, u32(a) * u32(b) % q * rinv % q)
    plan = ctx.rescale_plan(7)
    w, ws, qd = u32(plan.src_inv), u32(plan.src_inv_shoup), \
        u32(plan.dst_tables.q)
    x = u32(a[..., :7, :])
    assert torch.equal(ks_tail.shoup_u32(x, w, ws, qd), x * w % qd)

