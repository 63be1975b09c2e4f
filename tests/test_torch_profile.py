"""hetpu's op-profiling programs in ``python -m hetpu_torch.bench``
(``profile_fused``, ``profile_hotpath``, ``op_parts_chain``,
``bench_sweep``, ``probe_n15``, ``probe_n15b``, ``probe_lsq_twice``,
``trace_op``) on the CPU, against hetpu at test_dnum (N=2^10, 8 data
primes, α=3), B=2, K=3:

  * every chain of every program leaves hetpu's final tag and last
    output, bit for bit, against a jitted ``lax.scan`` of that script's
    body with that script's fold on hetpu's functions (the bodies below
    cite the scripts' lines), from the same keys and encryptions;
    probe_n15b's directly dispatched op returns hetpu's output;
  * the folds equal the scripts' on random words;
  * probe_lsq_twice draws the script's points for both runs;
  * every subcommand at ``--small --cpu`` prints every label its script
    passes to ``chain`` / ``timeit`` / ``direct`` (its printed lines where
    it has none), read from the script's source, and writes its record;
  * every subcommand raises without a card and without ``--cpu``.

One hetpu session serves every chain: the scripts' seeds (0x21…, 0x77…)
repeat one byte, so they draw one key stream (ROADMAP queue 3), and the
chains use no Galois key.
"""

import ast
import importlib.util
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core import rns as ref_rns
from hetpu.core.modular import mod_add, mod_sub, shoup_mul
from hetpu.core.ntt import ntt_fwd, ntt_fwd_mont, ntt_inv
from hetpu.session import Session as RefSession
from hetpu_torch import bench
from hetpu_torch.bench import bench_sweep, probe_lsq_twice
from hetpu_torch.bench.__main__ import PROFILES, main
from hetpu_torch.core.modular import to_u32
from hetpu_torch.session import Session
from hetpu_torch.utils import keycache
from torch_app_cases import fixed_seeds, port_rnd, ref_rnd
from torch_profile_cases import B, K, port_chains

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = b"\x21" * 32


# ----------------------------------------------------------------------
# the scripts' folds
# ----------------------------------------------------------------------

def fold8(y):
    """profile_fused.py:35, probe_n15.py:36, probe_n15b.py:28."""
    return jnp.sum(y.reshape(-1)[:8], dtype=jnp.uint32) & jnp.uint32(1)


def fold_rows8(y):
    """profile_hotpath.py:52 (trace_op.py:22 and bench_sweep.py:28 on
    4-D outputs)."""
    return jnp.sum(y[..., :1, :1, :8] if y.ndim >= 3 else y,
                   dtype=jnp.uint32) & jnp.uint32(1)


def fold_parts8(y):
    """op_parts_chain.py:21."""
    return jnp.sum(y[..., :1, :8], dtype=jnp.uint32) & jnp.uint32(1)


def ref_scan(fn, x0, fold, k: int = K):
    """The scripts' chain as one jitted ``lax.scan`` of k steps from a zero
    tag, which also carries the last output: (tag, last output)."""
    shape = jax.eval_shape(fn, x0)

    @jax.jit
    def run(x):
        def body(carry, _):
            tag, _ = carry
            y = fn(jnp.bitwise_xor(x, tag))
            return (fold(y), y), ()
        (tag, last), _ = jax.lax.scan(
            body, (jnp.uint32(0), jnp.zeros(shape.shape, shape.dtype)),
            None, length=k)
        return tag, last
    tag, last = run(x0)
    return np.asarray(tag), np.asarray(last)


# ----------------------------------------------------------------------
# hetpu's side: the scripts' bodies at test_dnum, B=2
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sessions():
    ref = RefSession.create("test_dnum", seed=SEED, galois_steps=[1])
    port = Session.create("test_dnum", seed=SEED, galois_steps=[1],
                          device="cpu")
    with fixed_seeds("profile"):
        rng = np.random.default_rng(0)
        base = ref.encrypt(rng.uniform(-1, 1, ref.slots))
        b_ct = ref.encrypt(rng.uniform(-1, 1, ref.slots))
    return ref, port, base, b_ct


def _stack(ct, n):
    return ct.with_(data=jnp.stack([ct.data] * n))


def ref_profile_fused(ref, base, b_ct):
    """scripts/profile_fused.py:54-161 (B=2)."""
    ev, ctx = ref.ev, ref.ctx
    lvl = len(ctx.params.moduli) - 1
    L = lvl + 1
    tabs = ctx.tables(lvl)
    plan = ctx.keyswitch_plan(lvl)
    mdr = ctx.moddown_rescale_plan(lvl)
    J = plan.num_digits
    a, b = _stack(base, B), _stack(b_ct, B)
    m3 = ev.multiply(a, b)
    c2 = m3.data[..., 2, :, :]
    ext = ev._decompose(c2, lvl)
    accip = ev._inner_product_raw(ext, lvl, ref.rk.key)
    q = jnp.asarray(tabs.q)
    y0 = ntt_inv(c2, tabs, strip_mont=True, extra=plan.dig_inv)

    def lift_only(y):                                   # :92-104
        exts = []
        for di, (lo, hi) in enumerate(plan.digit_bounds):
            foreign = plan.foreign_idx[di]
            qf = plan.q[foreign]
            acc = None
            for i in range(lo, hi):
                term = shoup_mul(y[..., i:i + 1, :],
                                 plan.dhat[i][foreign][:, None],
                                 plan.dhat_shoup[i][foreign][:, None], qf)
                acc = term if acc is None else mod_add(acc, term, qf)
            exts.append(acc)
        return jnp.concatenate(exts, axis=-2)

    def fwd_foreign(lf):                                # :110-118
        outs = []
        o = 0
        for di in range(J):
            f = len(plan.foreign_idx[di])
            outs.append(ntt_fwd(lf[..., o:o + f, :] % jnp.asarray(
                plan.q[plan.foreign_idx[di]]), plan.foreign_tables[di]))
            o += f
        return jnp.concatenate(outs, axis=-2)

    def tail(acc):                                      # :126-140
        acc = acc % jnp.asarray(plan.q)
        c01 = m3.data[..., :2, :, :]
        w_data = mod_add(
            acc[..., :L, :],
            shoup_mul(c01, mdr.p_mod, mdr.p_mod_shoup, tabs.q), tabs.q)
        src = jnp.concatenate([w_data[..., L - 1: L, :], acc[..., L:, :]],
                              axis=-2)
        u = ntt_inv(src, mdr.src_tables, strip_mont=True,
                    extra=mdr.fbc.inv_punit)
        r_q = ref_rns.fbc_apply(u, mdr.fbc, correct=True, premul=False)
        r_m = ntt_fwd_mont(r_q, mdr.dst_tables)
        q_dst = mdr.dst_tables.q
        return shoup_mul(mod_sub(w_data[..., : L - 1, :], r_m, q_dst),
                         mdr.pq_inv, mdr.pq_inv_shoup, q_dst)

    src0 = jnp.concatenate([accip[..., L - 1: L, :], accip[..., L:, :]],
                           axis=-2)
    u0 = ntt_inv(src0, mdr.src_tables, strip_mont=True,
                 extra=mdr.fbc.inv_punit)
    rq0 = ref_rns.fbc_apply(u0, mdr.fbc, correct=True, premul=False)
    return {k: (f, x, fold8) for k, (f, x) in {
        "FULL multiply_relin_rescale": (lambda d: ev.multiply_relin_rescale(
            a.with_(data=d), b, ref.rk).data, a.data),
        "multiply (karatsuba)": (lambda d: ev.multiply(
            a.with_(data=d), b).data, a.data),
        "decompose total": (lambda d: ev._decompose(d % q, lvl), c2),
        "  intt L planes": (lambda d: ntt_inv(
            d % q, tabs, strip_mont=True, extra=plan.dig_inv), c2),
        "  fbc lift (shoup loop)": (lift_only, y0),
        "  ntt_fwd foreign (19 planes)": (fwd_foreign, lift_only(y0)),
        "inner_product_raw": (lambda d: ev._inner_product_raw(
            d % jnp.asarray(plan.q), lvl, ref.rk.key), ext),
        "moddown+rescale tail": (tail, accip),
        "  intt src (12 planes)": (lambda d: ntt_inv(
            d % jnp.asarray(mdr.src_tables.q), mdr.src_tables,
            strip_mont=True, extra=mdr.fbc.inv_punit), src0),
        "  fbc moddown (6->8 x2)": (lambda d: ref_rns.fbc_apply(
            d % jnp.asarray(mdr.fbc.p), mdr.fbc, correct=True,
            premul=False), u0),
        "  ntt_fwd_mont (16 planes)": (lambda d: ntt_fwd_mont(
            d % jnp.asarray(mdr.dst_tables.q), mdr.dst_tables), rq0),
        "baseline: x % q [B,L,N]": (lambda d: d % q, c2),
        "baseline: shoup [B,L,N]": (lambda d: shoup_mul(
            d % q, tabs.r, tabs.r_shoup, q), c2),
    }.items()}


def ref_profile_hotpath(ref, base, b_ct):
    """scripts/profile_hotpath.py:33-93 (BATCH=2)."""
    ev = ref.ev
    a, b = _stack(base, B), _stack(b_ct, B)
    m3 = ev.multiply(a, b)
    lvl = a.level
    L = lvl + 1
    plan = ref.ctx.keyswitch_plan(lvl)
    c2 = m3.data[..., 2, :, :]
    ext = ev._decompose(c2, lvl)
    tabs = ref.ctx.tables(lvl)
    x = a.data[..., 0, :, :]
    kb = plan.basis_tables
    R = len(kb.primes)
    y = jnp.tile(x[..., :1, :], (1, plan.num_digits * R // 1, 1))[
        ..., :plan.num_digits * R, :].reshape(
        B, plan.num_digits, R, ref.ctx.params.poly_degree) % jnp.uint32(
        kb.primes[0])
    return {k: (f, x0, fold_rows8) for k, (f, x0) in {
        "multiply_relin_rescale": (lambda d: ev.multiply_relin_rescale(
            a.with_(data=d), b, ref.rk).data, a.data),
        "multiply": (lambda d: ev.multiply(a.with_(data=d), b).data, a.data),
        "relinearize": (lambda d: ev.relinearize(
            m3.with_(data=d), ref.rk).data, m3.data),
        "rescale(2part)": (lambda d: ev.rescale(a.with_(data=d)).data,
                           a.data),
        "  decompose (INTT+FBC+NTT)": (lambda d: ev._decompose(d, lvl), c2),
        "  inner_product (+moddown)": (lambda d: jnp.stack(
            ev._inner_product(d, lvl, ref.rk.key), -3), ext),
        f"  ntt_fwd  [B,{L},N]": (lambda d: ntt_fwd(d, tabs), x),
        f"  ntt_inv  [B,{L},N]": (lambda d: ntt_inv(
            d, tabs, strip_mont=True), x),
        f"  ntt_fwd key basis [B,{plan.num_digits},{R},N]": (
            lambda d: ntt_fwd(d, kb), y),
    }.items()}


def ref_op_parts_chain(ref, base, b_ct):
    """scripts/op_parts_chain.py:42-67 (the first batch, B=2)."""
    ev = ref.ev
    a, b = _stack(base, B), _stack(b_ct, B)
    m3 = ev.multiply(a, b)
    lvl = a.level
    c2 = m3.data[..., 2, :, :]
    ext = ev._decompose(c2, lvl)
    return {k: (f, x0, fold_parts8) for k, (f, x0) in {
        "full multiply_relin_rescale": (lambda d: ev.multiply_relin_rescale(
            a.with_(data=d), b, ref.rk).data, a.data),
        "multiply only": (lambda d: ev.multiply(a.with_(data=d), b).data,
                          a.data),
        "decompose": (lambda d: ev._decompose(d[..., 0, :, :], lvl),
                      m3.data),
        "inner_product_raw": (lambda d: ev._inner_product_raw(
            d, lvl, ref.rk.key), ext),
        "relin+rescale fused (from 3part)": (lambda d: ev._relin_rescale_fused(
            m3.with_(data=d), ref.rk).data, m3.data),
    }.items()}


def ref_step_rows8(ref, base, b_ct):
    """scripts/bench_sweep.py:19-30 and trace_op.py:14-22: the op on a
    (data XOR tag), ``out.data[..., :1, :1, :8]`` folded."""
    a, b = _stack(base, B), _stack(b_ct, B)
    return (lambda d: ref.ev.multiply_relin_rescale(
        a.with_(data=d), b, ref.rk).data, a.data, fold_rows8)


def ref_probe_n15(ref, base, b_ct):
    """scripts/probe_n15.py:62-111 (B 1 and 2)."""
    ev, ctx = ref.ev, ref.ctx
    lvl = len(ctx.params.moduli) - 1
    tabs = ctx.tables(lvl)
    plan = ctx.keyswitch_plan(lvl)
    q = jnp.asarray(tabs.q)
    x2 = base.data % q
    x16 = jnp.stack([x2] * 8)
    out = {"ntt_fwd rows=2  [2,L,N]": (lambda d: ntt_fwd(d % q, tabs), x2),
           "ntt_fwd rows=16 [8,2,L,N]": (lambda d: ntt_fwd(d % q, tabs),
                                         x16)}
    for n in (1, B):
        a, b = (base, b_ct) if n == 1 else (_stack(base, n), _stack(b_ct, n))
        out[f"fused mult_relin_rescale B={n}"] = (
            lambda d, a=a, b=b: ev.multiply_relin_rescale(
                a.with_(data=d), b, ref.rk).data, a.data)
    m3 = ev.multiply(base, b_ct)
    c2 = m3.data[..., 2, :, :]
    ext = ev._decompose(c2, lvl)
    qr = jnp.asarray(plan.q)
    out.update({
        "multiply B=1": (lambda d: ev.multiply(
            base.with_(data=d), b_ct).data, base.data),
        "decompose B=1": (lambda d: ev._decompose(d % q, lvl), c2),
        "inner_product_raw B=1": (lambda d: ev._inner_product_raw(
            d % qr, lvl, ref.rk.key), ext),
        "relin+rescale tail B=1": (lambda d: ev._relin_rescale_fused(
            m3.with_(data=jnp.stack([m3.data[..., p, :, :] for p in range(3)],
                                    axis=-3) ^ (d[..., :1, :, :] * 0)),
            ref.rk).data, m3.data)})
    return {k: (f, x0, fold8) for k, (f, x0) in out.items()}


def ref_probe_n15b(ref, base, b_ct):
    """scripts/probe_n15b.py:63-126; the direct call's output under
    ``FULL fused op B=1``."""
    ev, ctx = ref.ev, ref.ctx
    lvl = len(ctx.params.moduli) - 1
    tabs = ctx.tables(lvl)
    plan = ctx.keyswitch_plan(lvl)
    q = jnp.asarray(tabs.q)
    m3 = ev.multiply(base, b_ct)
    c2 = m3.data[..., 2, :, :]
    ext = ev._decompose(c2, lvl)
    qr = jnp.asarray(plan.q)
    accip = ev._inner_product_raw(ext, lvl, ref.rk.key)
    mdr = ctx.moddown_rescale_plan(lvl)
    L = lvl + 1
    g = ctx.params.rescale_group

    def tail(acc):                                      # :100-114
        acc = acc % qr
        c01 = m3.data[..., :2, :, :]
        w_data = mod_add(
            acc[..., :L, :],
            shoup_mul(c01, mdr.p_mod, mdr.p_mod_shoup, tabs.q), tabs.q)
        src = jnp.concatenate([w_data[..., L - g: L, :], acc[..., L:, :]],
                              axis=-2)
        u = ntt_inv(src, mdr.src_tables, strip_mont=True,
                    extra=mdr.fbc.inv_punit)
        r_q = ref_rns.fbc_apply(u, mdr.fbc, correct=True, premul=False)
        r_m = ntt_fwd_mont(r_q, mdr.dst_tables)
        q_dst = mdr.dst_tables.q
        return shoup_mul(mod_sub(w_data[..., : L - g, :], r_m, q_dst),
                         mdr.pq_inv, mdr.pq_inv_shoup, q_dst)

    y0 = ntt_inv(c2, tabs, strip_mont=True, extra=plan.dig_inv)
    qf_cat = jnp.asarray(plan.foreign_cat_tables.q)
    xcat = jnp.concatenate(
        [y0[..., :1, :]] * plan.foreign_cat_tables.q.shape[0], axis=-2)
    out = {k: (f, x0, fold8) for k, (f, x0) in {
        "multiply B=1": (lambda d: ev.multiply(
            base.with_(data=d), b_ct).data, base.data),
        "decompose B=1": (lambda d: ev._decompose(d % q, lvl), c2),
        "inner_product_raw B=1": (lambda d: ev._inner_product_raw(
            d % qr, lvl, ref.rk.key), ext),
        "moddown+rescale tail B=1": (tail, accip),
        "  intt 25 planes": (lambda d: ntt_inv(
            d % q, tabs, strip_mont=True, extra=plan.dig_inv), c2),
        "  ntt_fwd foreign-cat planes": (lambda d: ntt_fwd(
            d % qf_cat, plan.foreign_cat_tables), xcat),
    }.items()}
    out["FULL fused op B=1"] = ev.multiply_relin_rescale(
        base, b_ct, ref.rk).data
    return out


REF = {"profile_fused": ref_profile_fused,
       "profile_hotpath": ref_profile_hotpath,
       "op_parts_chain": ref_op_parts_chain,
       "bench_sweep": lambda *a: {"B=2 K=3": ref_step_rows8(*a)},
       "trace_op": lambda *a: {"step": ref_step_rows8(*a)},
       "probe_n15": ref_probe_n15, "probe_n15b": ref_probe_n15b}


LABELS = {
    "profile_fused": [
        "FULL multiply_relin_rescale", "multiply (karatsuba)",
        "decompose total", "  intt L planes", "  fbc lift (shoup loop)",
        "  ntt_fwd foreign (19 planes)", "inner_product_raw",
        "moddown+rescale tail", "  intt src (12 planes)",
        "  fbc moddown (6->8 x2)", "  ntt_fwd_mont (16 planes)",
        "baseline: x % q [B,L,N]", "baseline: shoup [B,L,N]"],
    "profile_hotpath": [
        "multiply_relin_rescale", "multiply", "relinearize",
        "rescale(2part)", "  decompose (INTT+FBC+NTT)",
        "  inner_product (+moddown)", "  ntt_fwd  [B,8,N]",
        "  ntt_inv  [B,8,N]", "  ntt_fwd key basis [B,3,11,N]"],
    "op_parts_chain": [
        "full multiply_relin_rescale", "multiply only", "decompose",
        "inner_product_raw", "relin+rescale fused (from 3part)"],
    "bench_sweep": ["B=2 K=3"],
    "trace_op": ["step"],
    "probe_n15": [
        "ntt_fwd rows=2  [2,L,N]", "ntt_fwd rows=16 [8,2,L,N]",
        "fused mult_relin_rescale B=1", "fused mult_relin_rescale B=2",
        "multiply B=1", "decompose B=1", "inner_product_raw B=1",
        "relin+rescale tail B=1"],
    "probe_n15b": [
        "FULL fused op B=1", "multiply B=1", "decompose B=1",
        "inner_product_raw B=1", "moddown+rescale tail B=1",
        "  intt 25 planes", "  ntt_fwd foreign-cat planes"],
}
CASES = [(p, label) for p, labels in LABELS.items() for label in labels]


@pytest.fixture(scope="module")
def both(sessions):
    """program → (hetpu's chains, the port's), built on first use."""
    ref, port, base, b_ct = sessions
    memo = {}

    def get(program):
        if program not in memo:
            memo[program] = (REF[program](ref, base, b_ct),
                             port_chains(program, port, (ref_rnd, port_rnd)))
        return memo[program]
    return get


@pytest.mark.parametrize("program,label", CASES,
                         ids=[f"{p}:{lb.strip()}" for p, lb in CASES])
def test_chain_equals_hetpus(both, program, label):
    """K chained steps through the harness leave hetpu's tag and last
    output, from the same keys and inputs."""
    refs, ports = both(program)
    assert set(refs) == set(ports) == set(LABELS[program])
    if program == "probe_n15b" and label == "FULL fused op B=1":
        got = ports[label]()
        np.testing.assert_array_equal(to_u32(got), np.asarray(refs[label]))
        return
    fn, x0, fold = refs[label]
    tag, last = ref_scan(fn, x0, fold)
    c = ports[label]
    np.testing.assert_array_equal(to_u32(c.x0), np.asarray(x0))
    r = bench.timed(c, K, reps=1, eager=False)
    assert r["steps"] == K and r["seconds"] > 0
    assert c.tag.shape == () and tag.shape == ()
    np.testing.assert_array_equal(to_u32(c.tag), tag)
    np.testing.assert_array_equal(to_u32(c.out), last)
    assert last.any()


@pytest.mark.parametrize("fold,ref_fold", [
    (bench.fold8, fold8), (bench.fold_rows8, fold_rows8),
    (bench.fold_parts8, fold_parts8)], ids=["fold8", "rows8", "parts8"])
def test_folds_equal_the_scripts(fold, ref_fold):
    rng = np.random.default_rng(15)
    shapes = [(3, 16), (2, 3, 64), (3, 2, 5, 16), (2, 3, 2, 4, 9)]
    for shape in shapes if fold is bench.fold_parts8 else [(8,)] + shapes:
        y = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        got = fold(None, torch.from_numpy(y.view(np.int32)))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(ref_fold(jnp.asarray(y)))


def test_best_of_leaves_k_steps_from_zero(sessions):
    """best_of's windows each start from a zero tag: the chain ends at
    K steps from zero, as one ``timed`` window of K does."""
    _, port, _, _ = sessions
    with fixed_seeds("profile"):
        ops = bench_sweep.operands(port)
    one, three = (bench_sweep.chain(port, *ops, B) for _ in range(2))
    bench.timed(one, K, reps=1, eager=False)
    r = bench.best_of(three, K, reps=3, eager=False)
    assert len(r["window_seconds"]) == 3
    assert r["seconds"] == min(r["window_seconds"]) > 0
    assert torch.equal(one.tag, three.tag) and torch.equal(one.out, three.out)


def _script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"hetpu_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lsq_draws_the_scripts_points(sessions):
    """probe_lsq_twice's two runs fit the points that
    scripts/probe_lsq_twice.py:18-25 draws from its one rng(0)."""
    _, port, _, _ = sessions
    script = _script("probe_lsq_twice")
    drawn = []

    class Recorder:
        slots = port.slots

        def encrypt(self, v):
            drawn.append(np.array(v))
            return v

        def decrypt(self, v):
            return np.zeros(1, dtype=complex)

    script.least_squares_2d = lambda *a, **kw: (0, 0)
    rng = np.random.default_rng(0)
    for _ in range(2):
        script.run_once(Recorder(), rng)
    rng = np.random.default_rng(0)
    for run in range(2):
        _, _, px, py = probe_lsq_twice.points(port, rng)
        np.testing.assert_array_equal(px, drawn[2 * run])
        np.testing.assert_array_equal(py, drawn[2 * run + 1])


# ----------------------------------------------------------------------
# the CLI: every label of the script printed, the record written
# ----------------------------------------------------------------------

def _pattern(node) -> str:
    """A label or printed line of a script as a regex: constants literal,
    formatted values any text."""
    if isinstance(node, ast.Constant):
        return re.escape(node.value)
    return "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                   else ".+?" for v in node.values)


def script_labels(name: str) -> list[str]:
    """The first argument of every ``chain`` / ``timeit`` / ``direct``
    call of scripts/<name>.py, or where it has none its printed strings,
    as regexes."""
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.args
             and isinstance(n.args[0], (ast.Constant, ast.JoinedStr))]
    labels = [c.args[0] for c in calls
              if c.func.id in ("chain", "timeit", "direct")]
    if not labels:
        labels = [c.args[0] for c in calls if c.func.id == "print"]
    return [_pattern(n) for n in labels]


@pytest.mark.parametrize("program", list(PROFILES))
def test_small_cli_prints_the_scripts_labels(program, tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path / "keys")
    out = tmp_path / f"{program}.json"
    assert main([program, "--small", "--cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.splitlines()
    labels = script_labels(program)
    assert labels, program
    for pat in labels:
        assert any(re.match(pat, ln) for ln in lines), (pat, lines)
    record = json.loads(out.read_text())
    assert (record["device"], record["card"]) == ("cpu", None)
    for ln in lines:
        if ln.startswith('{"program"'):
            r = json.loads(ln)
            assert r["device"] == "cpu" and r["grown_bytes"] == 0
            assert r["chained_ms_per_step"] > 0
    if program in ("probe_n15", "probe_n15b"):
        keys = {k for k in record if k not in ("device", "card")}
        assert keys and all(any(re.fullmatch(p + r"( \(dispatch\))?", k)
                                for p in labels) for k in keys), keys
    if program == "probe_lsq_twice":
        tree = ast.parse((REPO / "scripts" / "probe_lsq_twice.py")
                         .read_text())
        want = next({k.value for k in n.keys} for n in ast.walk(tree)
                    if isinstance(n, ast.Dict) and n.keys)
        assert want <= set(record)
        assert record["max_err"] < probe_lsq_twice.MAX_ERR
        assert record["first_run_s"] > 0 and record["warm_process_s"] > 0
    if program == "trace_op":
        assert (out.with_suffix("") / "trace.json").exists()


@pytest.mark.parametrize("program", list(PROFILES))
def test_without_cpu_and_card_raises(program, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main([program, "--small"])
