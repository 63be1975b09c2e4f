"""``python -m hetpu_torch.bench`` (the port of ``bench.py``,
``scripts/bench_secondary.py`` and ``scripts/bench_workloads.py``) on the
CPU, against hetpu at test_dnum (N=2^10, 8 data primes, α=3), B=2, K=3:

  * the headline chain (multiply_relin_rescale, every output element
    folded into the next input) leaves hetpu's final tag and last output,
    bit for bit, against a jitted ``lax.scan`` of ``bench.py:69-80``'s
    body with its own ``fold_into``;
  * the sampled-fold chains of ``rotate``, ``rotate_hoisted`` and
    ``ntt_fwd_mont`` leave the tag and last output of
    ``scripts/bench_secondary.py:20-36``'s chain body on hetpu's ops;
  * ``workloads --small --cpu`` writes every section and key that
    ``scripts/bench_workloads.py`` writes (its names read from its code);
  * ``headline`` and ``secondary`` print hetpu's metric lines;
  * every program raises without a card and without ``--cpu``.

One hetpu session (the full ±2^i keyset) serves every chain, so hetpu
compiles each op once for the module.
"""

import ast
import importlib.util
import json
import math
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core.ntt import ntt_fwd_mont as ref_ntt_fwd_mont
from hetpu.session import Session as RefSession
from hetpu_torch import bench
from hetpu_torch.bench import headline, secondary, workloads
from hetpu_torch.bench.__main__ import main
from hetpu_torch.core.modular import to_u32
from hetpu_torch.session import Session
from hetpu_torch.utils import keycache
from torch_app_cases import fixed_seeds

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SEED = b"\x22" * 32
B, K = 2, 3


@pytest.fixture(scope="module")
def sessions():
    ref = RefSession.create("test_dnum", seed=SEED)
    port = Session.create("test_dnum", seed=SEED, device="cpu")
    return ref, port


def bench_py_fold_into():
    """bench.py's ``fold_into`` (nested in its ``main``), rebuilt from its
    code object with the jax and jnp it closes over."""
    spec = importlib.util.spec_from_file_location("hetpu_bench_py",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    code = next(c for c in mod.main.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == "fold_into")
    free = {"jax": jax, "jnp": jnp}
    return types.FunctionType(code, mod.__dict__, "fold_into", None,
                              tuple(types.CellType(free[v])
                                    for v in code.co_freevars))


def ref_scan(fn, x0, tag0, fold, k: int = K):
    """hetpu's chain as one jitted ``lax.scan`` of k steps from ``tag0``:
    the body of bench.py / bench_secondary.py, which also carries the last
    output; returns (tag, last output)."""
    shape = jax.eval_shape(fn, x0)

    @jax.jit
    def run(x, tag0):
        def body(carry, _):
            tag, _ = carry
            y = fn(jnp.bitwise_xor(x, tag))
            return (fold(x, y), y), ()
        (tag, last), _ = jax.lax.scan(
            body, (tag0, jnp.zeros(shape.shape, shape.dtype)), None,
            length=k)
        return tag, last
    tag, last = run(x0, tag0)
    return np.asarray(tag), np.asarray(last)


def sampled_fold(x, y):
    """bench_secondary.py:25."""
    return jnp.sum(y.reshape(-1)[:8], dtype=jnp.uint32) & jnp.uint32(1)


def ref_headline(ref):
    with fixed_seeds("headline"):
        rng = np.random.default_rng(0)
        base = ref.encrypt(rng.uniform(-1, 1, ref.slots))
        b_ct = ref.encrypt(rng.uniform(-1, 1, ref.slots))
    a = base.with_(data=jnp.stack([base.data] * B))
    b = b_ct.with_(data=jnp.stack([b_ct.data] * B))
    fn = lambda da: ref.ev.multiply_relin_rescale(  # noqa: E731
        a.with_(data=da), b, ref.rk).data
    return a.data, ref_scan(fn, a.data, jnp.zeros_like(a.data),
                            bench_py_fold_into())


def ref_secondary(ref, name):
    """bench_secondary.py's inputs (one rng: an encryption, then the NTT's
    residues) and the chain of ``name``."""
    with fixed_seeds("secondary"):
        rng = np.random.default_rng(0)
        ct = ref.encrypt(rng.uniform(-1, 1, ref.slots))
    a = ct.with_(data=jnp.stack([ct.data] * B))
    tabs = ref.ctx.tables_full
    x = jnp.stack([jnp.asarray(rng.integers(
        0, tabs.primes[i], ref.ctx.params.poly_degree, dtype=np.uint32))
        for i in range(len(tabs.primes))])
    q = jnp.asarray(tabs.q)
    x0, fn = {
        "rotate": (a.data, lambda d: ref.ev.rotate(
            a.with_(data=d), 1, ref.gk).data),
        "rotate_hoisted": (a.data, lambda d: ref.ev.rotate_hoisted(
            a.with_(data=d), secondary.HOIST_STEPS, ref.gk)[-1].data),
        "ntt_fwd_mont": (jnp.stack([x] * B),
                         lambda d: ref_ntt_fwd_mont(d % q, tabs)),
    }[name]
    return x0, ref_scan(fn, x0, jnp.uint32(0), sampled_fold)


def port_chain(port, name):
    if name == "multiply_relin_rescale":
        with fixed_seeds("headline"):
            return headline.chain(port, *headline.operands(port, B))
    with fixed_seeds("secondary"):
        chains = secondary.chains(port, B, np.random.default_rng(0))
    return next(c for c, _, _ in chains.values() if c.name == name)


@pytest.mark.parametrize("name", ["multiply_relin_rescale", "rotate",
                                  "rotate_hoisted", "ntt_fwd_mont"])
def test_chain_equals_hetpus(sessions, name):
    """K chained steps through the harness leave hetpu's tag and last
    output, from the same keys and inputs."""
    ref, port = sessions
    if name == "multiply_relin_rescale":
        x0, (tag, last) = ref_headline(ref)
    else:
        x0, (tag, last) = ref_secondary(ref, name)
    c = port_chain(port, name)
    np.testing.assert_array_equal(to_u32(c.x0), np.asarray(x0))
    r = bench.timed(c, K, reps=1, eager=False)
    assert r["steps"] == K and r["seconds"] > 0
    assert tuple(c.tag.shape) == tag.shape
    np.testing.assert_array_equal(to_u32(c.tag), tag)
    np.testing.assert_array_equal(to_u32(c.out), last)
    assert last.any()


def test_fold8_equals_hetpus():
    rng = np.random.default_rng(8)
    for shape in [(8,), (2, 3, 64), (3, 2, 5, 16)]:
        y = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(sampled_fold(None, jnp.asarray(y)))
        got = bench.fold8(None, torch.from_numpy(y.view(np.int32)))
        assert got.dtype == torch.int32 and got.shape == ()
        assert int(got) == int(want)


# ----------------------------------------------------------------------
# the record's names, read from scripts/bench_workloads.py's code
# ----------------------------------------------------------------------

def _consts(node) -> list | None:
    if isinstance(node, (ast.Tuple, ast.Set, ast.List)) and node.elts and \
            all(isinstance(e, ast.Constant) for e in node.elts):
        return [e.value for e in node.elts]
    return None


def _dict_keys(node) -> set:
    return {k.value for d in ast.walk(node) if isinstance(d, ast.Dict)
            for k in d.keys if isinstance(k, ast.Constant)} - {"error"}


def hetpu_record_names() -> dict:
    """section → (its keys, each key's keys or None), as
    scripts/bench_workloads.py writes them."""
    tree = ast.parse((REPO / "scripts" / "bench_workloads.py").read_text())
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    sections = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                    and n.targets[0].id == "SECTIONS")
    loops = lambda f: next(_consts(n.iter) for n in ast.walk(f)  # noqa
                           if isinstance(n, ast.For) and _consts(n.iter))
    out = {}
    for key, fn in zip(sections.keys, sections.values):
        f = fns[fn.id]
        if key.value == "keygen":
            out["keygen"] = {n: _dict_keys(f) for n in loops(f)}
        elif key.value in ("workloads", "fft"):
            out[key.value] = {n: None for n in loops(f)}
        elif key.value == "sweep":
            want = next(_consts(n.value) for n in ast.walk(f)
                        if isinstance(n, ast.Assign)
                        and getattr(n.targets[0], "id", "") == "want")
            out["sweep"] = {f"levels_{lv}": None for lv in want}
        elif key.value == "secondary":
            out["secondary"] = {
                t.slice.value: None for n in ast.walk(f)
                if isinstance(n, ast.Assign) for t in n.targets
                if isinstance(t, ast.Subscript)
                and isinstance(t.slice, ast.Constant)}
        else:
            cfgs = {g.name: g for g in ast.walk(f)
                    if isinstance(g, ast.FunctionDef)}
            out[key.value] = {
                c.args[0].value: _dict_keys(next(
                    r for r in ast.walk(cfgs[c.args[1].id])
                    if isinstance(r, ast.Return)))
                for c in ast.walk(f) if isinstance(c, ast.Call)
                and getattr(c.func, "id", "") == "_guard"}
    return out


def _numbers(obj):
    if isinstance(obj, dict):
        return [x for v in obj.values() for x in _numbers(v)]
    return [obj]


@pytest.fixture(scope="module")
def small_record(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench_workloads")
    saved = keycache.CACHE_DIR
    keycache.CACHE_DIR = tmp / "keys"
    try:
        assert main(["workloads", "--small", "--cpu",
                     "--out", str(tmp / "record.json")]) == 0
    finally:
        keycache.CACHE_DIR = saved
    return json.loads((tmp / "record.json").read_text())


@pytest.mark.parametrize("section", list(workloads.SECTIONS))
def test_small_record_has_hetpus_names(small_record, section):
    want = hetpu_record_names()
    assert set(want) == set(workloads.SECTIONS)
    got = small_record[section]
    meta = small_record["meta"]
    assert (meta["platform"], meta["device"], meta["card"],
            meta["small"]) == ("cpu", "cpu", None, True)
    assert all(isinstance(x, (int, float)) and math.isfinite(x)
               for x in _numbers(got)), got
    if section == "keygen":
        assert set(workloads.KEYGEN_PRESETS) == set(want["keygen"])
        assert set(got) == set(workloads.KEYGEN_PRESETS.values())
        for full, small in workloads.KEYGEN_PRESETS.items():
            assert set(got[small]) == want["keygen"][full]
    elif section == "sweep":
        # --small sweeps N=2^13 to level 6: hetpu's levels up to 6
        assert set(got) == {"levels_2", "levels_6"} <= set(want["sweep"])
        for times in got.values():
            assert set(times) == {"pt_ct_add", "ct_ct_add", "pt_ct_mult",
                                  "ct_ct_mult", "relin", "rescale"}
    else:
        assert set(got) == set(want[section])
        for name, fields in want[section].items():
            if fields is not None:
                assert set(got[name]) == fields, name
            elif section in ("workloads", "fft"):
                assert "total_wall_s" in got[name] and len(got[name]) > 1
    if section == "secondary":
        assert got["enc_matvec64_max_err"] < 1e-2


@pytest.mark.parametrize("program,metrics", [
    ("headline", [headline.METRIC]),
    ("secondary", list(secondary.K))])
def test_program_prints_hetpus_metric_lines(program, metrics, tmp_path,
                                            monkeypatch, capsys):
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path)
    assert main([program, "--small", "--cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    got = [ln for ln in lines if "metric" in ln]
    assert [ln["metric"] for ln in got] == metrics
    for ln in got:
        assert ln["device"] == "cpu" and ln["value"] > 0
        assert ln["unit"] in ("ops/s", "planes/s")
    assert all(ln["device"] == "cpu" for ln in lines if "program" in ln)


@pytest.mark.parametrize("argv", [["headline"], ["secondary", "--small"],
                                  ["workloads", "--only", "keygen"]])
def test_without_cpu_and_card_raises(argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
