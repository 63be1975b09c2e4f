"""The plain reference: its transform against the definition, its lift
on values of either sign, its decryption against the port's, and each
cell's control against the cell's limit."""

import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hebench.reference import ckks


def test_ntt_matches_the_definition():
    """Index i holds a(ψ^(2·br(i)+1)), ψ the least primitive 2N-th root;
    the inverse undoes it."""
    n, q = 16, 97
    psi = ckks.least_root_2n(q, n)
    assert pow(psi, n, q) == q - 1
    assert psi == min(x for x in range(2, q)
                      if pow(x, n, q) == q - 1 and pow(x, 2 * n, q) == 1)
    b = ckks.Basis.make(n, (q,), "cpu")
    a = torch.randint(0, q, (3, 1, n), dtype=torch.int64)
    got = ckks.ntt(a, b)
    br = [int(f"{i:04b}"[::-1], 2) for i in range(n)]
    for i in range(n):
        pt = pow(psi, 2 * br[i] + 1, q)
        want = sum(int(a[0, 0, j]) * pow(pt, j, q) for j in range(n)) % q
        assert int(got[0, 0, i]) == want
    assert torch.equal(ckks.intt(got, b), a)


def test_lift_recovers_signed_values():
    primes = (2147352577, 1073643521, 1073479681, 1073184769)
    v = [0, 1, -1, 2**40 + 3, -(2**61) + 5, 2**61 - 7, -123456789]
    r = torch.tensor([[[x % q for x in v] for q in primes]],
                     dtype=torch.int64)
    val, bad = ckks.lift(r, primes)
    assert val[0].tolist() == [float(x) for x in v]
    assert int(bad.sum()) == 0
    r[0, 3, 2] += 1                       # one limb off
    assert int(ckks.lift(r, primes)[1].sum()) == 1


@pytest.mark.parametrize("preset", ["test_tiny", "test_deep"])
def test_decrypt_agrees_with_the_port(preset):
    from hetpu_torch.session import Session
    seed = bytes(range(32))
    sess = Session.create(preset, seed=seed, galois_steps=[], device="cpu")
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (2, sess.slots))
    cts = [sess.encrypt(v, seed=bytes([i]) * 32) for i, v in enumerate(x)]
    ct = cts[0].with_(data=torch.stack([c.data for c in cts]))
    ct = sess.ev.multiply_relin_rescale(ct, ct, sess.rk)
    slots, bad = ckks.decrypt(ct.data, torch.tensor([ct.scale] * 2,
                                                     dtype=torch.float64),
                              seed, sess.ctx.params.moduli)
    assert int(bad.sum()) == 0
    np.testing.assert_allclose(slots.numpy(), sess.decrypt(ct), rtol=0,
                               atol=1e-12)
    assert float((slots - torch.tensor(x * x)).abs().max()) < 1e-3


ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _streams():
    mixes = ROOT / "hebench/mixes"
    return [w for w in BENCH["workloads"] if json.loads(
        (mixes / f"{w['traffic']}.json").read_text())["entry"]
        == "mul_stream"]


@pytest.mark.parametrize("w", _streams(), ids=lambda w: w["name"])
def test_control_fails_at_the_cells_limit(w):
    """The control of each op stream's configuration, on 8 rows of the
    cell's slots drawn as its mix draws them, reads beyond the cell's
    limit."""
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    mix = json.loads((ROOT / "hebench/mixes" / f"{w['traffic']}.json")
                     .read_text())
    own = json.loads((ROOT / "hebench/workloads" / f"{w['name']}.json")
                     .read_text())
    expected = importlib.import_module(
        f"hebench.reference.{mix['entry']}").expected
    ref = importlib.import_module(f"hebench.reference.{cfg['scheme']}")
    rng = np.random.default_rng(5)
    lo, hi = mix["params"]["value_range"]
    shape = (8, cfg["poly_degree"] // 2)
    a = ckks.Answer(data=None, scales=[], slots=shape[1],
                    inputs={"x": rng.uniform(lo, hi, shape),
                            "y": rng.uniform(lo, hi, shape)})
    j = ref.judge(ref.control_values([a], expected, cfg, "cpu"),
                  [a], expected, "cpu")
    assert j["checks"]["max_abs_err"] > own["limits"]["max_abs_err"]
