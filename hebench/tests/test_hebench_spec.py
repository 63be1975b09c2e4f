"""BENCHMARK.json against the contract's shape, and every cell, config,
mix, entry and metric in it found by name."""

import json
import math
import re
from pathlib import Path

import pytest

from hebench import counts, harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves"}}


def test_top_level_and_entries():
    assert set(BENCH) == {"command", "paths", "run_seconds", *KEYS}
    assert BENCH["paths"] == ["hebench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for kind, keys in KEYS.items():
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names)), kind
        for e in BENCH[kind]:
            assert set(e) - {"workloads"} == keys, e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(w):
    import importlib
    c = harness.find_cell(w)
    assert c.end_to_end and "setup_s" in c.end_to_end and c.per_layer
    importlib.import_module(f"hebench.entries.{c.entry}")
    importlib.import_module(f"hebench.reference.{c.entry}")
    ref = importlib.import_module(f"hebench.reference.{c.config['scheme']}")
    assert all(callable(getattr(ref, f))
               for f in ("values", "control_values", "judge"))
    assert isinstance(ref.CALIBRATED, str)
    assert c.config["reduced"] == []
    own = json.loads((ROOT / "hebench" / "workloads" / f"{w}.json")
                     .read_text())
    assert own["why"] == next(x["why"] for x in BENCH["workloads"]
                              if x["name"] == w)


@pytest.mark.parametrize("m", [m["name"] for m in BENCH["end_to_end"]
                               + BENCH["per_layer"]])
def test_metric_reader_found_by_name(m):
    assert callable(harness.reader(m))


def _ckks_fields(cfg: dict, p) -> None:
    assert 2.0 ** cfg["scale_bits"] == p.scale


def _bfv_fields(cfg: dict, p) -> None:
    assert cfg["plain_modulus"] == p.plain_modulus
    assert cfg["plain_factors"] == list(p.plain_factors)


SCHEME_FIELDS = {"ckks": _ckks_fields, "bfv": _bfv_fields}


def holds_the_preset(cfg: dict) -> None:
    """A configuration states its preset: the primes, the ring, the
    rescale group and the log QP bound for every scheme, then its scheme's
    own fields (CKKS: the scale; BFV: t and its factors)."""
    from hetpu_torch.core.params import preset
    p = preset(cfg["preset"])
    assert cfg["scheme"] == p.scheme.value
    assert cfg["moduli"] == list(p.moduli)
    assert cfg["special_moduli"] == list(p.special_moduli)
    assert cfg["poly_degree"] == p.poly_degree
    assert cfg["rescale_group"] == p.rescale_group
    assert cfg["log_qp"] <= cfg["log_qp_bound_128"]
    SCHEME_FIELDS[cfg["scheme"]](cfg, p)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_holds_the_preset(c):
    holds_the_preset(json.loads((ROOT / c["file"]).read_text()))


def _bfv_batch() -> dict:
    """A BFV configuration as a file would state the port's ``bfv_batch``
    (N=2^14, 7 data primes, 2 special, t the product of two 30-bit
    primes)."""
    from hetpu_torch.core.params import preset
    p = preset("bfv_batch")
    return {"preset": "bfv_batch", "scheme": "bfv",
            "poly_degree": p.poly_degree, "moduli": list(p.moduli),
            "special_moduli": list(p.special_moduli),
            "rescale_group": p.rescale_group,
            "plain_modulus": p.plain_modulus,
            "plain_factors": list(p.plain_factors),
            "log_qp": round(sum(math.log2(q) for q in p.moduli
                                + p.special_moduli), 2),
            "log_qp_bound_128": 438}


def test_bfv_config_holds_the_preset():
    cfg = _bfv_batch()
    assert cfg["log_qp"] == pytest.approx(273.0, abs=0.05)
    assert len(cfg["plain_factors"]) == 2
    holds_the_preset(cfg)


def test_bfv_config_with_a_wrong_t_is_refused():
    cfg = _bfv_batch()
    cfg["plain_modulus"] += 2
    with pytest.raises(AssertionError):
        holds_the_preset(cfg)


def test_least_bytes_of_the_op():
    """The hand values: 221.8 MB a call at ckks_n14_l8 B=64, 359 MB at
    ckks_n15_deep B=16; 180,879,360 B at bfv_batch B=64, whose output
    keeps all 7 limbs."""
    n14 = json.loads((ROOT / "hebench/configs/ckks_n14_l8.json").read_text())
    n15 = json.loads((ROOT / "hebench/configs/ckks_n15_deep.json")
                     .read_text())
    assert round(counts.mul_call_bytes(n14, 64) / 1e6, 1) == 221.8
    assert round(counts.mul_call_bytes(n15, 16) / 1e6) == 359
    assert counts.bound_seconds(counts.mul_call_bytes(n14, 64)) == \
        pytest.approx(0.0662e-3, rel=1e-3)
    assert counts.mul_call_bytes(_bfv_batch(), 64) == 180_879_360
