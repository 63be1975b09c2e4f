"""The benchmark's mixes at presets a CPU test run can hold: the same
entries, drivers and harness, with the configuration swapped for a tiny
preset (its primes, scheme and plain modulus taken from the port's preset
table) and the pool and batch cut.  The closed-loop inference mix is here
too: it has no cell in ``BENCHMARK.json`` yet, so its metrics' units are
given here.

A mix's tiny row is :data:`TINY`'s, or the ``"tiny"`` object of its mix
file: ``preset``, ``params``, ``limits`` and, where the scheme's class is
not float32, ``precision``; its metrics are its loop's."""

from __future__ import annotations

import json
import time

from hebench import harness

STREAM = (["ops_per_s", "setup_s"],
          ["plain_kernel_us_per_op", "pkg_kernel_us_per_op",
           "mul_op_roofline", "device_idle_share.ops",
           "decompose_us_per_op", "ks_tail_us_per_op",
           "pkg_kernel_roofline"])
CLOSED = (["requests_per_s", "request_p95_ms", "setup_s"],
          ["device_ms_per_request", "kernels_per_request",
           "device_idle_share.req"])
LOOPS = {"stream": STREAM, "closed": CLOSED}
CLOSED_UNITS = {"requests_per_s": "requests/s", "request_p95_ms": "ms",
                "device_ms_per_request": "ms/request",
                "kernels_per_request": "kernels/request",
                "device_idle_share.req": "%"}
# mix → (tiny preset, parameters, limit of max_abs_err there, metrics)
TINY = {
    "mul_stream": ("test_tiny", {"batch": 2, "pool": 2}, 1e-3, STREAM),
    "infer": ("test_deep", {"batch": 2, "pool": 2}, 1e-3, CLOSED),
}
SEED = 2**31 + 12345


def _mix(mix: str) -> dict:
    return json.loads((harness.HERE / "mixes" / f"{mix}.json").read_text())


def mixes() -> list:
    """Every mix with a tiny row: :data:`TINY`'s, then the mix files'."""
    files = sorted(p.stem for p in (harness.HERE / "mixes").glob("*.json"))
    return list(TINY) + [m for m in files
                         if m not in TINY and "tiny" in _mix(m)]


def cell(mix: str) -> harness.Cell:
    from hetpu_torch.core.params import preset
    m = _mix(mix)
    if mix in TINY:
        pre, params, limit, (e2e, per) = TINY[mix]
        limits, precision = {"max_abs_err": limit}, "float32"
    else:
        row = m["tiny"]
        pre, params, limits = row["preset"], row["params"], row["limits"]
        precision = row.get("precision", "float32")
        e2e, per = LOOPS[m["loop"]]
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    units = {**CLOSED_UNITS, **{x["name"]: x["unit"] for x in
                                bench["end_to_end"] + bench["per_layer"]}}
    p = preset(pre)
    cfg = {"preset": pre, "poly_degree": p.poly_degree,
           "moduli": list(p.moduli), "special_moduli": list(p.special_moduli),
           "rescale_group": p.rescale_group, "scheme": p.scheme.value,
           "plain_modulus": p.plain_modulus,
           "plain_factors": list(p.plain_factors), "precision": precision}
    return harness.Cell(
        name=f"tiny.{mix}", config=cfg, entry=m["entry"], loop=m["loop"],
        params={**m["params"], **params, "keep_within": 1, "trace_calls": 1},
        limits=limits, end_to_end=e2e, per_layer=per, units=units)


def run(mix: str, trace: bool = False, control: bool = False,
        seed: int = SEED) -> dict:
    return harness.run_cell(cell(mix), seed, 0.05, trace, "cpu",
                            time.perf_counter(), log=lambda s: None,
                            control=control)
