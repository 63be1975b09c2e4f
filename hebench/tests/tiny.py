"""The benchmark's mixes at presets a CPU test run can hold: the same
entries, drivers and harness, with the configuration swapped for a tiny
preset (its primes taken from the port's preset table) and the pool and
batch cut.  The closed-loop inference mix is here too: it has no cell in
``BENCHMARK.json`` yet, so its metrics' units are given here."""

from __future__ import annotations

import json
import time

from hebench import harness

STREAM = (["ops_per_s", "setup_s"],
          ["plain_kernel_us_per_op", "pkg_kernel_us_per_op",
           "mul_op_roofline", "device_idle_share.ops"])
CLOSED = (["requests_per_s", "request_p95_ms", "setup_s"],
          ["device_ms_per_request", "kernels_per_request",
           "device_idle_share.req"])
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


def cell(mix: str) -> harness.Cell:
    from hetpu_torch.core.params import preset
    pre, params, limit, (e2e, per) = TINY[mix]
    m = json.loads((harness.HERE / "mixes" / f"{mix}.json").read_text())
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    units = {**CLOSED_UNITS, **{x["name"]: x["unit"] for x in
                                bench["end_to_end"] + bench["per_layer"]}}
    p = preset(pre)
    cfg = {"preset": pre, "poly_degree": p.poly_degree,
           "moduli": list(p.moduli), "special_moduli": list(p.special_moduli),
           "rescale_group": p.rescale_group, "scheme": "ckks",
           "precision": "float32"}
    return harness.Cell(
        name=f"tiny.{mix}", config=cfg, entry=m["entry"], loop=m["loop"],
        params={**m["params"], **params, "keep_within": 1, "trace_calls": 1},
        limits={"max_abs_err": limit}, end_to_end=e2e, per_layer=per,
        units=units)


def run(mix: str, trace: bool = False, control: bool = False,
        seed: int = SEED) -> dict:
    return harness.run_cell(cell(mix), seed, 0.05, trace, "cpu",
                            time.perf_counter(), log=lambda s: None,
                            control=control)
