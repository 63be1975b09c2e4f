"""One run of one cell: find it by name, set up, measure, trace, judge.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
``workloads``, its configuration (the file ``configs`` names), its mix
``mixes/<traffic>.json`` (whose ``entry`` names the driver
``entries/<entry>.py`` and the plain math ``reference/<entry>.py``), its
own ``workloads/<cell>.json`` (parameters, limits, why), the comparison
of its configuration's scheme ``reference/<scheme>.py`` and one reader
``metrics/<metric>.py`` a metric.  The scheme also picks the program's
session class (:data:`SESSIONS`).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import inputs as inputs_mod
from . import trace as tr

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hetpu")
# a configuration's ``scheme`` → the program's session (module, class)
SESSIONS = {"ckks": ("hetpu_torch.session", "Session"),
            "bfv": ("hetpu_torch.bfv", "BfvSession")}


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    entry: str
    loop: str
    params: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int = 1
    units: dict = field(default_factory=dict)


def find_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    mix = _json(HERE / "mixes" / f"{w['traffic']}.json")
    own = _json(HERE / "workloads" / f"{name}.json")
    mine = lambda m: name in m.get("workloads", [name])
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    per = [m for m in bench["per_layer"] if mine(m)]
    return Cell(name=name, config=_json(root / conf["file"]),
                entry=mix["entry"], loop=mix["loop"],
                params={**mix["params"], **own["params"]},
                limits=own["limits"],
                end_to_end=[m["name"] for m in e2e],
                per_layer=[m["name"] for m in per], chips=w["chips"],
                units={m["name"]: m["unit"] for m in e2e + per})


def session_class(scheme: str):
    """The program's session class for ``scheme``; an unknown scheme
    stops the run."""
    if scheme not in SESSIONS:
        raise SystemExit(f"unknown scheme {scheme!r}: the benchmark knows "
                         f"{', '.join(SESSIONS)}")
    mod, name = SESSIONS[scheme]
    return getattr(importlib.import_module(mod), name)


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"hebench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What the readers read: the window on the host clock, and the traced
    slice (None without ``--trace``)."""

    config: dict
    params: dict
    setup_s: float
    window_s: float
    calls: int
    units: int
    latencies_s: list
    trace: tr.Trace | None


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def verdict(j: dict, extra: dict, limits: dict):
    """The one comparison that decides ``correct``, for the program's
    answers and for the control's in their place: every number of
    ``j["checks"]`` and ``extra`` within its limit (0 where the cell's
    ``limits`` name none), and no answer beyond one.  Returns (correct,
    answers failed, checks, limits)."""
    checks = {**j["checks"], **extra}
    lim = {k: limits.get(k, 0) for k in checks}
    failed = sum(1 for a in j["per_answer"]
                 if any(v > lim[k] for k, v in a.items()))
    correct = not failed and all(checks[k] <= lim[k] for k in checks)
    return correct, failed, checks, lim


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str, t_start: float, log=print,
             control: bool = False) -> dict:
    """Set up, measure ``seconds``, trace the first calls with ``trace``,
    judge the answers; the result's fields in the contract's order.
    ``control`` adds the control's verdict (calibration only)."""
    parts = {}
    t = time.perf_counter()
    import hetpu_torch
    from hetpu_torch.core import cuda_lib
    session = session_class(cell.config["scheme"])
    entry = importlib.import_module(f"hebench.entries.{cell.entry}")
    expected = importlib.import_module(
        f"hebench.reference.{cell.entry}").expected
    ref = importlib.import_module(
        f"hebench.reference.{cell.config['scheme']}")
    parts["import"] = time.perf_counter() - t
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t = time.perf_counter()
    if on_card:
        cuda_lib.lib()
    parts["library"] = time.perf_counter() - t
    p = cell.params
    t = time.perf_counter()
    sess = session.create(cell.config["preset"],
                          seed=inputs_mod.key_seed(seed),
                          galois_steps=entry.galois_steps(p), device=device)
    sync()
    parts["keygen"] = time.perf_counter() - t
    prm = sess.ctx.params
    if (list(prm.moduli) != cell.config["moduli"]
            or list(prm.special_moduli) != cell.config["special_moduli"]):
        raise SystemExit(f"preset {cell.config['preset']} does not hold the "
                         "configuration's primes")
    t = time.perf_counter()
    drv = entry.Driver(sess, p, inputs_mod.Inputs(seed))
    sync()
    parts["encrypt"] = time.perf_counter() - t
    t = time.perf_counter()
    drv.warm()
    sync()
    parts["warm"] = time.perf_counter() - t

    prof = tr.profiler() if trace else None
    tracing, traced = trace, p["trace_calls"]
    span = lambda name: tr.span(name, tracing)
    lat, n = [], 0
    if trace:
        prof.start()
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while True:
        if tracing and n == traced:
            sync()
            prof.stop()
            tracing = False
        s = time.perf_counter()
        with span("request"):
            drv.call(n, span)
        lat.append(time.perf_counter() - s)
        n += 1
        if n >= drv.min_calls and time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    if tracing:
        prof.stop()
        traced = n
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    tinfo = None
    if trace:
        pkg = tr.package_kernels(Path(hetpu_torch.__file__).parent / "csrc")
        tinfo = tr.read(prof, traced, traced * drv.units, pkg)
    run = Run(config=cell.config, params=p, setup_s=setup_s,
              window_s=window_s, calls=n, units=n * drv.units,
              latencies_s=lat if cell.loop == "closed" else [],
              trace=tinfo)

    # judge once the window has closed and the program's state is freed
    t = time.perf_counter()
    answers = drv.answers()
    extra = drv.checks()
    del drv, sess
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    key = inputs_mod.key_seed(seed)
    j = ref.judge(ref.values(answers, key, cell.config, device),
                  answers, expected, device)
    correct, failed, checks, lim = verdict(j, extra, cell.limits)
    judge_s = time.perf_counter() - t

    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in names:
        v = reader(m)(run)
        if v is not None:
            metrics[m] = {"value": v, "unit": cell.units[m]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    if tinfo is not None:
        dev.update(busy_s=tinfo.busy_s, window_s=tinfo.window_s)
    log(json.dumps({"setup_parts_s": parts, "calls": n,
                    "window_s": window_s, "judge_s": judge_s}))
    out = {"correct": correct, "attempted": run.units, "failed": failed,
           "metrics": metrics, "device": dev}
    if tinfo is not None:
        out["breakdown"] = tr.breakdown(tinfo)
    if control:
        jc = ref.judge(ref.control_values(answers, expected, cell.config,
                                          device),
                       answers, expected, device)
        ok, bad, cchecks, _ = verdict(jc, {}, cell.limits)
        out["control"] = {"correct": ok, "failed": bad, **cchecks}
    out["checks"] = {k: {"value": checks[k], "limit": lim[k]}
                     for k in checks}
    return out
