"""The readings that the limits of ``correct`` are set from: one cell's
sound runs on many seeds, and its control on the same answers, in one
process on the card (each seed with its own keys and inputs).

    python3 -m hebench.calibrate --workload <cell> --seconds <s> \\
        --seeds <n> <n> ... [--out FILE]

The control is the plain math itself, computed in the precision below
the configuration's and put in the program's place: the same comparison
that decides ``correct`` judges it (``harness.verdict``), and it has to
come out not correct.  Prints one line a seed and a summary of the check
the scheme's referee names (``CALIBRATED``): ``lower`` is its largest
sound reading, ``upper`` its smallest control reading; every other check
is exact and listed where it is not 0.
The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from hebench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hebench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hebench: no CUDA card", file=sys.stderr)
        return 3
    cell = harness.find_cell(a.workload)
    name = importlib.import_module(
        f"hebench.reference.{cell.config['scheme']}").CALIBRATED
    rows, exact = [], set()
    for seed in a.seeds:
        out = harness.run_cell(cell, seed, a.seconds, False, "cuda",
                               time.perf_counter(), control=True,
                               log=lambda s: print(s, file=sys.stderr))
        row = {"seed": seed, "correct": out["correct"],
               "control": out["control"][name],
               "control_correct": out["control"]["correct"],
               **{k: v["value"] for k, v in out["checks"].items()},
               "metrics": {k: v["value"] for k, v in out["metrics"].items()
                           if k != "setup_s"}}
        print(json.dumps(row), flush=True)
        rows.append(row)
        exact |= set(out["checks"]) - {name}
    summary = {"workload": a.workload,
               "card": torch.cuda.get_device_name(0),
               "lower": max(r[name] for r in rows),
               "upper": min(r["control"] for r in rows),
               "limit": cell.limits.get(name, 0),
               "program_not_correct": [r["seed"] for r in rows
                                       if not r["correct"]],
               "control_correct": [r["seed"] for r in rows
                                   if r["control_correct"]],
               "exact_checks_nonzero": [r["seed"] for r in rows if any(
                   v for k, v in r.items() if k in exact)],
               "rows": rows}
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
