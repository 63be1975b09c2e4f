"""Run one cell of the benchmark once and print its result.

    python3 -m hebench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Needs a CUDA card (it never falls back to the CPU).  The last line of
standard output is the result (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, then
``checks``: each number compared beside its limit); the same numbers
close standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from hebench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m hebench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = harness.find_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"hebench: {cell.chips} CUDA card(s) needed; none falls back "
              "to the CPU",
              file=sys.stderr)
        return 3
    log = lambda s: print(s, file=sys.stderr, flush=True)
    out = harness.run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda",
                           T_START, log=log)
    bad = harness.forbidden_modules()
    if bad:
        print(f"hebench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 4
    for k, v in out["checks"].items():
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
