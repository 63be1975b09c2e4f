"""CLI of hetpu's measuring programs on the card.

    python -m hetpu_torch.bench headline [--preset P] [--batch B] [--K K]
                                         [--reps R] [--small] [--cpu]
    python -m hetpu_torch.bench secondary [--small] [--cpu]
    python -m hetpu_torch.bench workloads [--only SECTION] [--out PATH]
                                          [--small] [--cpu]
    python -m hetpu_torch.bench {profile_fused,profile_hotpath,
        op_parts_chain,bench_sweep,probe_n15,probe_n15b,probe_lsq_twice,
        trace_op} [--out PATH] [--small] [--cpu]

``headline`` prints ``ckks_mult_relin_rescale_n14_ops_per_s`` (bench.py),
``secondary`` the rotation, hoisted-rotation and NTT metrics
(scripts/bench_secondary.py), ``workloads`` writes hetpu's record
(scripts/bench_workloads.py) to ``--out``.  The op-profiling programs are
named after the scripts they port (scripts/<name>.py; ``probe_n15b`` is
scripts/probe_n15b.py) and print the scripts' lines; each writes its record
to ``--out``, by default ``build/hetpu_torch/<name>.json``
(``<name>_small.json`` with ``--small``).  Everything runs on the card;
``--cpu`` runs the plain PyTorch paths on the host clock (no device
numbers), and without it and without a card the run raises.  ``--small``
runs test presets, B=2 and short chains.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

from . import (bench_sweep, device_of, headline, op_parts_chain,
               probe_lsq_twice, probe_n15, profile_fused, profile_hotpath,
               secondary, trace_op, workloads)

# the op-profiling programs: subcommand → (module, help)
PROFILES = {
    "profile_fused": (profile_fused, "the op's pieces, chained, best of 3 "
                      "(scripts/profile_fused.py)"),
    "profile_hotpath": (profile_hotpath, "the op's steps dispatched from "
                        "the host, and chained (scripts/profile_hotpath.py)"),
    "op_parts_chain": (op_parts_chain, "the op at B=32 and 64 and its four "
                       "parts (scripts/op_parts_chain.py)"),
    "bench_sweep": (bench_sweep, "the op over B x K "
                    "(scripts/bench_sweep.py)"),
    "probe_n15": (probe_n15, "the op and its pieces at N=2^15 "
                  "(scripts/probe_n15.py)"),
    "probe_n15b": (probe_n15, "the op at N=2^15 B=1 dispatched, and its "
                   "pieces chained (scripts/probe_n15b.py)"),
    "probe_lsq_twice": (probe_lsq_twice, "the least-squares fit twice in "
                        "one process (scripts/probe_lsq_twice.py)"),
    "trace_op": (trace_op, "a torch.profiler trace of the chained op "
                 "(scripts/trace_op.py)"),
}


def parser() -> argparse.ArgumentParser:
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--small", action="store_true",
                        help="test presets and short chains")
    common.add_argument("--cpu", action="store_true",
                        help="the plain PyTorch paths on the CPU")
    ap = argparse.ArgumentParser(prog="python -m hetpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="program", required=True)
    h = sub.add_parser(
        "headline", parents=[common],
        help="CKKS multiply_relin_rescale ops/s at N=2^14 (bench.py)")
    h.add_argument(
        "--preset", choices=headline.PRESETS,
        default=os.environ.get("HETPU_BENCH_PRESET", "bench_n14"),
        help="bench_n14 (α=5), bench_n14_a4 (α=4) or bench_n14_fast (α=4, "
             "primes < 2^30: on the TPU an approximate mulhi; the port's "
             "arithmetic is exact on every preset); --small runs "
             f"{headline.SMALL_PRESET} (default: $HETPU_BENCH_PRESET or "
             "bench_n14)")
    h.add_argument("--batch", type=int,
                   default=int(os.environ.get("HETPU_BENCH_BATCH", "8")),
                   help="ciphertexts a step (default: $HETPU_BENCH_BATCH "
                        "or 8)")
    h.add_argument("--K", type=int, default=None,
                   help="chained steps a rep (default: $HETPU_BENCH_K or "
                        "1536; 3 with --small)")
    h.add_argument("--reps", type=int,
                   default=int(os.environ.get("HETPU_BENCH_REPS", "2")),
                   help="reps (default: $HETPU_BENCH_REPS or 2)")
    sub.add_parser("secondary", parents=[common],
                   help="rotation, hoisted-rotation and NTT throughput at "
                        "N=2^14 (scripts/bench_secondary.py)")
    w = sub.add_parser("workloads", parents=[common],
                       help="hetpu's benchmark record "
                            "(scripts/bench_workloads.py)")
    w.add_argument("--only", choices=list(workloads.SECTIONS),
                   help="run one section")
    w.add_argument("--out", type=Path, default=None,
                   help="the record (JSON, merged section by section); "
                        "default build/hetpu_torch/bench_workloads.json "
                        "(bench_workloads_small.json with --small)")
    for name, (_, text) in PROFILES.items():
        p = sub.add_parser(name, parents=[common], help=text)
        p.add_argument("--out", type=Path, default=None,
                       help="the record (JSON); default "
                            f"build/hetpu_torch/{name}.json")
        if name == "bench_sweep":
            p.add_argument("--K", type=int, nargs="+", default=None,
                           help="the K values (default 8 32 96; 3 with "
                                "--small)")
        if name == "trace_op":
            p.add_argument("--steps", type=int, default=None,
                           help="traced steps (default 5; 3 with --small)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    device = device_of(args.cpu)
    if args.program == "headline":
        small = args.small
        k = args.K if args.K is not None else (
            3 if small else int(os.environ.get("HETPU_BENCH_K", "1536")))
        headline.run(headline.SMALL_PRESET if small else args.preset,
                     args.batch, k, args.reps, device)
    elif args.program == "secondary":
        secondary.run(args.small, device)
    elif args.program in ("probe_n15", "probe_n15b"):
        probe_n15.run(args.program, args.small, device, args.out)
    elif args.program == "bench_sweep":
        bench_sweep.run(args.small, device, args.out, args.K)
    elif args.program == "trace_op":
        trace_op.run(args.small, device, args.out, args.steps)
    elif args.program in PROFILES:
        PROFILES[args.program][0].run(args.small, device, args.out)
    else:
        workloads.run(args.only, args.out or workloads.default_out(
            args.small), args.small, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
