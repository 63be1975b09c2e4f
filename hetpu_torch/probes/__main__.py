"""``python -m hetpu_torch.probes <name> [--device cuda]`` — run one card
micro-benchmark (see :mod:`hetpu_torch.probes`)."""

from __future__ import annotations

import argparse
import sys

from . import NAMES, run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m hetpu_torch.probes",
                                 description=__doc__)
    ap.add_argument("name", choices=NAMES)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(the plain versions, host clock)")
    args = ap.parse_args(argv)
    run(args.name, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
