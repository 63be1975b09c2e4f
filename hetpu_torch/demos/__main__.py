"""CLI dispatcher: counterpart of ``hetpu/demos/__main__.py`` (the
reference's ``demo <suite> <name>``, ``src/demos/demos.cpp:7-29``).

Usage: python -m hetpu_torch.demos <suite> <name> [--small] [--cpu]

Every session, client and server is made on the card; ``--cpu`` makes
them on the CPU (the plain PyTorch paths, the same bits).  Without
``--cpu`` and without a card the run raises.
"""

from __future__ import annotations

import sys

import torch

from . import SUITES


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    small = "--small" in argv
    device = "cpu" if "--cpu" in argv else "cuda"
    argv = [a for a in argv if a not in ("--small", "--cpu")]
    if len(argv) < 1:
        print(__doc__)
        print("suites:", " ".join(SUITES))
        return 1
    suite = argv[0]
    name = argv[1] if len(argv) > 1 else None

    if suite == "matrix_operations":
        from . import matrix_operations as m
    elif suite == "bfv_operations":
        from . import bfv_operations as m
    elif suite == "math_operations":
        from . import math_operations as m
    elif suite == "fft":
        from . import fft as m
    elif suite in ("client", "server", "client_server_rookie"):
        from . import offload_demos as o
        m = None
    else:
        print(f"unknown suite {suite!r}")
        return 1

    if m is not None and name not in m.DEMOS:
        print(f"unknown demo {name!r}; available: {' '.join(m.DEMOS)}")
        return 1
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hetpu_torch.demos: no CUDA device; pass --cpu "
                           "for the plain PyTorch paths")
    if m is not None:
        m.DEMOS[name](small, device)
    elif suite == "server":
        o.demo_server(name, small, device)
    elif suite == "client":
        o.demo_client(name, small, device)
    else:
        o.demo_rookie(name, small, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
