"""Runnable demos: counterpart of ``hetpu/demos`` and of the reference's
``demo <suite> <name>`` CLI (``src/demos/demos.cpp``).  Suites
``bfv_operations``, ``client``, ``client_server_rookie``, ``fft``,
``math_operations``, ``matrix_operations``, ``server``.

Run:  python -m hetpu_torch.demos <suite> <name> [--small] [--cpu]

The demos run on the card (``device="cuda"``); ``--cpu`` runs them on the
plain PyTorch paths.
"""

SUITES = ("bfv_operations", "client", "client_server_rookie", "fft",
          "math_operations", "matrix_operations", "server")
