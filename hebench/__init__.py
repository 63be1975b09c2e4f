"""hebench: the benchmark of hetpu_torch on an NVIDIA H100.

``python3 -m hebench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once (see ``README.md``).  Nothing here
imports JAX or the JAX package; the plain reference (``reference/``)
imports nothing of the program either.
"""
