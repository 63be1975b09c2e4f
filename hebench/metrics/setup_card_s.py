"""Seconds of set-up in the program's phase ``card``: the CUDA library's
first load (``cuda_lib.lib``, with its nvcc build when ``build/`` holds
none for the sources) and the program's first use of the card (CUDA's init
and context, in ``Context``).  Self time on the host clock, from
``hetpu_torch.utils.profiling.host_s``; None where the program keeps no
``host_s``.  ``host_s`` is read when the harness reads its metrics, after
the window and the judge: a cell whose window opens a phase counts that
work here as set-up, and ``setup_rest_s`` falls by as much."""

from hetpu_torch.utils import profiling


def read(run):
    host_s = getattr(profiling, "host_s", None)
    if host_s is None:
        return None
    return host_s.get("card", 0.0)
