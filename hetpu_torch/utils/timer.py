"""Wall-clock stopwatch — ``Timer.tic/toc/tocr``.

Counterpart of ``hetpu/utils/timer.py``.  PyTorch returns from a CUDA
call before the card has run it, so ``block_on`` names the tensors whose
work must be finished before the clock is read: their CUDA devices are
synchronised.  CPU tensors need no wait.
"""

from __future__ import annotations

import time

import torch

from . import metrics, tensor_leaves


class Timer:
    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def tocr(self, block_on=None) -> float:
        """Elapsed seconds.  ``block_on``: a tensor or a nest of tensors
        (tuples, lists, dicts, dataclasses) to wait for first."""
        for dev in {t.device for t in tensor_leaves(block_on)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - self._t0

    def toc(self, label: str = "", block_on=None) -> float:
        dt = self.tocr(block_on)
        print(f"{label}: {dt:.6f} s" if label else f"{dt:.6f} s")
        metrics.emit("timer", label=label, seconds=round(dt, 6))
        return dt
