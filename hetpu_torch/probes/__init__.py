"""Card micro-benchmarks: the port of the JAX package's TPU probes
(``scripts/probe_*.py``, ``scripts/kernel_micro.py``).

    python -m hetpu_torch.probes <name> [--device cuda]

``<name>`` is one of :data:`NAMES`, after the script it ports:

* ``grid``, ``overhead`` — kernel P1 ``copy_planes`` (:mod:`.copy`): the
  cost of a block and of a launch;
* ``overhead2`` — kernel P2 ``muladd_u32`` (:mod:`.overhead2`): 1, 2 or 8
  launches a step;
* ``u8_dot``, ``pallas_s8``, ``int8_mxu`` — kernel P3 ``dot_i8``
  (:mod:`.dot`): u8/s8 tensor-core products, exactness and rate;
* ``kernel_parts`` — kernel P4 ``plane_parts`` (:mod:`.kernel_parts`): the
  stages of an int8-digit NTT, per plane;
* ``kernel_micro`` — the port's NTT kernel and plain modular ops per plane
  (:mod:`.kernel_micro`; no kernel of its own).

Each probe keeps its script's shapes, constants and chain rule: every
step's output feeds the next (``o ^ (o[..., :1, :1] & 1)``), so no step
can be skipped or overlapped with the next.  Where the script timed a
chain inside one jitted scan, the port times the same chain twice: eagerly
(host dispatch included) and captured once in a ``torch.cuda.CUDAGraph``
and replayed (the card's counterpart of a chain inside one jit, with no
host dispatch).  The difference is the host time the device did not
hide.

Times are CUDA events on the card (the best of 3 windows), in ms per
step and µs per plane.  ``device="cpu"`` runs the plain versions, timed
with the host clock: those are not device numbers.  :func:`cold_ms` times
one call replayed with L2 flushed before it, for comparison with a bound
that reads every input from device memory.
"""

from __future__ import annotations

import statistics
import time

import torch

from ..core import cuda_lib

NAMES = ("grid", "overhead", "overhead2", "u8_dot", "pallas_s8", "int8_mxu",
         "kernel_parts", "kernel_micro")
REPS = 3
COLD_REPS = 10
FLUSH_BYTES = 1 << 28      # 256 MiB read: five times the H100's 50 MB L2


def device_of(device) -> torch.device:
    """The device to run on; raises where a card is asked for and there
    is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA card and "
                           "torch.cuda.is_available() is false; pass "
                           "device='cpu' for the plain versions")
    return dev


def feedback(o: torch.Tensor) -> torch.Tensor:
    """The chain rule of the probes: the next step's input."""
    return o ^ (o[..., :1, :1] & 1)


def _run(step, x, k: int):
    for _ in range(k):
        x = step(x)
    return x


def window_ms(fn, cuda: bool = True) -> float:
    """ms of one call of ``fn()``: CUDA events on the card, the host clock
    off it."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def eager_ms(step, x: torch.Tensor, k: int) -> float:
    """ms per step of ``k`` chained steps dispatched eagerly (best of
    :data:`REPS` windows, after a warm-up of two steps)."""
    _run(step, x, 2)
    cuda = x.device.type == "cuda"
    return min(window_ms(lambda: _run(step, x, k), cuda)
               for _ in range(REPS)) / k


class Captured:
    """``fn()`` captured once in a CUDA graph, after one eager call on a
    side stream (which also builds the kernels).  :meth:`replay` counts
    the package kernels the capture recorded as launched
    (``cuda_lib.count_replay``)."""

    def __init__(self, fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with cuda_lib.recording() as rec, torch.cuda.graph(self.graph):
            fn()
        self.kernels = {k: n for k, n in rec.items() if n}
        self.nbytes = {k: b for k, b in rec.nbytes.items() if b}

    def replay(self) -> None:
        self.graph.replay()
        cuda_lib.count_replay(self.kernels, self.nbytes)


def replay_windows(fn, reps: int) -> list[float]:
    """ms of each of ``reps`` replays of ``fn()`` captured once in a CUDA
    graph (after one untimed replay)."""
    g = Captured(fn)
    g.replay()
    return [window_ms(g.replay) for _ in range(reps)]


def cold_ms(fn, reps: int = COLD_REPS) -> float:
    """Median ms of one call of ``fn()`` replayed from a CUDA graph with a
    cold L2: before each timed replay, an untimed read of
    :data:`FLUSH_BYTES` evicts what the last call left there.  The read
    outlasts the host's enqueue of the replay, so no host gap falls in the
    timed window: the time is the device's alone, with every input coming
    from device memory."""
    g = Captured(fn)
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    times = []
    for _ in range(reps):
        flush.sum()
        times.append(window_ms(g.replay))
    return statistics.median(times)


def graph_ms(step, x: torch.Tensor, k: int) -> float | None:
    """ms per step of the same chain captured once in a CUDA graph and
    replayed (best of :data:`REPS`); None off the card."""
    if x.device.type != "cuda":
        return None
    return min(replay_windows(lambda: _run(step, x, k), REPS)) / k


def chain(name: str, step, x: torch.Tensor, k: int, planes: int,
          graph: bool = True) -> dict:
    """Time ``k`` chained steps eagerly (and replayed from a CUDA graph),
    print one line and return the numbers."""
    e = eager_ms(step, x, k)
    g = graph_ms(step, x, k) if graph else None
    us = lambda ms: ms / planes * 1e3
    line = f"{name:36s} eager {e:9.4f} ms ({us(e):7.3f} us/plane)"
    if g is not None:
        line += f"  graph {g:9.4f} ms ({us(g):7.3f} us/plane)"
    print(line, flush=True)
    return {"name": name, "eager_ms": e, "graph_ms": g, "planes": planes,
            "steps": k}


def header(dev: torch.device) -> str:
    """The device line each probe prints first."""
    if dev.type == "cuda":
        return f"device: {torch.cuda.get_device_name(dev)}"
    return "device: cpu (plain versions, host clock: not device numbers)"


def run(name: str, device="cuda", **kw):
    """Run probe ``name`` (one of :data:`NAMES`); returns its results."""
    from . import copy, dot, kernel_micro, kernel_parts, overhead2
    table = {"grid": copy.run_grid, "overhead": copy.run_overhead,
             "overhead2": overhead2.run, "u8_dot": dot.run_u8_dot,
             "pallas_s8": dot.run_pallas_s8, "int8_mxu": dot.run_int8_mxu,
             "kernel_parts": kernel_parts.run,
             "kernel_micro": kernel_micro.run}
    if name not in table:
        raise ValueError(f"unknown probe {name!r}; one of {', '.join(NAMES)}")
    return table[name](device=device, **kw)
