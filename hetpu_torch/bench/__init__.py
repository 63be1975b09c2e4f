"""hetpu's measuring programs on the card: the port of ``bench.py``
(:mod:`.headline`), ``scripts/bench_secondary.py`` (:mod:`.secondary`)
and ``scripts/bench_workloads.py`` (:mod:`.workloads`).

    python -m hetpu_torch.bench {headline,secondary,workloads} [--small] [--cpu]

Every throughput here is hetpu's chained metric (``bench.py:56-80``): a
sequential chain of steps, each running the op on its input XOR a tag
folded from the previous step's output, so that no step can be skipped,
merged with another or overlapped with the next.  This module is the
chain harness.  A step (:class:`Chain`) runs on static buffers and folds
the output into its tag in place, with one of hetpu's two folds:
:func:`fold_into` (every output element, ``bench.py:56-67``) or
:func:`fold8` (the first 8, ``scripts/bench_secondary.py:25``).

:func:`timed` is the counterpart of hetpu's jitted ``lax.scan``.  On the
card it captures one step in a CUDA graph after one eager warm-up step and
replays it K·reps times between CUDA events, so host dispatch stays out
of the measured window.  It also times K eager steps on the host clock,
which gives the host's share of an eager op.  On the CPU the same steps
run eagerly on the host clock: those are not device numbers.

The programs run on the card unless given ``--cpu``; without a card and
without ``--cpu`` they raise.
"""

from __future__ import annotations

import json

import torch

from .. import probes
from ..utils.timer import Timer


def device_of(cpu: bool) -> str:
    """The device to run on: the CPU when asked for, else the card, which
    must exist."""
    if cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("hetpu_torch.bench: no CUDA device; pass --cpu "
                           "for the plain PyTorch paths")
    return "cuda"


def device_name(device: str) -> str:
    """What ran the program: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(0) if device == "cuda" else "cpu"


def fold_into(x0: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hetpu's tag fold: the XOR of EVERY element of y over chunks of
    x0's size (y zero-padded), bit 0 kept, as an x0-shaped int32 tag.  Bit
    0 of an XOR is the parity of the sum of bit 0, so the fold is one sum;
    the next step then consumes all of this step's output."""
    n0 = x0.numel()
    yf = y.reshape(-1)
    k = -(-yf.numel() // n0)
    yf = torch.cat([yf, yf.new_zeros(k * n0 - yf.numel())])
    bits = (yf.reshape(k, n0) & 1).sum(0)
    return (bits & 1).to(torch.int32).reshape(x0.shape)


def fold8(x0: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """hetpu's sampled fold (``scripts/bench_secondary.py:25``,
    ``bench_workloads.py:191``): bit 0 of the sum of y's first 8 elements
    as uint32, a scalar int32 tag.  Residues are stored as int32 bit
    patterns, and bit 0 of a sum does not depend on the carries above."""
    return (y.reshape(-1)[:8].sum(dtype=torch.int64) & 1).to(torch.int32)


class Chain:
    """One step of hetpu's chain on static buffers: ``fn`` on x0 XOR
    ``tag``, its output folded into ``tag`` in place and kept as ``out``.
    Inside a CUDA graph ``tag`` and ``out`` are the graph's static
    buffers, so a replay leaves the step's tag and output there."""

    def __init__(self, fn, x0: torch.Tensor, fold=fold_into,
                 name: str = "chain"):
        self.fn, self.x0, self.fold, self.name = fn, x0, fold, name
        self.tag = fold(x0, x0).zero_()
        self.out = None

    def __call__(self) -> None:
        y = self.fn(torch.bitwise_xor(self.x0, self.tag))
        self.tag.copy_(self.fold(self.x0, y))
        self.out = y


def timed(chain: Chain, K: int, reps: int = 2, eager: bool = True) -> dict:
    """Time K·reps chained steps; each timed run starts from a zero tag.

    First one untimed eager step, which builds every plan, table and cache
    the step needs.  ``eager``: then K eager steps on the host clock, the
    last one waited for (``eager_seconds``, per step).  On the card the
    step is then captured in a CUDA graph (``probes.Captured``) and
    replayed K·reps times between CUDA events (``seconds``, per step);
    ``launches`` counts the package kernels a replay launches, and
    ``grown_bytes`` is the device memory allocated across the replays.
    Off the card the K·reps steps run eagerly on the host clock.  A step
    that cannot be captured raises, naming the chain.  Leaves the chain's
    tag and output at the end of the K·reps steps."""
    steps = K * reps
    out = {"steps": steps, "eager_seconds": None, "launches": {},
           "grown_bytes": 0}
    chain()
    if eager:
        chain.tag.zero_()
        t = Timer()
        for _ in range(K):
            chain()
        out["eager_seconds"] = t.tocr(block_on=chain.tag) / K
    chain.tag.zero_()
    if chain.x0.device.type != "cuda":
        t = Timer()
        for _ in range(steps):
            chain()
        out["seconds"] = t.tocr() / steps
        return out
    try:
        graph = probes.Captured(chain)
    except RuntimeError as e:
        raise RuntimeError(f"{chain.name} cannot be captured in a CUDA "
                           f"graph: {e}") from e
    chain.tag.zero_()
    before = torch.cuda.memory_allocated()
    ms = probes.window_ms(lambda: [graph.replay() for _ in range(steps)])
    out.update(seconds=ms / 1e3 / steps, launches=graph.kernels,
               grown_bytes=torch.cuda.memory_allocated() - before)
    return out


def report(r: dict, **fields) -> None:
    """Print the line that goes before a chained metric: ``fields`` (the
    program, chain and settings), then the chained and eager ms a step,
    the package kernels a replay launches and the device bytes grown over
    the replays."""
    print(json.dumps({
        **fields, "chained_ms_per_step": r["seconds"] * 1e3,
        "eager_ms_per_step": r["eager_seconds"] * 1e3,
        "launches_per_step": r["launches"],
        "grown_bytes": r["grown_bytes"]}), flush=True)
