"""hetpu's measuring programs on the card: the port of ``bench.py``
(:mod:`.headline`), ``scripts/bench_secondary.py`` (:mod:`.secondary`),
``scripts/bench_workloads.py`` (:mod:`.workloads`) and of the scripts that
take the main op apart: ``profile_fused.py``, ``profile_hotpath.py``,
``op_parts_chain.py``, ``bench_sweep.py``, ``probe_n15.py`` and
``probe_n15b.py`` (:mod:`.probe_n15`), ``probe_lsq_twice.py`` and
``trace_op.py``, each in the module of its name.

    python -m hetpu_torch.bench <program> [--small] [--cpu]

Every throughput here is hetpu's chained metric (``bench.py:56-80``): a
sequential chain of steps, each running the op on its input XOR a tag
folded from the previous step's output, so that no step can be skipped,
merged with another or overlapped with the next.  This module is the
chain harness.  A step (:class:`Chain`) runs on static buffers and folds
the output into its tag in place, with the fold of the script it ports:
:func:`fold_into` (every output element, ``bench.py:56-67``),
:func:`fold8` (the flat first 8, ``scripts/bench_secondary.py:25``),
:func:`fold_rows8` (``y[..., :1, :1, :8]``, ``scripts/trace_op.py:22``)
or :func:`fold_parts8` (``y[..., :1, :8]``,
``scripts/op_parts_chain.py:21``).

:func:`timed` and :func:`best_of` are the counterparts of hetpu's jitted
``lax.scan``.  On the card they capture one step in a CUDA graph after one
eager warm-up step (:func:`first_step_seconds`) and replay it between CUDA
events, so host dispatch stays out of the measured window: ``timed`` in
one window of K·reps replays, ``best_of`` in reps windows of K replays,
the fastest kept (hetpu's "best of REPS calls").  Both also time K eager
steps on the host clock, which gives the host's share of an eager op.  On
the CPU the same steps run eagerly on the host clock: those are not device
numbers.  :func:`write_record` keeps a program's record under
``build/hetpu_torch/``.

The programs run on the card unless given ``--cpu``; without a card and
without ``--cpu`` they raise.
"""

from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import torch

from .. import probes
from ..utils.timer import Timer

OUT_DIR = Path(__file__).resolve().parents[2] / "build" / "hetpu_torch"
HBM_BYTES_PER_S = 3.35e12      # one H100 SXM's device memory rate


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


def card_line(device: str) -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    if device != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


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


def fold_rows8(x0: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The sampled fold of ``scripts/trace_op.py:22``,
    ``bench_sweep.py:28`` and ``profile_hotpath.py:52``: bit 0 of the sum
    of ``y[..., :1, :1, :8]`` (of all of y when it has fewer than 3
    dimensions, as profile_hotpath.py does), a scalar int32 tag."""
    part = y[..., :1, :1, :8] if y.dim() >= 3 else y
    return (part.sum(dtype=torch.int64) & 1).to(torch.int32)


def fold_parts8(x0: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The sampled fold of ``scripts/op_parts_chain.py:21``: bit 0 of the
    sum of ``y[..., :1, :8]``, a scalar int32 tag."""
    return (y[..., :1, :8].sum(dtype=torch.int64) & 1).to(torch.int32)


class Chain:
    """One step of hetpu's chain on static buffers: ``fn`` on x0 XOR
    ``tag``, its output folded into ``tag`` in place and kept as ``out``.
    Inside a CUDA graph ``tag`` and ``out`` are the graph's static
    buffers, so a replay leaves the step's tag and output there.
    ``operands``: the tensors ``fn`` reads besides its input (other
    ciphertexts, keys), where a bytes bound is wanted
    (:func:`bytes_bound_ms`)."""

    def __init__(self, fn, x0: torch.Tensor, fold=fold_into,
                 name: str = "chain", operands=None):
        self.fn, self.x0, self.fold, self.name = fn, x0, fold, name
        self.operands = operands
        self.tag = fold(x0, x0).zero_()
        self.out = None

    def __call__(self) -> None:
        y = self.fn(torch.bitwise_xor(self.x0, self.tag))
        self.tag.copy_(self.fold(self.x0, y))
        self.out = y


def bytes_bound_ms(chain: Chain) -> float | None:
    """The least ms one step could take on the card's memory: its input,
    its operands and its last output, each moved once, over
    :data:`HBM_BYTES_PER_S` (NTT tables and other constants not counted);
    None where the chain lists no operands."""
    if chain.operands is None or chain.out is None:
        return None
    moved = sum(t.numel() * t.element_size()
                for t in (chain.x0, chain.out, *chain.operands))
    return moved / HBM_BYTES_PER_S * 1e3


def first_step_seconds(chain: Chain) -> float:
    """One eager step on the host clock, waited for: the first builds every
    plan, table and cache the step needs (the counterpart of the scripts'
    printed compile time)."""
    t0 = time.perf_counter()
    chain()
    if chain.tag.device.type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def _replays(chain: Chain, K: int, windows: list, eager: bool) -> dict:
    """First one eager step (``first_seconds``).  ``eager``: then K eager
    steps on the host clock, the last one waited for (``eager_seconds``,
    per step).  Then each window of ``windows`` (a number of steps) from a
    zero tag: on the card the step captured once in a CUDA graph
    (``probes.Captured``) and replayed between CUDA events, off it eager
    steps on the host clock (``window_seconds``, per step).  ``launches``
    counts the package kernels a replay launches, ``grown_bytes`` is the
    device memory allocated across the replays.  A step that cannot be
    captured raises, naming the chain.  Leaves the chain's tag and output
    at the end of the last window."""
    out = {"steps": sum(windows), "eager_seconds": None, "launches": {},
           "grown_bytes": 0, "first_seconds": first_step_seconds(chain)}
    if eager:
        chain.tag.zero_()
        t = Timer()
        for _ in range(K):
            chain()
        out["eager_seconds"] = t.tocr(block_on=chain.tag) / K
    cuda = chain.x0.device.type == "cuda"
    step = chain
    if cuda:
        try:
            graph = probes.Captured(chain)
        except RuntimeError as e:
            raise RuntimeError(f"{chain.name} cannot be captured in a CUDA "
                               f"graph: {e}") from e
        step = graph.replay
        before = torch.cuda.memory_allocated()
    per_step = []
    for steps in windows:
        chain.tag.zero_()
        ms = probes.window_ms(lambda: [step() for _ in range(steps)], cuda)
        per_step.append(ms / 1e3 / steps)
    out.update(window_seconds=per_step, bytes_bound_ms=bytes_bound_ms(chain))
    if cuda:
        out.update(launches=graph.kernels,
                   grown_bytes=torch.cuda.memory_allocated() - before)
    return out


def timed(chain: Chain, K: int, reps: int = 2, eager: bool = True) -> dict:
    """Time K·reps chained steps in one window from a zero tag
    (``seconds``, per step; the other keys as :func:`_replays`).  Leaves
    the chain's tag and output at the end of the K·reps steps."""
    out = _replays(chain, K, [K * reps], eager)
    out["seconds"] = out["window_seconds"][0]
    return out


def best_of(chain: Chain, K: int, reps: int = 3, eager: bool = True) -> dict:
    """hetpu's "best of REPS calls" (``scripts/profile_fused.py:43-49``,
    ``bench_sweep.py:36-41``): ``reps`` windows of K chained steps, each
    from a zero tag; ``seconds`` is the fastest window's time a step (the
    other keys as :func:`_replays`).  Leaves the chain's tag and output at
    K steps from a zero tag."""
    out = _replays(chain, K, [K] * reps, eager)
    out["seconds"] = min(out["window_seconds"])
    return out


def write_record(name: str, record: dict, out: Path | None = None) -> Path:
    """Write a program's record as JSON to ``out``, by default
    ``build/hetpu_torch/<name>.json``; returns the path."""
    path = Path(out) if out is not None else OUT_DIR / f"{name}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=1) + "\n")
    return path


def report(r: dict, **fields) -> None:
    """Print the line that goes before a chained metric: ``fields`` (the
    program, chain and settings), then the chained and eager ms a step,
    the package kernels a replay launches, the device bytes grown over
    the replays and, where the chain lists its operands, its bytes
    bound."""
    bound = ({} if r.get("bytes_bound_ms") is None
             else {"bytes_bound_ms": r["bytes_bound_ms"]})
    print(json.dumps({
        **fields, "chained_ms_per_step": r["seconds"] * 1e3,
        "eager_ms_per_step": r["eager_seconds"] * 1e3,
        "launches_per_step": r["launches"],
        "grown_bytes": r["grown_bytes"], **bound}), flush=True)


def entry(r: dict) -> dict:
    """A chain's numbers for a record: ms a step by the program's
    statistic and eagerly, each window's ms a step, the first step's
    seconds, the package kernels a replay launches and the device bytes
    grown over the replays."""
    eager = r["eager_seconds"]
    return {"ms": r["seconds"] * 1e3,
            "eager_ms": None if eager is None else eager * 1e3,
            "window_ms": [s * 1e3 for s in r["window_seconds"]],
            "first_step_s": r["first_seconds"], "launches": r["launches"],
            "grown_bytes": r["grown_bytes"],
            "bytes_bound_ms": r["bytes_bound_ms"]}


def meta(device: str) -> dict:
    """What ran a record: the device's name and, on the card, nvidia-smi's
    name and power limit."""
    return {"device": device_name(device), "card": card_line(device)}
