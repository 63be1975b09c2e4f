"""Multi-rank parallelism over a process group (SPMD).

Counterpart of ``hetpu/parallel/__init__.py`` (``make_mesh``,
``shard_batch``, ``replicate``, ``mod_all_reduce``, ``bucketed_matvec``),
with ``parallel/tp.py`` (the limb-sharded key switch) and
``parallel/cp.py`` (the coefficient-sharded NTT).  hetpu's programs run
under ``jax.shard_map`` over a ``jax.sharding.Mesh`` of devices; here each
rank of a ``torch.distributed`` process group runs the same program:

* every rank calls a parallel function with the same global inputs that
  hetpu's function takes, keeps its own shard inside, and returns the same
  global result that hetpu's returns once gathered (``np.asarray(out)``),
  bit for bit;
* the process group is gloo: it carries the host's control (the IPC
  handles of each exchange buffer, and one barrier when a mesh closes)
  and, on the CPU, the plain twin's data;
* device data moves between ranks only through the ``peer_permute``
  kernel (:mod:`.peer`), which stores into the peers' buffers mapped with
  CUDA IPC (between processes on one card, or between cards) and waits
  on flag words in those buffers: the wait is the card's, stream-ordered,
  and the host meets no other rank inside an exchange.

A :class:`Mesh` lays the group's ranks out row-major over named axes and
owns the rank's ``device`` (``cuda:(rank mod device_count)`` unless given;
on one card every rank shares ``cuda:0``; ``"cuda"`` without an index is
the current card).  ``device="cpu"`` runs the plain twins (the tests).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..core import galois
from ..core.ciphertext import Ciphertext
from ..core.modular import mod_add
from .peer import Exchange, all_gather, all_to_all, ppermute, right_permute

__all__ = ["Mesh", "make_mesh", "resolve_device", "shard_batch",
           "replicate", "mod_all_reduce", "bucketed_matvec", "ppermute",
           "right_permute", "all_to_all", "all_gather"]


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; ``"cuda"`` without an index becomes the
    current card by its index, as the tensors made on ``"cuda"`` name it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class Mesh:
    """The ranks of ``group`` (None: the default group, or one process
    without ``torch.distributed``) laid out row-major over ``shape``, a
    dict axis name → size, like ``jax.sharding.Mesh.shape``."""

    def __init__(self, shape: dict, group=None, device="cuda"):
        self.shape = dict(shape)
        self.group = group
        self.size = math.prod(self.shape.values())
        self.rank = dist.get_rank(group) if dist.is_initialized() else 0
        world = dist.get_world_size(group) if dist.is_initialized() else 1
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks, the "
                             f"group {world}")
        self.device = resolve_device(device)
        coords, r = [], self.rank
        for size in reversed(self.shape.values()):
            coords.append(r % size)
            r //= size
        self.coords = tuple(reversed(coords))
        self._exchange: Exchange | None = None

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(self.shape)

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[self.axis_names.index(axis)]

    def axis_ranks(self, axis: str) -> list[int]:
        """Group ranks of this rank's row along ``axis``, in axis order."""
        k = self.axis_names.index(axis)
        sizes = list(self.shape.values())
        stride = math.prod(sizes[k + 1:])
        base = self.rank - self.coords[k] * stride
        return [base + i * stride for i in range(sizes[k])]

    def global_rank(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def barrier(self) -> None:
        if self.size > 1:
            dist.barrier(group=self.group)

    @property
    def exchange(self) -> Exchange:
        """The rank's exchange buffers (allocated at the first exchange)."""
        if self._exchange is None:
            self._exchange = Exchange(self)
        return self._exchange

    def close(self) -> None:
        """Free the exchange buffers; every rank of the mesh calls it."""
        if self._exchange is not None:
            self._exchange.close()


def make_mesh(shape=None, names=("dp",), group=None, device=None) -> Mesh:
    """A mesh over every rank of ``group`` (default: one axis of all of
    them).  ``device`` defaults to ``cuda:(rank mod device_count)`` and
    raises without a card: pass ``device="cpu"`` for the plain paths."""
    world = dist.get_world_size(group) if dist.is_initialized() else 1
    if shape is None:
        shape = (world,)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {tuple(shape)} for axes {names}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass device='cpu' "
                               "for the plain paths")
        rank = dist.get_rank(group) if dist.is_initialized() else 0
        device = f"cuda:{rank % torch.cuda.device_count()}"
    return Mesh(dict(zip(names, (int(s) for s in shape))), group, device)


def shard_batch(ct: Ciphertext, mesh: Mesh, axis: str = "dp") -> Ciphertext:
    """This rank's shard of a batched ciphertext's leading axis (hetpu
    places the same slices on the mesh's devices), on the mesh's device."""
    n, i = mesh.shape[axis], mesh.axis_index(axis)
    b = ct.data.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not divide mesh axis {axis}={n}")
    k = b // n
    return ct.with_(data=ct.data[i * k:(i + 1) * k].to(mesh.device))


def replicate(tree, mesh: Mesh):
    """A tensor (or anything with ``.to(device)``) on every rank's device."""
    return tree.to(mesh.device)


def mod_all_reduce(x: torch.Tensor, q: torch.Tensor, mesh: Mesh,
                   axis: str) -> torch.Tensor:
    """Modular sum over ``mesh[axis]``: a butterfly of log2 n rounds, each
    a ``ppermute`` of i ↔ i ^ shift and a ``mod_add``; values stay in
    [0, q) (residues cannot ride a plain sum).  Needs a power-of-two
    axis."""
    n = mesh.shape[axis]
    if n & (n - 1):
        raise ValueError("mod_all_reduce needs a power-of-two axis size")
    shift = 1
    while shift < n:
        y = ppermute(x, mesh, axis, [(i, i ^ shift) for i in range(n)])
        x = mod_add(x, y, q)
        shift *= 2
    return x


def bucketed_matvec(sess, diags: Ciphertext, vec: Ciphertext, d: int,
                    mesh: Mesh, axis: str = "rot") -> Ciphertext:
    """Distributed encrypted matrix-vector product by the diagonal method,
    A·v = Σ_k diag_k(A) ⊙ rot(v, k), with the k-loop bucketed over
    ``mesh[axis]``: rank r key-switches steps r·k_per … (r+1)·k_per − 1
    with their Galois keys only, on one hoisted decomposition of v,
    accumulates a 3-part partial sum, and the partials meet in
    :func:`mod_all_reduce`; every rank then relinearizes and rescales.

    Requires d divisible by the axis size and galois keys for steps
    0..d−1 (step 0 is the identity element's self key switch).  diags:
    [d, parts, L, N] diag layout; vec: one 2-part ciphertext."""
    n_dev = mesh.shape[axis]
    if d % n_dev:
        raise ValueError(f"d={d} not divisible by mesh axis {n_dev}")
    k_per = d // n_dev
    first = mesh.axis_index(axis) * k_per
    n = sess.ctx.params.poly_degree
    lvl = vec.level
    ev = sess.ev
    q = sess.ctx.mont(lvl)["q"]
    c0, c1 = vec.data[0], vec.data[1]
    ext = ev._decompose(c1, lvl)                          # hoisted
    acc = None
    for s in range(first, first + k_per):
        elt = galois.rotation_elt(n, s)
        p0, p1 = ev._inner_product(galois.apply(ext, n, elt), lvl,
                                   sess.gk.key_for(elt))
        rot = torch.stack([mod_add(galois.apply(c0, n, elt), p0, q), p1])
        prod = ev.multiply(
            Ciphertext(data=rot, level=lvl, scale=vec.scale),
            Ciphertext(data=diags.data[s], level=lvl, scale=vec.scale))
        acc = prod.data if acc is None else mod_add(acc, prod.data, q)
    acc = mod_all_reduce(acc, q, mesh, axis)
    c3 = Ciphertext(data=acc, level=lvl, scale=vec.scale * diags.scale)
    return ev.rescale(ev.relinearize(c3, sess.rk))
