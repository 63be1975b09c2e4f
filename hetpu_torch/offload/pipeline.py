"""The offload pipeline: a client, and an evaluator whose batch is sharded
over the ranks of a mesh.

Counterpart of ``hetpu/offload/pipeline.py`` (``maybe_init_distributed``
:42, ``evaluate_sharded`` :55, ``_infer_weights``, ``infer_step``,
``infer_reference``, ``evaluate_sharded_infer`` :134, ``serve_pipeline``
:160, ``run_client`` :184, ``run_client_infer`` :207).  hetpu's evaluator
shards the batch axis over a ``dp`` mesh of devices and runs one jitted
program; here every rank of the mesh runs the step on its own rows of the
batch and the rows are gathered (``parallel.all_gather``: a
``peer_permute`` launch on the card), so each rank holds the whole
result.  The client keeps the reference's trust split: the secret key
never crosses the wire, and the evaluator's session comes from
``Session.from_wire``.  ``maybe_init_distributed`` spans processes when
``HETPU_COORD`` (host:port), ``HETPU_NUM_PROCS`` and ``HETPU_PROC_ID``
are set, over gloo.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from .. import parallel
from ..core import random as rnd
from ..core.modular import mod_add
from ..math import mult_const_to
from ..runtime import native
from ..session import Session
from . import recv_reply, recv_request, send_reply, send_request


def maybe_init_distributed() -> None:
    """Join the process group that the environment names (no-op without
    ``HETPU_COORD`` or when already joined): gloo over
    ``tcp://HETPU_COORD``, ``HETPU_NUM_PROCS`` ranks, this one
    ``HETPU_PROC_ID``."""
    coord = os.environ.get("HETPU_COORD")
    if coord and not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coord}",
            world_size=int(os.environ["HETPU_NUM_PROCS"]),
            rank=int(os.environ["HETPU_PROC_ID"]))


def _rows(mesh, axis: str, batch: int) -> slice:
    """This rank's rows of a batch split evenly over ``mesh[axis]``."""
    k = batch // mesh.shape[axis]
    i = mesh.axis_index(axis)
    return slice(i * k, (i + 1) * k)


def _gathered(out, mesh, axis: str) -> list:
    """Every rank's rows of ``out`` (a batched ciphertext) gathered in rank
    order: the per-item results."""
    data = parallel.all_gather(out.data.contiguous(), mesh, axis, dim=0)
    return [out.with_(data=data[j]) for j in range(data.shape[0])]


# (axis, device, default group) → (group, mesh): the meshes of the calls
# made without one, kept with their exchange buffers for the process's life
_DEFAULT_MESHES: dict = {}


def _default_mesh(axis: str, device):
    """One ``axis`` over every rank of the default group, on ``device``:
    made at the first call without a mesh and reused, since a new mesh
    allocates (and over several ranks maps) its exchange buffers again."""
    group = dist.group.WORLD if dist.is_initialized() else None
    device = parallel.resolve_device(device)
    key = (axis, device, id(group))
    hit = _DEFAULT_MESHES.get(key)
    if hit is None:
        hit = _DEFAULT_MESHES[key] = (
            group, parallel.make_mesh(names=(axis,), device=device))
    return hit[1]


def _on_mesh(fn, sess: Session, cts, mesh, axis: str, *args):
    """Run ``fn(sess, cts, mesh, axis, *args)``, by default on
    :func:`_default_mesh` over the session's device."""
    if mesh is None:
        mesh = _default_mesh(axis, sess.ctx.device)
    return fn(sess, cts, mesh, axis, *args)


def evaluate_sharded(sess: Session, cts, mesh=None, axis: str = "dp"):
    """The evaluator's program: pair the operands (first half × second
    half), shard the pairs over ``mesh[axis]`` (default: every rank), run
    multiply + relinearize + rescale, rotate by 1 and add on each rank's
    pairs, and return the per-item ciphertexts on every rank."""
    if len(cts) % 2 != 0:
        raise ValueError(
            f"evaluate_sharded pairs operands: need an even ciphertext "
            f"count, got {len(cts)}")
    return _on_mesh(_evaluate, sess, cts, mesh, axis)


def _evaluate(sess: Session, cts, mesh, axis: str):
    nd, half = mesh.shape[axis], len(cts) // 2
    if half % nd != 0:
        raise ValueError(
            f"batch of {half} pairs does not divide the {nd}-device dp "
            "mesh; pad the request or pass a smaller mesh")
    r = _rows(mesh, axis, half)
    xa = torch.stack([c.data for c in cts[:half][r]])
    xb = torch.stack([c.data for c in cts[half:][r]])
    proto = cts[0]
    prod = sess.ev.multiply_relin_rescale(
        proto.with_(data=xa), proto.with_(data=xb), sess.rk)
    rot = sess.ev.rotate(prod, 1, sess.gk)
    return _gathered(sess.ev.add(prod, rot), mesh, axis)


def _infer_weights(slots: int, n_diags: int, wseed: int):
    """Deterministic model weights derived from a seed: ``n_diags``
    circulant diagonals and a degree-2 activation polynomial."""
    rng = np.random.default_rng(wseed)
    diags = rng.uniform(-1, 1, (n_diags, slots)) / n_diags
    act = (0.5, 0.25, -0.02)          # c0 + c1·u + c2·u² (sigmoid-ish)
    return diags, act


def infer_step(sess: Session, ct, diags, act):
    """One inference layer on an encrypted activation vector: a
    diagonal-method matvec against plaintext weights (the rotations share
    ONE hoisted decomposition) and a degree-2 activation polynomial with
    exact solved-scale alignment.  Consumes 3 levels."""
    ev = sess.ev
    n_diags = len(diags)
    rots = [ct] + ev.rotate_hoisted(ct, list(range(1, n_diags)), sess.gk)
    q = sess.ctx.mont(ct.level)["q"]
    acc = None
    for d, src in enumerate(rots):
        pt = sess.cached_encode(("infer_diag", d, n_diags), diags[d],
                                level=src.level)
        term = ev.multiply_plain(src, pt)
        acc = term.data if acc is None else mod_add(acc, term.data, q)
    u = ev.rescale(term.with_(data=acc))               # W·x
    c0, c1, c2 = act
    u2 = ev.square_relin_rescale(u, sess.rk)           # u²
    s = u.scale
    quad = mult_const_to(sess, u2, c2, s)
    lin = mult_const_to(sess, sess.reach_level(u, u2.level), c1, s)
    y = ev.add(quad, lin)
    return ev.add_plain(y, sess.const_like(y, c0))


def infer_reference(x: np.ndarray, diags: np.ndarray, act) -> np.ndarray:
    """Plaintext replica of :func:`infer_step`."""
    u = sum(diags[d] * np.roll(x, -d) for d in range(len(diags)))
    c0, c1, c2 = act
    return c0 + c1 * u + c2 * u * u


def evaluate_sharded_infer(sess: Session, cts, wseed: int, n_diags: int = 8,
                           mesh=None, axis: str = "dp"):
    """The evaluator's inference program: shard the request batch over
    ``mesh[axis]`` (default: every rank) and run :func:`infer_step` on
    each rank's rows (config 5: a batched encrypted matvec and activation
    polynomial sharded over ranks); the per-item results on every rank."""
    return _on_mesh(_evaluate_infer, sess, cts, mesh, axis, wseed, n_diags)


def _evaluate_infer(sess: Session, cts, mesh, axis: str, wseed: int,
                    n_diags: int):
    nd = mesh.shape[axis]
    if len(cts) % nd != 0:
        raise ValueError(f"batch {len(cts)} does not divide dp mesh {nd}")
    diags, act = _infer_weights(sess.slots, n_diags, wseed)
    x = torch.stack([c.data for c in cts[_rows(mesh, axis, len(cts))]])
    out = infer_step(sess, cts[0].with_(data=x), diags, act)
    return _gathered(out, mesh, axis)


def _request_frames(t) -> list[bytes]:
    """The raw frames of one request, in :func:`recv_request`'s order: the
    header, the params, the relin and galois keys, then ``num_cts``
    ciphertexts."""
    header = t.recv()
    return [header] + [t.recv() for _ in range(
        3 + json.loads(header.decode())["num_cts"])]


class _Replay:
    """A transport that hands out recorded frames in order."""

    def __init__(self, frames):
        self.frames = list(frames)

    def recv(self) -> bytes:
        return self.frames.pop(0)


def serve_pipeline(transport=None, mesh=None) -> int:
    """Evaluator processes: answer ONE pipeline request over ``mesh``
    (default: one ``dp`` axis over every rank, each on its card).  Rank 0
    reads the request (from ``transport``, or the first connection to
    ``runtime.native.serve``) and passes its raw frames to the other ranks
    over the process group; every rank builds ``Session.from_wire`` on its
    device and runs its shard; rank 0 sends the reply.  Returns the batch
    size served."""
    own_mesh = mesh is None
    if own_mesh:
        maybe_init_distributed()
        mesh = parallel.make_mesh(names=("dp",))
    axis = mesh.axis_names[0]
    lead = mesh.rank == 0
    t = transport
    if lead and t is None:
        t, _ = native.serve()
    try:
        box = [_request_frames(t) if lead else None]
        if mesh.size > 1:
            dist.broadcast_object_list(box, src=mesh.global_rank(0),
                                       group=mesh.group)
        header, sess, cts = recv_request(_Replay(box[0]), mesh.device)
        if header["workload"] == "pipeline":
            results = evaluate_sharded(sess, cts, mesh, axis)
        elif header["workload"] == "pipeline_infer":
            results = evaluate_sharded_infer(
                sess, cts, wseed=int(header["wseed"]),
                n_diags=int(header.get("n_diags", 8)), mesh=mesh, axis=axis)
        else:
            raise ValueError(f"expected pipeline*, got {header['workload']!r}")
        if lead:
            send_reply(t, results)
        return len(results)
    finally:
        if lead and transport is None:
            t.close()
        if own_mesh:
            mesh.close()


def _encrypt_seeded(sess: Session, vals) -> tuple[list, list]:
    cts, seeds = [], []
    for v in vals:
        s = rnd.new_seed()
        cts.append(sess.encryptor.encrypt_symmetric(sess.encode(v), seed=s))
        seeds.append(s)
    return cts, seeds


def run_client(t, batch: int = 8, params="test_tiny", seed=None,
               device="cuda"):
    """Client: encrypt 2·batch operands (seeded symmetric: half the wire
    size), offload the ``pipeline`` workload, decrypt and check against the
    plaintext math.  Returns (max_error, results)."""
    sess = Session.create(params, seed=seed, galois_steps=[1], device=device)
    rng = np.random.default_rng(0)
    vals = [rng.uniform(-1, 1, sess.slots) for _ in range(2 * batch)]
    cts, seeds = _encrypt_seeded(sess, vals)
    send_request(t, "pipeline", sess.ctx.params, rk=sess.rk, gk=sess.gk,
                 cts=cts, seeds=seeds)
    res = recv_reply(t, sess.ctx)
    errs = []
    for i, ct in enumerate(res):
        got = sess.decrypt(ct).real
        w = vals[i] * vals[batch + i]
        errs.append(np.max(np.abs(got - (w + np.roll(w, -1)))))
    return float(np.max(errs)), res


def run_client_infer(t, batch: int = 8, params="test_deep", seed=None,
                     n_diags: int = 8, wseed: int = 7, device="cuda"):
    """Client of the inference pipeline: encrypt a batch of activation
    vectors, offload matvec + activation, decrypt and check against
    :func:`infer_reference`.  The galois keys cover the evaluator's
    rotations 1..n_diags−1.  Returns (max_error, results)."""
    sess = Session.create(params, seed=seed,
                          galois_steps=list(range(1, n_diags)), device=device)
    rng = np.random.default_rng(1)
    vals = [rng.uniform(-1, 1, sess.slots) for _ in range(batch)]
    cts, seeds = _encrypt_seeded(sess, vals)
    send_request(t, "pipeline_infer", sess.ctx.params, rk=sess.rk,
                 gk=sess.gk, cts=cts, seeds=seeds,
                 meta={"wseed": wseed, "n_diags": n_diags})
    res = recv_reply(t, sess.ctx)
    diags, act = _infer_weights(sess.slots, n_diags, wseed)
    errs = []
    for i, ct in enumerate(res):
        got = sess.decrypt(ct).real
        errs.append(np.max(np.abs(got - infer_reference(vals[i], diags,
                                                        act))))
    return float(np.max(errs)), res
