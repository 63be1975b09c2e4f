"""The rank programs of ``tests/test_torch_parallel.py`` (and of the card
test of P5): each runs in a process of its own, started with
``torch.multiprocessing`` (spawn), joins a gloo group and runs every case
of its world size on CPU tensors, writing each case's result to
``w{world}_r{rank}.npz``.  This module imports neither JAX nor hetpu, so
the spawned ranks do not either; the test compares their results with
hetpu's in its own process.

Every rank gets the same global inputs (``inputs.npz``, written by the
test from hetpu's sessions and encryptions) and builds the port's
sessions from the seeds hetpu's were built from, so the keys are equal.
A case that raises leaves its traceback under ``error:<case>`` instead of
a result.
"""

from __future__ import annotations

import datetime
import hashlib
import itertools
import json
import os
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from hetpu_torch import parallel
from hetpu_torch.core import cuda_lib, nt
from hetpu_torch.core import random as rnd
from hetpu_torch.core.ciphertext import Ciphertext
from hetpu_torch.core.keys import KSwitchKey, RelinKeys
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.ntt import build_tables, ntt_fwd, ntt_inv
from hetpu_torch.linalg import BatchedMatrix
from hetpu_torch.offload import pipeline
from hetpu_torch.parallel import cp, tp
from hetpu_torch.runtime import native
from hetpu_torch.session import Session

TINY_SEED = b"\x09" * 32
DNUM_SEED = b"\x41" * 32
TINY_STEPS = list(range(8))
DNUM_STEPS = [1, 2, 3]
CP_N = 2048
D = 8                          # bucketed matvec size
N_DIAGS, WSEED = 4, 7          # evaluate_sharded_infer
TIMEOUT = datetime.timedelta(seconds=180)


def load_ct(inp: dict, prefix: str) -> Ciphertext:
    level, scale = inp[f"{prefix}_meta"]
    return Ciphertext(data=from_u32(inp[prefix]), level=int(level),
                      scale=float(scale))


class Env:
    """One rank's sessions and inputs, built on first use."""

    def __init__(self, inp: dict, world: int):
        self.inp, self.world = inp, world
        self._tiny = self._dnum = None

    @property
    def tiny(self) -> Session:
        if self._tiny is None:
            self._tiny = Session.create("test_tiny", seed=TINY_SEED,
                                        galois_steps=TINY_STEPS, device="cpu")
        return self._tiny

    @property
    def dnum(self) -> Session:
        if self._dnum is None:
            self._dnum = Session.create("test_dnum", seed=DNUM_SEED,
                                        galois_steps=DNUM_STEPS, device="cpu")
        return self._dnum

    def mesh(self, axis: str) -> parallel.Mesh:
        return parallel.make_mesh((self.world,), (axis,), device="cpu")


# ----------------------------------------------------------------------
# cases: name → fn(env) → {key: array}
# ----------------------------------------------------------------------

def case_mod_all_reduce(env):
    mesh = env.mesh("r")
    x = torch.from_numpy(env.inp[f"mar_{env.world}"][mesh.rank]
                         .astype(np.int32))
    q = torch.tensor(97, dtype=torch.int32)
    return {"out": parallel.mod_all_reduce(x, q, mesh, "r").numpy()}


def case_permute(env):
    mesh = env.mesh("x")
    x = torch.from_numpy(env.inp[f"perm_{env.world}"][mesh.rank])
    perm = [(0, 2), (1, 3), (2, 0)] if env.world == 4 else [(0, 1)]
    return {"right": parallel.right_permute(x, mesh, "x").numpy(),
            "ppermute": parallel.ppermute(x, mesh, "x", perm).numpy()}


def case_shard_batch(env):
    mesh, s = env.mesh("dp"), env.tiny
    ct = load_ct(env.inp, "sb")
    mine = parallel.shard_batch(ct, mesh, "dp")
    out = s.ev.square_relin_rescale(mine, s.rk)
    full = parallel.all_gather(out.data, mesh, "dp", dim=0)
    return {"out": to_u32(full), "shard": to_u32(mine.data)}


def case_bucketed(env):
    mesh, s = env.mesh("rot"), env.tiny
    out = parallel.bucketed_matvec(s, load_ct(env.inp, "bm_diags"),
                                   load_ct(env.inp, "bm_vec"), D, mesh, "rot")
    return {"out": to_u32(out.data), "level": np.array(out.level)}


def case_use_mesh(env):
    mesh, s = env.mesh("rot"), env.tiny
    ma = BatchedMatrix(s, load_ct(env.inp, "um_a"), D, D, "diag")
    mv = BatchedMatrix(s, load_ct(env.inp, "um_v"), D, 1, "col")
    calls, orig = [], parallel.bucketed_matvec

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    parallel.bucketed_matvec = spy
    try:
        s.use_mesh(mesh, "rot")
        routed = ma.matmul(mv)
    finally:
        s.use_mesh(None)
        parallel.bucketed_matvec = orig
    local = ma.matmul(mv)
    return {"routed": to_u32(routed.ct.data), "local": to_u32(local.ct.data),
            "calls": np.array(len(calls))}


def case_tp(env):
    mesh, s = env.mesh("tp"), env.dnum
    c3 = load_ct(env.inp, "tp_c3")
    ct = load_ct(env.inp, "tp_ct")
    out = {"relin": to_u32(tp.tp_relinearize(s, c3, mesh, "tp").data),
           "relin_ev": to_u32(s.ev.relinearize(c3, s.rk).data)}
    for steps in (1, 2):
        out[f"rot{steps}"] = to_u32(tp.tp_rotate(s, ct, steps, mesh).data)
        out[f"rot{steps}_ev"] = to_u32(s.ev.rotate(ct, steps, s.gk).data)
    ctx = s.ctx
    n_keys = len(ctx._tp_keys)
    tp.tp_rotate(s, ct, 1, mesh)
    out["caches"] = np.array([len(ctx._tp_plans), len(ctx._tp_consts),
                              n_keys, len(ctx._tp_keys)])
    return out


def case_tp_ties(env):
    """tp_relinearize with a relin key whose special rows put the near-tie
    α columns into the mod-down's sources (see the test)."""
    mesh, s = env.mesh("tp"), env.dnum
    key = RelinKeys(key=KSwitchKey(data=from_u32(env.inp["tie_key"]),
                                   shoup=from_u32(env.inp["tie_key_shoup"])))
    c3 = load_ct(env.inp, "tp_c3")
    saved, s.rk = s.rk, key
    try:
        got = tp.tp_relinearize(s, c3, mesh, "tp")
        want = s.ev.relinearize(c3, key)
    finally:
        s.rk = saved
    return {"relin": to_u32(got.data), "relin_ev": to_u32(want.data)}


def case_cp(env):
    mesh = env.mesh("cp")
    primes = [int(p) for p in env.inp["cp_primes"]]
    t = cp.build_tables(CP_N, primes, "cpu")
    x = from_u32(env.inp["cp_x"])
    y = from_u32(env.inp["cp_y"])
    fwd = cp.cp_ntt_fwd(x, t, mesh)
    return {"fwd": to_u32(fwd), "inv": to_u32(cp.cp_ntt_inv(y, t, mesh)),
            "inv_strip": to_u32(cp.cp_ntt_inv(y, t, mesh, strip_mont=True)),
            "roundtrip": to_u32(cp.cp_ntt_inv(fwd, t, mesh))}


def case_evaluate(env):
    mesh, s = env.mesh("dp"), env.tiny
    cts = [load_ct(env.inp, f"ev_{i}") for i in range(4)]
    res = pipeline.evaluate_sharded(s, cts, mesh)
    bad = []
    for odd in (cts[:3], cts[:2]):
        try:
            pipeline.evaluate_sharded(s, odd, mesh)
        except ValueError as e:
            bad.append(str(e))
    return {"out": np.stack([to_u32(r.data) for r in res]),
            "errors": np.array(bad)}


def case_evaluate_infer(env):
    mesh, s = env.mesh("dp"), env.dnum
    cts = [load_ct(env.inp, f"inf_{i}") for i in range(2)]
    res = pipeline.evaluate_sharded_infer(s, cts, WSEED, N_DIAGS, mesh)
    try:
        pipeline.evaluate_sharded_infer(s, cts[:1], WSEED, N_DIAGS, mesh)
        bad = ""
    except ValueError as e:
        bad = str(e)
    return {"out": np.stack([to_u32(r.data) for r in res]),
            "meta": np.array([res[0].level, res[0].scale]),
            "error": np.array(bad)}


def case_mesh2d(env):
    mesh = parallel.make_mesh((2, 2), ("a", "b"), device="cpu")
    r = torch.tensor([mesh.rank], dtype=torch.int32)
    q = torch.tensor(97, dtype=torch.int32)
    return {"coords": np.array(mesh.coords),
            "ranks_a": np.array(mesh.axis_ranks("a")),
            "ranks_b": np.array(mesh.axis_ranks("b")),
            "gather_b": parallel.all_gather(r, mesh, "b").numpy(),
            "reduce_a": parallel.mod_all_reduce(r, q, mesh, "a").numpy()}


def case_serve(env, sock):
    """Two requests (pipeline, pipeline_infer) from hetpu's clients in the
    test process, over the socket pair's end that rank 0 holds."""
    mesh = env.mesh("dp")
    t = native.Transport(sock=sock) if mesh.rank == 0 else None
    return {"served": np.array([pipeline.serve_pipeline(t, mesh)
                                for _ in range(2)])}


CASES = {2: ("mod_all_reduce", "permute", "shard_batch", "bucketed",
             "use_mesh", "tp", "tp_ties", "cp", "evaluate", "evaluate_infer"),
         4: ("mod_all_reduce", "permute", "bucketed", "tp", "tp_ties", "cp",
             "mesh2d")}


def fixed_seeds():
    """The port's ``new_seed`` as one sequence on every rank, so that the
    encryptions a case makes are the same everywhere (SPMD)."""
    counter = itertools.count()
    rnd.new_seed = lambda: hashlib.sha256(
        f"ranks:{next(counter)}".encode()).digest()


def main(rank: int, world: int, store: str, workdir: str, sock=None) -> None:
    """Rank ``rank`` of ``world``: every case of the world size."""
    torch.set_num_threads(1)
    fixed_seeds()
    if sock is not None and rank != 0:
        sock.close()
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    work = Path(workdir)
    out = {}
    try:
        env = Env(dict(np.load(work / "inputs.npz")), world)
        cases = [(c, globals()[f"case_{c}"]) for c in CASES[world]]
        if sock is not None:
            cases.append(("serve", lambda e: case_serve(e, sock)))
        for name, fn in cases:
            try:
                out.update({f"{name}:{k}": v for k, v in fn(env).items()})
            except Exception:             # recorded; the test reports it
                out[f"error:{name}"] = np.array(traceback.format_exc())
    finally:
        np.savez(work / f"w{world}_r{rank}.npz", **out)
        dist.destroy_process_group()


def main_init(rank: int, coord: str, workdir: str) -> None:
    """A rank that joins its group through ``maybe_init_distributed``
    (``HETPU_COORD`` / ``HETPU_NUM_PROCS`` / ``HETPU_PROC_ID``) and runs one
    modular all-reduce over it."""
    torch.set_num_threads(1)
    os.environ.update(HETPU_COORD=coord, HETPU_NUM_PROCS="2",
                      HETPU_PROC_ID=str(rank))
    pipeline.maybe_init_distributed()
    try:
        mesh = parallel.make_mesh(device="cpu")
        x = torch.full((4, 8), 40 + rank, dtype=torch.int32)
        got = parallel.mod_all_reduce(x, torch.tensor(97, dtype=torch.int32),
                                      mesh, "dp")
        np.savez(Path(workdir) / f"init_r{rank}.npz", out=got.numpy(),
                 world=np.array(dist.get_world_size()))
    finally:
        dist.destroy_process_group()


def main_card(rank: int, world: int, store: str, workdir: str) -> None:
    """A rank on cuda:0 for tests/test_torch_cuda.py: P5 (every exchange,
    aligned and unaligned sizes) against its gloo twin on the same values,
    then tp_relinearize (test_dnum) and cp at n=2048 on the card against
    their single-rank results; writes ``card_r{rank}.json``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        torch.cuda.set_device(0)
        mesh = parallel.make_mesh((world,), ("x",))
        g = torch.Generator().manual_seed(rank)
        xs = {"f32": torch.randn(8, 128, generator=g),
              "i32": torch.randint(0, 1 << 30, (2 * world, 5, 1024),
                                   generator=g, dtype=torch.int32),
              "unaligned": torch.randint(0, 1 << 30, (2 * world, 7),
                                         generator=g, dtype=torch.int32)}
        ops = {"right": lambda v: parallel.right_permute(v, mesh, "x"),
               "ppermute": lambda v: parallel.ppermute(v, mesh, "x",
                                                       [(0, 1)]),
               "all_to_all": lambda v: parallel.all_to_all(v, mesh, "x", 0,
                                                           1),
               "all_gather": lambda v: parallel.all_gather(v, mesh, "x", 1)}
        out = {}
        for name, x in xs.items():
            for op, fn in ops.items():
                got, want = fn(x.to(mesh.device)), fn(x)
                out[f"{name}_{op}"] = bool(torch.equal(got.cpu(), want))
        out["launches"] = cuda_lib.launches["peer_permute"]
        s = Session.create("test_dnum", seed=DNUM_SEED, galois_steps=[1])
        enc = lambda v, tag: s.encrypt(v, seed=bytes([tag]) * 32)
        x = np.random.default_rng(5).uniform(-1, 1, s.slots)
        c3 = s.ev.multiply(enc(x, 1), enc(x, 2))
        tmesh = parallel.make_mesh((world,), ("tp",))
        out["tp"] = bool(torch.equal(tp.tp_relinearize(s, c3, tmesh).data,
                                     s.ev.relinearize(c3, s.rk).data))
        primes = nt.gen_primes(24, 2, 2 * CP_N)[:2]
        t4 = cp.build_tables(CP_N, primes, mesh.device)
        tf = build_tables(CP_N, primes, mesh.device)
        v = from_u32(np.stack([np.random.default_rng(6).integers(
            0, q, CP_N, dtype=np.uint32) for q in primes]), mesh.device)
        cmesh = parallel.make_mesh((world,), ("cp",))
        out["cp_fwd"] = bool(torch.equal(cp.cp_ntt_fwd(v, t4, cmesh),
                                         ntt_fwd(v, tf)))
        out["cp_inv"] = bool(torch.equal(cp.cp_ntt_inv(v, t4, cmesh),
                                         ntt_inv(v, tf)))
        out["cp_inv_strip"] = bool(torch.equal(
            cp.cp_ntt_inv(v, t4, cmesh, strip_mont=True),
            ntt_inv(v, tf, strip_mont=True)))
        for m in (mesh, tmesh, cmesh):
            m.close()
        (Path(workdir) / f"card_r{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit("torch_parallel_ranks: started by tests/test_torch_parallel.py")
