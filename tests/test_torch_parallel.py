"""The parallel layer of the port (``hetpu_torch.parallel``: ``Mesh``, the
``peer_permute`` exchanges, ``mod_all_reduce``, ``shard_batch``,
``bucketed_matvec``, ``tp``, ``cp``; ``Session.use_mesh``; the sharded
pipeline) against hetpu's on the CPU.

The port's side runs as SPMD ranks of a gloo group: ``torch.multiprocessing``
(spawn) starts 2 and 4 processes once for the module
(``tests/torch_parallel_ranks.py``, a file store under ``tmp_path``, so
parallel test workers share no port); each rank runs every case of its
world size on the same global inputs (written here from hetpu's sessions
and encryptions) and saves its result, so that each case stays a test of
its own.  hetpu's side runs here on conftest's 8-device CPU mesh.  Every
rank's result must equal hetpu's bit for bit; the only tolerance is the
decrypt bound of hetpu's pipeline clients (5e-3, tests/test_offload.py).

hetpu's clients (``run_client``, ``run_client_infer``) talk to the port's
``serve_pipeline`` on the 2 ranks over an in-process socket pair whose
other end rank 0 holds; a third spawn joins its group through
``maybe_init_distributed``.
"""

import socket
import threading
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from hetpu import parallel as ref_parallel
from hetpu.core import nt, ntt4 as ref_ntt4
from hetpu.core import serial as ref_serial
from hetpu.linalg import BatchedMatrix as RefBatchedMatrix
from hetpu.offload import pipeline as ref_pipeline
from hetpu.offload import recv_request as ref_recv_request
from hetpu.parallel import cp as ref_cp, tp as ref_tp
from hetpu.runtime import native as ref_native
from hetpu.session import Session as RefSession
from hetpu_torch import parallel
from hetpu_torch.core import cuda_lib
from hetpu_torch.core.modular import from_u32, shoup_companion, to_u32
from hetpu_torch.core.ntt import build_tables, ntt_fwd, ntt_inv, ntt_fwd_plain
from hetpu_torch.offload import pipeline
from hetpu_torch.runtime import native
from hetpu_torch.session import Session
from torch_app_cases import fixed_seeds
from torch_ties import TIES_DNUM_MODDOWN
import torch_parallel_ranks as ranks

torch.set_num_threads(1)

WORLDS = (2, 4)
JOIN_S = 300
CLIENT_BATCH = 2


def _u32(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint32)


def _ct(prefix: str, ct) -> dict:
    return {prefix: _u32(ct.data), f"{prefix}_meta":
            np.array([ct.level, ct.scale])}


def _mesh(world: int, name: str) -> Mesh:
    return Mesh(np.array(jax.devices()[:world]), axis_names=(name,))


class Tap:
    """hetpu's transport with the frames it sends and receives kept."""

    def __init__(self, t):
        self.t, self.sent, self.got = t, [], []

    def send(self, payload: bytes) -> None:
        self.sent.append(bytes(payload))
        self.t.send(payload)

    def recv(self) -> bytes:
        self.got.append(self.t.recv())
        return self.got[-1]


class Replay:
    def __init__(self, frames):
        self.frames = list(frames)

    def recv(self) -> bytes:
        return self.frames.pop(0)


def _tie_key(c3):
    """A relin key whose special rows make the mod-down's α sources equal
    the near-tie columns TIES_DNUM_MODDOWN (tiled over N): digit 0's
    special rows are acc_sp / ext_0 and the other digits' zero there, so
    the key inner product's special rows are acc_sp = NTT(u·R·P̂ᵢ), whose
    INTT with the P̂⁻¹ epilogue is u.  The data rows stay the real key's."""
    port = Session.create("test_dnum", seed=ranks.DNUM_SEED,
                          galois_steps=[], device="cpu")
    ctx, lvl = port.ctx, c3.level
    plan = ctx.keyswitch_plan(lvl)
    md = plan.moddown
    L, nd, n = lvl + 1, ctx.num_data, ctx.params.poly_degree
    ext = port.ev._decompose(from_u32(_u32(c3.data)[2]), lvl)   # [J, R, N]
    p = np.array(ctx.params.special_moduli, dtype=object)
    u = np.tile(np.array(TIES_DNUM_MODDOWN, dtype=np.uint32).T,
                (1, n // len(TIES_DNUM_MODDOWN)))             # [α, N]
    inv_punit = to_u32(md.fbc.inv_punit)[:, 0]
    v = np.stack([(u[k].astype(object) * ((1 << 32) % int(p[k]))
                   * pow(int(inv_punit[k]), -1, int(p[k])) % int(p[k]))
                  for k in range(len(p))]).astype(np.uint32)
    acc_sp = ntt_fwd_plain(from_u32(v), md.src_tables)
    back = ntt_inv(acc_sp, md.src_tables, strip_mont=True,
                   extra=md.fbc.inv_punit)
    assert np.array_equal(to_u32(back), u)
    key = to_u32(port.rk.key.data).astype(object)
    e0 = to_u32(ext[0, L:]).astype(object)
    assert (e0 != 0).all()
    sp = to_u32(acc_sp).astype(object)
    for k in range(len(p)):
        inv = np.array([pow(int(e), -1, int(p[k])) for e in e0[k]],
                       dtype=object)
        key[0, :, nd + k] = sp[k] * inv % int(p[k])
        key[1:, :, nd + k] = 0
    key = key.astype(np.uint32)
    shoup = to_u32(shoup_companion(from_u32(key), ctx.tables_full.q))
    return key, shoup


@pytest.fixture(scope="module")
def ref():
    """hetpu's sessions (the ranks build the port's from the same seeds)."""
    return {"tiny": RefSession.create("test_tiny", seed=ranks.TINY_SEED,
                                      galois_steps=ranks.TINY_STEPS),
            "dnum": RefSession.create("test_dnum", seed=ranks.DNUM_SEED,
                                      galois_steps=ranks.DNUM_STEPS)}


def _encrypt(sess, values, tag: int):
    return sess.encryptor.encrypt(sess.encode(values),
                                  seed=bytes([tag]) * 32)


@pytest.fixture(scope="module")
def inputs(ref, tmp_path_factory):
    """The global inputs of every case, as hetpu's objects and as the npz
    the ranks read."""
    work = tmp_path_factory.mktemp("parallel")
    tiny, dnum = ref["tiny"], ref["dnum"]
    rng = np.random.default_rng(11)
    inp, obj = {}, {}
    for w in WORLDS:
        inp[f"mar_{w}"] = rng.integers(0, 97, (w, 4, 128)).astype(np.uint32)
        inp[f"perm_{w}"] = rng.standard_normal((w, 8, 128)).astype(np.float32)
    xs = rng.uniform(-1, 1, (8, tiny.slots))
    cts = [_encrypt(tiny, x, 1 + i) for i, x in enumerate(xs)]
    obj["sb"] = cts[0].with_(data=jnp.stack([c.data for c in cts]))
    obj["sb_x"] = xs
    d = ranks.D
    A = rng.uniform(-1, 1, (d, d))
    v = rng.uniform(-1, 1, d)
    rows = [_encrypt(tiny, np.tile([A[i, (i + j) % d] for i in range(d)], 2),
                     20 + j).data for j in range(d)]
    obj["bm_diags"] = _encrypt(tiny, np.zeros(d), 30).with_(
        data=jnp.stack(rows))
    obj["bm_vec"] = _encrypt(tiny, np.tile(v, 2), 31)
    obj["A"], obj["v"] = A, v
    obj["um_a"] = RefBatchedMatrix(tiny, obj["bm_diags"], d, d, "diag")
    obj["um_v"] = RefBatchedMatrix(
        tiny, obj["bm_vec"].with_(data=obj["bm_vec"].data[None]), d, 1, "col")
    x, y = rng.uniform(-1, 1, (2, dnum.slots))
    obj["tp_c3"] = dnum.ev.multiply(_encrypt(dnum, x, 40),
                                    _encrypt(dnum, y, 41))
    obj["tp_ct"] = _encrypt(dnum, x, 42)
    obj["tp_x"] = x
    inp["tie_key"], inp["tie_key_shoup"] = _tie_key(obj["tp_c3"])
    primes = nt.gen_primes(24, 2, 2 * ranks.CP_N)[:2]
    inp["cp_primes"] = np.array(primes, dtype=np.int64)
    inp["cp_x"] = np.stack([rng.integers(0, q, ranks.CP_N, dtype=np.uint32)
                            for q in primes])
    inp["cp_y"] = np.stack([rng.integers(0, q, ranks.CP_N, dtype=np.uint32)
                            for q in primes])
    ev_x = rng.uniform(-1, 1, (4, tiny.slots))
    obj["ev"] = [_encrypt(tiny, x, 50 + i) for i, x in enumerate(ev_x)]
    inf_x = rng.uniform(-1, 1, (2, dnum.slots))
    obj["inf"] = [_encrypt(dnum, x, 60 + i) for i, x in enumerate(inf_x)]
    for k in ("sb", "bm_diags", "bm_vec", "tp_c3", "tp_ct"):
        inp.update(_ct(k, obj[k]))
    inp.update(_ct("um_a", obj["um_a"].ct))
    inp.update(_ct("um_v", obj["um_v"].ct))
    for i, c in enumerate(obj["ev"]):
        inp.update(_ct(f"ev_{i}", c))
    for i, c in enumerate(obj["inf"]):
        inp.update(_ct(f"inf_{i}", c))
    np.savez(work / "inputs.npz", **inp)
    return work, inp, obj


def _start(fn, args, nprocs):
    return mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                              start_method="spawn")


def _join(ctx, deadline: float) -> None:
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("ranks did not finish")


@pytest.fixture(scope="module")
def runs(ref, inputs):
    """Spawn the 2- and 4-rank groups once; meanwhile compute hetpu's
    bucketed_matvec and serve hetpu's two pipeline clients from the 2
    ranks.  Returns (results by world and rank, the clients' outcomes,
    hetpu's bucketed_matvec by world)."""
    work = inputs[0]
    a, b = socket.socketpair()
    a.settimeout(JOIN_S)
    ctx2 = _start(ranks.main, (2, str(work / "store2"), str(work), b), 2)
    b.close()
    ctx4 = _start(ranks.main, (4, str(work / "store4"), str(work)), 4)
    clients = {}
    try:
        # while the ranks run: hetpu's bucketed_matvec by rot axis size
        obj = inputs[2]
        bucketed = {w: ref_parallel.bucketed_matvec(
            ref["tiny"], obj["bm_diags"], obj["bm_vec"], ranks.D,
            _mesh(w, "rot"), "rot") for w in WORLDS}
        t = Tap(ref_native.Transport(sock=a))
        with fixed_seeds("pipeline"):
            clients["pipeline"] = ref_pipeline.run_client(
                t, batch=CLIENT_BATCH, params="test_tiny",
                seed=ranks.TINY_SEED)
        clients["pipeline_frames"] = (t.sent, t.got)
        t = Tap(ref_native.Transport(sock=a))
        with fixed_seeds("infer"):
            clients["pipeline_infer"] = ref_pipeline.run_client_infer(
                t, batch=CLIENT_BATCH, params="test_dnum",
                seed=ranks.DNUM_SEED, n_diags=ranks.N_DIAGS,
                wseed=ranks.WSEED)
        clients["pipeline_infer_frames"] = (t.sent, t.got)
    except OSError as e:                    # reported by the serve test
        clients["error"] = repr(e)
    finally:
        a.close()
        deadline = time.monotonic() + JOIN_S
        _join(ctx2, deadline)
        _join(ctx4, deadline)
    res = {w: [dict(np.load(work / f"w{w}_r{r}.npz")) for r in range(w)]
           for w in WORLDS}
    return res, clients, bucketed


def _results(runs, world: int, case: str) -> list[dict]:
    """Each rank's outputs of ``case``; fails with a rank's traceback."""
    out = []
    for r in runs[0][world]:
        err = r.get(f"error:{case}")
        assert err is None, str(err)
        out.append({k.split(":", 1)[1]: v for k, v in r.items()
                    if k.startswith(f"{case}:")})
    return out


# ----------------------------------------------------------------------
# P5 and the butterfly
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_mod_all_reduce(runs, inputs, world):
    from jax import shard_map
    x = inputs[1][f"mar_{world}"]
    fn = shard_map(lambda xs: ref_parallel.mod_all_reduce(
        xs[0], np.uint32(97), "r"), mesh=_mesh(world, "r"),
        in_specs=(P("r"),), out_specs=P(), check_vma=False)
    want = np.asarray(fn(jnp.asarray(x)))
    np.testing.assert_array_equal(want, x.astype(np.uint64).sum(0) % 97)
    for r in _results(runs, world, "mod_all_reduce"):
        np.testing.assert_array_equal(_u32(r["out"]), want)


@pytest.mark.parametrize("world", WORLDS)
def test_right_permute_and_ppermute(runs, inputs, world):
    """right_permute is the snippet's shift; ppermute follows
    jax.lax.ppermute (a rank no pair targets gets zeros)."""
    x = inputs[1][f"perm_{world}"]
    perm = {0: 2, 1: 3, 2: 0} if world == 4 else {0: 1}
    src = {d: s for s, d in perm.items()}
    for rank, r in enumerate(_results(runs, world, "permute")):
        np.testing.assert_array_equal(r["right"], x[(rank - 1) % world])
        want = x[src[rank]] if rank in src else np.zeros_like(x[0])
        np.testing.assert_array_equal(r["ppermute"], want)


# ----------------------------------------------------------------------
# dp, the rotation buckets, use_mesh
# ----------------------------------------------------------------------

def test_shard_batch_square_relin_rescale(runs, ref, inputs):
    tiny, obj = ref["tiny"], inputs[2]
    mesh = _mesh(8, "dp")
    want = tiny.ev.square_relin_rescale(
        ref_parallel.shard_batch(obj["sb"], mesh, "dp"), tiny.rk)
    data = _u32(obj["sb"].data)
    for rank, r in enumerate(_results(runs, 2, "shard_batch")):
        np.testing.assert_array_equal(r["shard"],
                                      data[rank * 4:(rank + 1) * 4])
        np.testing.assert_array_equal(r["out"], _u32(want.data))
    got = tiny.decrypt(want.with_(data=jnp.asarray(r["out"][5])))
    np.testing.assert_allclose(got.real, obj["sb_x"][5] ** 2, atol=1e-3)


@pytest.fixture(scope="module")
def ref_bucketed(runs):
    return runs[2]


@pytest.mark.parametrize("world", WORLDS)
def test_bucketed_matvec(runs, ref, inputs, ref_bucketed, world):
    tiny, obj = ref["tiny"], inputs[2]
    want = ref_bucketed[world]
    for r in _results(runs, world, "bucketed"):
        assert int(r["level"]) == want.level
        np.testing.assert_array_equal(r["out"], _u32(want.data))
    got = tiny.decrypt(want.with_(data=jnp.asarray(r["out"])))
    np.testing.assert_allclose(got.real[:ranks.D], obj["A"] @ obj["v"],
                               atol=1e-2)


def test_use_mesh_routes_matmul(runs, inputs, ref_bucketed):
    """BatchedMatrix diag×col goes through bucketed_matvec when the
    session has a mesh (a spy counts the calls) and equals hetpu's
    bucketed_matvec of the same operands (which hetpu's routed matmul
    returns, tests/test_parallel.py); without the mesh it equals hetpu's
    local product."""
    obj = inputs[2]
    local = obj["um_a"].matmul(obj["um_v"])
    for r in _results(runs, 2, "use_mesh"):
        assert int(r["calls"]) == 1
        np.testing.assert_array_equal(r["routed"][0],
                                      _u32(ref_bucketed[2].data))
        np.testing.assert_array_equal(r["local"], _u32(local.ct.data))


# ----------------------------------------------------------------------
# tp and cp
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_tp_relinearize(runs, ref, inputs, world):
    dnum, obj = ref["dnum"], inputs[2]
    want = ref_tp.tp_relinearize(dnum, obj["tp_c3"], _mesh(world, "tp"),
                                 axis="tp")
    for r in _results(runs, world, "tp"):
        np.testing.assert_array_equal(r["relin"], _u32(want.data))
        np.testing.assert_array_equal(r["relin_ev"], r["relin"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("steps", [1, 2])
def test_tp_rotate(runs, ref, inputs, world, steps):
    dnum, obj = ref["dnum"], inputs[2]
    want = ref_tp.tp_rotate(dnum, obj["tp_ct"], steps, _mesh(world, "tp"))
    for r in _results(runs, world, "tp"):
        np.testing.assert_array_equal(r[f"rot{steps}"], _u32(want.data))
        np.testing.assert_array_equal(r[f"rot{steps}_ev"], r[f"rot{steps}"])
    got = dnum.decrypt(want.with_(data=jnp.asarray(r[f"rot{steps}"])))
    np.testing.assert_allclose(got.real, np.roll(obj["tp_x"], -steps),
                               atol=5e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_caches(runs, world):
    """As tests/test_parallel.py:176-184: one plan and one set of the
    rank's constants for the configuration, one key slice set per key, and
    a repeat rotation builds none."""
    for r in _results(runs, world, "tp"):
        plans, consts, keys, keys_after = (int(v) for v in r["caches"])
        assert (plans, consts) == (1, 1)
        assert keys == 3 and keys_after == keys


@pytest.mark.parametrize("world", WORLDS)
def test_tp_relinearize_near_tie_alpha(runs, ref, inputs, world):
    """hetpu's tp mod-down α is a jitted jnp.sum (tp.py:357-359): an fma
    chain.  With a key that puts the near-tie columns into the mod-down's
    sources, the port's tp and single-rank relinearize equal hetpu's tp."""
    from hetpu.core.keys import KSwitchKey, RelinKeys
    dnum, (_, inp, obj) = ref["dnum"], inputs
    saved = dnum.rk
    dnum.rk = RelinKeys(key=KSwitchKey(data=jnp.asarray(inp["tie_key"]),
                                       shoup=jnp.asarray(
                                           inp["tie_key_shoup"])))
    try:
        want = ref_tp.tp_relinearize(dnum, obj["tp_c3"], _mesh(world, "tp"),
                                     axis="tp")
        single = dnum.ev.relinearize(obj["tp_c3"], dnum.rk)
    finally:
        dnum.rk = saved
    np.testing.assert_array_equal(_u32(single.data), _u32(want.data))
    for r in _results(runs, world, "tp_ties"):
        np.testing.assert_array_equal(r["relin"], _u32(want.data))
        np.testing.assert_array_equal(r["relin_ev"], r["relin"])


@pytest.mark.parametrize("world", WORLDS)
def test_cp_ntt(runs, inputs, world):
    """cp_ntt_fwd / cp_ntt_inv at n=2048 equal hetpu's on its four-step
    tables and the port's flat NTT; inv∘fwd is the identity."""
    inp = inputs[1]
    primes = [int(p) for p in inp["cp_primes"]]
    t4 = ref_ntt4.build_tables(ranks.CP_N, primes)
    mesh = _mesh(world, "cp")
    # jitted: the integer transform's bits do not depend on it, and eager
    # shard_map takes minutes here
    want_f = np.asarray(jax.jit(lambda a: ref_cp.cp_ntt_fwd(a, t4, mesh))(
        jnp.asarray(inp["cp_x"])))
    want_i = np.asarray(jax.jit(lambda a: ref_cp.cp_ntt_inv(a, t4, mesh))(
        jnp.asarray(inp["cp_y"])))
    tf = build_tables(ranks.CP_N, primes, "cpu")
    np.testing.assert_array_equal(to_u32(ntt_fwd(from_u32(inp["cp_x"]), tf)),
                                  want_f)
    np.testing.assert_array_equal(to_u32(ntt_inv(from_u32(inp["cp_y"]), tf)),
                                  want_i)
    for r in _results(runs, world, "cp"):
        np.testing.assert_array_equal(r["fwd"], want_f)
        np.testing.assert_array_equal(r["inv"], want_i)
        np.testing.assert_array_equal(r["roundtrip"], inp["cp_x"])


@pytest.mark.parametrize("world", WORLDS)
def test_cp_ntt_inv_strip_mont(runs, inputs, world):
    """cp_ntt_inv(strip_mont=True) (×N⁻¹R⁻¹) equals hetpu's jitted
    cp_ntt_inv(strip_mont=True) and the port's flat ntt_inv(strip_mont=
    True), bit for bit, on every rank."""
    inp = inputs[1]
    primes = [int(p) for p in inp["cp_primes"]]
    t4 = ref_ntt4.build_tables(ranks.CP_N, primes)
    mesh = _mesh(world, "cp")
    want = np.asarray(jax.jit(lambda a: ref_cp.cp_ntt_inv(
        a, t4, mesh, strip_mont=True))(jnp.asarray(inp["cp_y"])))
    tf = build_tables(ranks.CP_N, primes, "cpu")
    np.testing.assert_array_equal(
        to_u32(ntt_inv(from_u32(inp["cp_y"]), tf, strip_mont=True)), want)
    for r in _results(runs, world, "cp"):
        np.testing.assert_array_equal(r["inv_strip"], want)


# ----------------------------------------------------------------------
# the sharded pipeline
# ----------------------------------------------------------------------

def test_evaluate_sharded(runs, ref, inputs):
    tiny, obj = ref["tiny"], inputs[2]
    want = ref_pipeline.evaluate_sharded(tiny, obj["ev"], n_devices=2)
    msgs = []
    for bad in (obj["ev"][:3], obj["ev"][:2]):
        with pytest.raises(ValueError) as e:
            ref_pipeline.evaluate_sharded(tiny, bad, n_devices=2)
        msgs.append(str(e.value))
    for r in _results(runs, 2, "evaluate"):
        np.testing.assert_array_equal(
            r["out"], np.stack([_u32(c.data) for c in want]))
        assert str(r["errors"][0]) == msgs[0]
        prefix = msgs[1].split(";")[0]
        assert str(r["errors"][1]).split(";")[0] == prefix


def test_evaluate_sharded_infer(runs, ref, inputs):
    dnum, obj = ref["dnum"], inputs[2]
    want = ref_pipeline.evaluate_sharded_infer(
        dnum, obj["inf"], ranks.WSEED, ranks.N_DIAGS, n_devices=2)
    with pytest.raises(ValueError) as e:
        ref_pipeline.evaluate_sharded_infer(dnum, obj["inf"][:1], ranks.WSEED,
                                            ranks.N_DIAGS, n_devices=2)
    for r in _results(runs, 2, "evaluate_infer"):
        assert (int(r["meta"][0]), float(r["meta"][1])) == \
            (want[0].level, want[0].scale)
        np.testing.assert_array_equal(
            r["out"], np.stack([_u32(c.data) for c in want]))
        assert str(r["error"]) == str(e.value)


@pytest.mark.parametrize("workload", ["pipeline", "pipeline_infer"])
def test_serve_pipeline(runs, workload):
    """hetpu's client against the port's serve_pipeline on 2 ranks over
    the socket pair: the client's decrypt error is within hetpu's bound,
    and the reply frames equal hetpu's own evaluator's (n_devices=2) on
    the same request frames, byte for byte."""
    clients = runs[1]
    assert "error" not in clients, clients.get("error")
    served = [int(v) for v in _results(runs, 2, "serve")[0]["served"]]
    assert served == [CLIENT_BATCH, CLIENT_BATCH]
    max_err, _ = clients[workload]
    assert max_err < 5e-3, max_err
    sent, got = clients[f"{workload}_frames"]
    header, sess, cts = ref_recv_request(Replay(sent))
    if workload == "pipeline":
        want = ref_pipeline.evaluate_sharded(sess, cts, n_devices=2)
    else:
        want = ref_pipeline.evaluate_sharded_infer(
            sess, cts, wseed=int(header["wseed"]),
            n_diags=int(header["n_diags"]), n_devices=2)
    assert got[1:] == [ref_serial.dump_ciphertext(c) for c in want]


def test_port_client_against_hetpu_server(runs):
    """The port's run_client against hetpu's serve_pipeline (a thread,
    over the port's in-process pipe pair), on the seeds of hetpu's client
    in test_serve_pipeline: it sends hetpu's client's request frames byte
    for byte, gets hetpu's server's reply, and decrypts within the
    bound."""
    a, b = native.pipe_pair()
    served = []
    th = threading.Thread(target=lambda: served.append(
        ref_pipeline.serve_pipeline(b, n_devices=2)))
    th.start()
    tap = Tap(a)
    with fixed_seeds("pipeline"):
        err, _ = pipeline.run_client(tap, batch=CLIENT_BATCH,
                                     params="test_tiny", seed=ranks.TINY_SEED,
                                     device="cpu")
    th.join(timeout=JOIN_S)
    assert served == [CLIENT_BATCH] and err < 5e-3, (served, err)
    sent, got = runs[1]["pipeline_frames"]
    assert tap.sent == sent
    assert tap.got == got


def test_maybe_init_distributed(tmp_path):
    """Two processes join one group through maybe_init_distributed
    (HETPU_COORD, HETPU_NUM_PROCS, HETPU_PROC_ID) and reduce over it."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = _start(ranks.main_init, (f"127.0.0.1:{port}", str(tmp_path)), 2)
    _join(ctx, time.monotonic() + JOIN_S)
    for r in range(2):
        z = np.load(tmp_path / f"init_r{r}.npz")
        assert int(z["world"]) == 2
        np.testing.assert_array_equal(z["out"], np.full((4, 8), 81 % 97))


@pytest.mark.parametrize("world", [4])
def test_two_axis_mesh(runs, world):
    """A (2, 2) mesh: row-major coordinates, the ranks of each axis, a
    gather along one axis and a reduction along the other."""
    for rank, r in enumerate(_results(runs, world, "mesh2d")):
        a, b = divmod(rank, 2)
        np.testing.assert_array_equal(r["coords"], [a, b])
        np.testing.assert_array_equal(r["ranks_a"], [b, 2 + b])
        np.testing.assert_array_equal(r["ranks_b"], [2 * a, 2 * a + 1])
        np.testing.assert_array_equal(r["gather_b"], [2 * a, 2 * a + 1])
        np.testing.assert_array_equal(r["reduce_a"], [2 + 2 * b])


def test_single_rank_mesh():
    """Without a process group a mesh has one rank: every exchange is the
    rank's own copy (the plain twin on CPU tensors: no launch); bad
    permutations, devices other than the CPU and the card, words narrower
    than 32 bits and a non-power-of-two butterfly are refused; the default
    device is the card, which this host lacks."""
    cuda_lib.reset_launches()
    mesh = parallel.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.axis_ranks("dp")) == ({"dp": 1}, 0,
                                                              [0])
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert torch.equal(parallel.right_permute(x, mesh, "dp"), x)
    assert torch.equal(parallel.ppermute(x, mesh, "dp", []),
                       torch.zeros_like(x))
    assert torch.equal(parallel.all_to_all(x, mesh, "dp", 1, 0), x)
    assert torch.equal(parallel.all_gather(x, mesh, "dp", 1), x)
    q = torch.tensor(97, dtype=torch.int32)
    assert torch.equal(parallel.mod_all_reduce(x, q, mesh, "dp"), x)
    assert cuda_lib.launches["peer_permute"] == 0
    with pytest.raises(ValueError, match="no permutation"):
        parallel.ppermute(x, mesh, "dp", [(0, 1)])
    with pytest.raises(ValueError, match="unsupported device"):
        parallel.right_permute(x.to("meta"), mesh, "dp")
    with pytest.raises(TypeError, match="32-bit words"):
        parallel.right_permute(x.to(torch.int16), mesh, "dp")
    three = type("M", (), {"shape": {"r": 3}})()
    with pytest.raises(ValueError, match="power-of-two"):
        parallel.mod_all_reduce(x, q, three, "r")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            parallel.make_mesh()


@pytest.mark.parametrize("device,index", [("cuda", 3), ("cuda:1", 1)])
def test_mesh_names_its_card(monkeypatch, device, index):
    """A mesh on ``"cuda"`` (the default device of a Session) names the
    current card by its index, as the tensors made there do, so that its
    exchanges accept them; an explicit index stays."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    mesh = parallel.Mesh({"dp": 1}, device=device)
    assert mesh.device == torch.device("cuda", index)


def test_default_mesh_is_kept():
    """The sharded pipeline's calls without a mesh share one mesh an axis
    and device, so its exchange buffers are allocated once."""
    mesh = pipeline._default_mesh("dp", "cpu")
    assert (mesh.shape, mesh.device) == ({"dp": 1}, torch.device("cpu"))
    assert pipeline._default_mesh("dp", torch.device("cpu")) is mesh
    assert pipeline._default_mesh("cp", "cpu") is not mesh
