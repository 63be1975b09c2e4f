#!/usr/bin/env python3
"""Time the fused and NTT kernels, the key-switch inner product and the
probe kernels P1, P3 and P4 of hetpu_torch trees side by side on one
NVIDIA card.

    python kernel_ab.py ROOT [ROOT ...]
    python kernel_ab.py --parallel ROOT [ROOT ...]   # the parallel part only

Each ROOT is a checkout holding ``hetpu_torch/``; each is measured in a
process of its own (the trees share the package name), in the order
given: to compare two trees, give them as A B B A (ten pairs: A B B A
repeated five times).  Per root, one JSON line:

  * ``kernels``: at the bench_n14 B=8 shapes of the main path, each exact
    against its plain version, timed cold (one call replayed from a CUDA
    graph after an L2 flush, ``probes.cold_ms``) and eagerly
    (``chip_smoke.median_ms``): K1 ``ntt`` (``chip_smoke.ntt_cases``), K2
    ``ntt_fwd_lifted`` [8,9,N]→[8,19,N], K3 ``ntt_fwd_fbc``
    (``fbc_cases``), the centered conversions of the tail and the mod-down
    through ``evaluator._fbc_fwd_mont`` with their centered plans
    (``centered_cases``), and the centered decomposition
    ``Evaluator(ctx, centered_fbc=True)._decompose`` at [8,9,N] (row 0
    checked against the CPU evaluator); K4 ``inner_product`` at every path
    shape of PERF.md row 4 ([B, J, R, N]: bench_n14, bfv_batch,
    ckks_deep_hi, ckks_deep, ckks_fft x64, the sweep's level 26, ckks_hi
    x64, bfv_matpow x4; residues of 30-bit NTT primes); and the probe
    kernels P1 ``copy_planes`` (8a rb=8 one limb, 8b rb=8 flat at
    [32,9,128,128], 8c 1152 planes), P3 ``dot_i8`` (8e s8×s8
    [128,256]@[256,128], 8f s8 [512,512]@[512,128], 8g and 8h: 288 planes
    at 1 and 8 planes a block) and P4 ``plane_parts`` (8i: all six parts
    at [32,9,128,128]), each exact against its plain version;
  * ``host_us``: host µs per call of K1 at the rescale's INTT [8,2,1,N],
    K3 at the tail, the centered tail conversion, P1 at [8,1,128,128] and
    P3 at [512,512]@[1,512,128] (``chip_smoke.host_us``: calls enqueued
    back to back, host clock);
  * ``infer_step``, in both FBC modes (``default``, ``centered``):
    ``chip_smoke.profile_calls`` over 5 calls on B=8: device µs per call
    of each package kernel, all device time, device kernels per call; and
    ms per call over 20 calls (CUDA events);
  * ``multiply_relin_rescale_ms``: ms per call over 100 calls at B=8, in
    both modes;
  * ``parallel`` (a second line), at 2 and 4 ranks, each a process on
    cuda:0 (the ranks time-slice the card): P5 ``peer_permute`` at the
    snippet's [8,128] f32 (right shift) and the butterfly's [2,13,N]
    int32 (i xor 1), each equal to its gloo twin, as ms an exchange
    between two syncs (``latency_ms``, median of 20) and enqueued back to
    back (``back_to_back_ms``, 20 exchanges, one sync) under ``exchange``;
    for a tree whose wait is the host's, the exchange's five steps
    (``split_ms``: launch, stream sync, barrier, read-out, barrier); then chip_smoke.py's parallel path once (``path_s``) and, at 2 ranks,
    ``evaluate_sharded_infer`` at B=8 (``infer_sharded_s``: median, least
    and most of 5 calls).

K5 ``centered_fbc`` is timed with the kernels, at its four bench_n14 B=8
shapes (``chip_smoke.k5_cases``).  The cases, timers and profile
reduction come from the ``chip_smoke.py``
beside this file; only entry points that every revision of the port has
are called, so any two revisions compare.  Needs a CUDA card; builds each
tree's kernels into its own ``build/``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_DIAGS, WSEED = 8, 7
# K4's path shapes [B, J, R, N] (PERF.md row 4)
IP_SHAPES = {"bench_n14": (8, 2, 14, 1 << 14), "bfv_batch": (8, 4, 9, 1 << 14),
             "deep_hi": (1, 7, 29, 1 << 15), "deep": (1, 4, 20, 1 << 15),
             "fft64": (64, 4, 14, 1 << 14), "sweep26": (1, 27, 28, 1 << 15),
             "hi64": (64, 3, 8, 1 << 13), "matpow4": (4, 4, 9, 1 << 14)}


def _smoke():
    """This tree's chip_smoke.py as a module (a ROOT first on sys.path
    holds its own)."""
    spec = importlib.util.spec_from_file_location("chip_smoke_ab",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _child(root: str) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from hetpu_torch import probes
    from hetpu_torch.core import evaluator, fused_ntt, ip_kernel, nt
    from hetpu_torch.core.modular import from_u32, shoup_companion
    from hetpu_torch.core.context import Context
    from hetpu_torch.core.evaluator import Evaluator
    from hetpu_torch.core.ntt import (ntt_fwd, ntt_fwd_plain, ntt_inv,
                                      ntt_inv_plain)
    from hetpu_torch.core.params import preset
    from hetpu_torch.offload import pipeline
    from hetpu_torch.probes import copy as copy_probe
    from hetpu_torch.probes import dot, kernel_parts
    from hetpu_torch.session import Session

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    smoke = _smoke()
    B, LEVEL = smoke.B, smoke.LEVEL
    rng = np.random.default_rng(4)
    ctx = Context(preset("bench_n14"))
    ks = ctx.keyswitch_plan(LEVEL)

    calls = {}
    for name, (x, t, kw) in smoke.ntt_cases(rng, ctx).items():
        fn, plain = ((ntt_inv, ntt_inv_plain) if name.startswith("ntt_inv")
                     else (ntt_fwd, ntt_fwd_plain))
        calls[name] = (x, lambda fn=fn, x=x, t=t, kw=kw: fn(x, t, **kw),
                       lambda fn=plain, x=x, t=t, kw=kw: fn(x, t, **kw))
    x = calls["ntt_inv"][0]
    lift = (ks.lift_w, ks.lift_ws, ks.lift_dig, ks.foreign_cat_tables)
    calls["ntt_fwd_lifted"] = (x, lambda: fused_ntt.ntt_fwd_lifted(x, *lift),
                               lambda: fused_ntt.ntt_fwd_lifted_plain(x, *lift))
    for name, (u, fbc, dt) in smoke.fbc_cases(rng, ctx).items():
        calls[name] = (u, lambda u=u, fbc=fbc, dt=dt:
                       fused_ntt.ntt_fwd_fbc(u, fbc, dt),
                       lambda u=u, fbc=fbc, dt=dt:
                       fused_ntt.ntt_fwd_fbc_plain(u, fbc, dt))
    # the centered conversions through the evaluator's own step
    for name, (u, fbc, plan, dt) in smoke.centered_cases(rng, ctx).items():
        calls[name] = (u, lambda u=u, fbc=fbc, plan=plan, dt=dt:
                       evaluator._fbc_fwd_mont(u, fbc, dt, plan),
                       lambda u=u, plan=plan, dt=dt:
                       ntt_fwd_plain(plan.apply_plain(u), dt, to_mont=True))
    # the probe kernels P1 and P3 at the probes' shapes (PERF.md 8a-8h)
    xp = copy_probe.planes_u32((32, 9, 128, 128), device="cuda")
    x1152 = copy_probe.planes_u32((1152, 128, 128), device="cuda")
    for name, (xc, rb, flat) in {"copy_planes_8a": (xp, 8, False),
                                 "copy_planes_8b": (xp, 8, True),
                                 "copy_planes_8c": (x1152, 8, False)}.items():
        calls[name] = (xc, lambda xc=xc, rb=rb, flat=flat:
                       copy_probe.copy_planes(xc, rb, flat),
                       lambda xc=xc, rb=rb, flat=flat:
                       copy_probe.copy_planes_plain(xc, rb, flat))
    gen = np.random.default_rng(0)
    s8 = [torch.from_numpy(v).cuda()
          for v in dot.pair_inputs(np.int8, np.int8)]
    w512 = torch.from_numpy(gen.integers(-128, 128, (512, 512),
                                         dtype=np.int8)).cuda()
    x512 = torch.from_numpy(gen.integers(-128, 128, (1, 512, 128),
                                         dtype=np.int8)).cuda()
    w288, a288 = dot.int8_mxu_inputs(288, device="cuda")
    for name, (wa, xb, ppb) in {"dot_i8_8e": (s8[0], s8[1][None], 1),
                                "dot_i8_8f": (w512, x512, 1),
                                "dot_i8_8g": (w288, a288, 1),
                                "dot_i8_8h": (w288, a288, 8)}.items():
        calls[name] = (xb, lambda wa=wa, xb=xb, ppb=ppb:
                       dot.dot_i8(wa, xb, ppb),
                       lambda wa=wa, xb=xb: dot.dot_i8_plain(wa, xb))
    # K4 at the path shapes of PERF.md row 4
    for name, (b, j, r, n) in IP_SHAPES.items():
        primes = nt.gen_primes(30, r, 2 * n)
        q = from_u32(np.array(primes, dtype=np.uint64).reshape(r, 1), "cuda")
        ext = smoke.residues(rng, (b, j, r, n), primes)
        k = smoke.residues(rng, (j, 2, r, n), primes)
        k_sh = shoup_companion(k, q)
        calls["inner_product_" + name] = (
            ext, lambda ext=ext, k=k, k_sh=k_sh, q=q:
            ip_kernel.inner_product(ext, k, k_sh, q),
            lambda ext=ext, k=k, k_sh=k_sh, q=q:
            ip_kernel.inner_product_plain(ext, k, k_sh, q))
    # P4's six parts at the probe's shape (PERF.md 8i)
    parts = kernel_parts.make_inputs(device="cuda")
    for v in kernel_parts.VARIANTS:
        calls["plane_parts_" + v] = (
            parts[0], lambda v=v: kernel_parts.plane_parts(v, *parts),
            lambda v=v: kernel_parts.plane_parts_plain(v, *parts))
    # K5 centered_fbc at its four bench_n14 B=8 shapes (PERF.md row 7)
    for name, (plan, y) in smoke.k5_cases(rng, ctx).items():
        calls[name] = (y, lambda plan=plan, y=y: plan.apply(y),
                       lambda plan=plan, y=y: plan.apply_plain(y))
    kernels = {}
    for name, (a, call, plain) in calls.items():
        if not torch.equal(call(), plain()):
            raise AssertionError(f"{root}: {name} differs from plain")
        kernels[name] = {"cold_ms": probes.cold_ms(call),
                         "ms": smoke.median_ms(call), "shape": list(a.shape)}
    # the centered decomposition (INTT, the lift of both digits, the
    # direct rows), against the CPU evaluator on row 0
    ev_c = Evaluator(ctx, centered_fbc=True)
    d = smoke.residues(rng, (B, LEVEL + 1, ctx.params.poly_degree),
                       ctx.params.moduli[: LEVEL + 1])
    dec = lambda: ev_c._decompose(d, LEVEL)
    ev_cpu = Evaluator(Context(preset("bench_n14"), "cpu"), centered_fbc=True)
    if not torch.equal(dec()[:1].cpu(), ev_cpu._decompose(d[:1].cpu(), LEVEL)):
        raise AssertionError(f"{root}: centered _decompose differs from CPU")
    kernels["centered_decompose"] = {"cold_ms": probes.cold_ms(dec),
                                     "ms": smoke.median_ms(dec),
                                     "shape": list(d.shape)}
    host = {name: smoke.host_us(calls[name][1])
            for name in ("ntt_inv_rescale", "ntt_fwd_fbc",
                         "ntt_fwd_centered_tail")}
    # the probe wrappers at phase 18's host_cost shapes (a P3 call encodes
    # two tensor maps)
    xs = copy_probe.planes_u32((8, 1, 128, 128), device="cuda")
    w1, a1 = dot.int8_mxu_inputs(1, device="cuda")
    host["copy_planes"] = smoke.host_us(lambda: copy_probe.copy_planes(xs, 8))
    host["dot_i8"] = smoke.host_us(lambda: dot.dot_i8(w1, a1))

    sess = Session.create("bench_n14", seed=b"\x21" * 32,
                          galois_steps=list(range(1, N_DIAGS)))
    cent = Session.from_wire(sess.ctx.params, sess.rk, sess.gk,
                             centered_fbc=True)
    xs = rng.uniform(-1, 1, (B, sess.slots))
    ct = smoke.stack([sess.encrypt(v) for v in xs])
    diags, act = pipeline._infer_weights(sess.slots, N_DIAGS, WSEED)
    b = ct.with_(data=ct.data.flip(0).contiguous())
    infer, mrr = {}, {}
    for mode, s in (("default", sess), ("centered", cent)):
        step = lambda s=s: pipeline.infer_step(s, ct, diags, act)
        prof = smoke.profile_calls(step)
        infer[mode] = {f"{k}_us": prof["ours"].get(k, 0.0) for k in (
            "ntt", "ntt_fwd_lifted", "ntt_fwd_fbc", "ntt_fwd_centered",
            "centered_fbc", "inner_product")}
        infer[mode].update(
            device_us=prof["device_us"], device_kernels=prof["kernels"],
            ms=probes.window_ms(lambda: [step() for _ in range(20)]) / 20)
        op = lambda s=s: s.ev.multiply_relin_rescale(ct, b, sess.rk)
        op()
        torch.cuda.synchronize()
        mrr[mode] = probes.window_ms(lambda: [op() for _ in range(100)]) / 100
    return {"root": root, "kernels": kernels, "host_us": host,
            "infer_step": infer, "multiply_relin_rescale_ms": mrr}


# ----------------------------------------------------------------------
# the parallel part: P5 exchanges and the parallel path on 2 and 4 ranks
# ----------------------------------------------------------------------

PAR_WORLDS = (2, 4)
PAR_DIR = HERE / "build" / "kernel_ab_ranks"
PAR_TIMEOUT_S = 300
SPLIT = ("launch", "sync", "barrier1", "readout", "barrier2")


def _split_ms(peer, mesh, x, perm, runs: int) -> dict:
    """The steps of an exchange whose wait is the host's (the trees before
    the flag protocol: ``peer.store``, then a stream sync, a barrier, the
    read-out and a second barrier), each the median host ms of ``runs``
    exchanges between synchronised starts."""
    import statistics
    import time

    import torch
    ranks, i = mesh.axis_ranks("x"), mesh.axis_index("x")
    to = [d for s, d in perm if s == i]
    frm = [s for s, d in perm if d == i]
    segs = [(x, 0, ranks[to[0]], 0, x.nbytes)] if to else []
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(mesh.device)
    steps = {k: [] for k in SPLIT}
    for _ in range(runs):
        torch.cuda.synchronize()
        mesh.barrier()
        t = [time.perf_counter()]
        own = peer.store(mesh, segs, x.nbytes)
        t.append(time.perf_counter())
        stream.synchronize()
        t.append(time.perf_counter())
        mesh.barrier()
        t.append(time.perf_counter())
        if frm:
            peer.copy(out.data_ptr(), own, out.nbytes, mesh.device)
            stream.synchronize()
        t.append(time.perf_counter())
        mesh.barrier()
        t.append(time.perf_counter())
        for k, a, b in zip(SPLIT, t, t[1:]):
            steps[k].append(b - a)
    return {k: statistics.median(v) * 1e3 for k, v in steps.items()}


def _rank(root: str, world: int, rank: int, workdir: str) -> None:
    """One SPMD rank on cuda:0 of the tree at ``root``: the snippet's and
    the butterfly's exchange (each equal to its gloo twin) timed as a
    latency and back to back (the trees before the flag protocol also by
    step), then chip_smoke.py's parallel path once (``path_s``) and, at 2
    ranks, ``evaluate_sharded_infer`` over 5 calls.  Rank 0 writes the
    results."""
    sys.path.insert(0, root)
    import datetime

    import torch
    import torch.distributed as dist

    from hetpu_torch import parallel
    from hetpu_torch.offload import pipeline
    from hetpu_torch.parallel import peer
    from hetpu_torch.session import Session
    smoke = _smoke()
    work = Path(workdir)
    dist.init_process_group("gloo", init_method=f"file://{work}/store",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=PAR_TIMEOUT_S))
    try:
        torch.cuda.set_device(0)
        mesh = parallel.make_mesh((world,), ("x",))
        g = torch.Generator().manual_seed(rank)
        cases = {"snippet": (torch.randn(smoke.SNIPPET, generator=g),
                             [(i, (i + 1) % world) for i in range(world)]),
                 "butterfly": (torch.randint(0, 1 << 30, (2, 13, 1 << 14),
                                             generator=g, dtype=torch.int32),
                               [(i, i ^ 1) for i in range(world)])}
        runs = smoke.TIMED_RUNS
        res = {"world": world}
        for name, (x, perm) in cases.items():
            xc = x.to(mesh.device)
            want = parallel.ppermute(x, mesh, "x", perm)
            fn = lambda: parallel.ppermute(xc, mesh, "x", perm)
            if not torch.equal(fn().cpu(), want):
                raise AssertionError(f"{root}: {name} differs from its "
                                     "gloo twin")
            r = {"exchange": {
                "latency_ms": smoke.exchange_latency_ms(fn, mesh, runs),
                "back_to_back_ms": smoke.exchange_back_to_back_ms(
                    fn, mesh, runs)}}
            if not hasattr(peer, "protocol"):
                r["split_ms"] = _split_ms(peer, mesh, xc, perm, runs)
            res[name] = r
        sess = Session.create("bench_n14", seed=smoke.PAR_SEED,
                              galois_steps=smoke.PAR_STEPS)
        inp = smoke._par_inputs(sess)
        meshes = {a: parallel.make_mesh((world,), (a,))
                  for a in ("tp", "cp", "rot", "dp")}
        mesh.barrier()
        _, res["path_s"] = smoke.par_path(sess, inp, meshes, world)
        if world == 2:
            res["infer_sharded_s"] = smoke._seconds(
                lambda: pipeline.evaluate_sharded_infer(
                    sess, inp["inf"], smoke.WSEED, smoke.N_DIAGS,
                    meshes["dp"]), meshes["dp"])
        for m in (mesh, *meshes.values()):
            m.close()
        if rank == 0:
            (work / "result.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _parallel(root: str) -> dict:
    """The parallel part of ``root`` at 2 and 4 ranks, each rank a process
    of its own on cuda:0 (they time-slice the card)."""
    import shutil
    import time
    out = {}
    for world in PAR_WORLDS:
        work = PAR_DIR / f"w{world}"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", root,
                                   str(world), str(r), str(work)])
                 for r in range(world)]
        deadline = time.monotonic() + PAR_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        if any(p.returncode for p in procs):
            raise RuntimeError(f"{root}: a rank of {world} failed")
        out[world] = json.loads((work / "result.json").read_text())
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(_child(str(Path(argv[1]).resolve()))), flush=True)
        return 0
    if argv[:1] == ["--rank"]:
        _rank(argv[1], int(argv[2]), int(argv[3]), argv[4])
        return 0
    parallel_only = argv[:1] == ["--parallel"]
    roots = argv[1:] if parallel_only else argv
    if not roots:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for root in roots:
        if not parallel_only:
            subprocess.run([sys.executable, __file__, "--child", root],
                           check=True)
        root = str(Path(root).resolve())
        print(json.dumps({"root": root, "parallel": _parallel(root)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
