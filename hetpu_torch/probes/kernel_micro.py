"""Probe ``kernel_micro``: per-plane cost of the port's NTT kernel and its
plain modular ops.

Port of ``scripts/kernel_micro.py``: the same rows (``ntt_fwd``,
``ntt_fwd_mont``, ``ntt_inv``, ``ntt_inv`` strip, an inner-product-like
sum of Montgomery products at the key-switch shape, ``shoup_mul``,
``mont_mul``) on preset bench_n14 at B = 32, top level, through the
port's ``ntt`` kernel (K1) and :mod:`..core.modular`.  No kernel of its
own.  Each row is :func:`..utils.profiling.op_latency`: every call's input
is tagged with one bit of the previous call's output.
"""

from __future__ import annotations

import numpy as np

from ..core.modular import from_u32, mod_add, mont_constants, mont_mul, \
    shoup_mul
from ..core.ntt import ntt_fwd, ntt_fwd_mont, ntt_inv
from ..session import Session
from ..utils.profiling import op_latency
from . import device_of, header


def run(device="cuda", preset: str = "bench_n14", batch: int = 32,
        iters: int = 20, sess: Session | None = None) -> list[dict]:
    """Each row's ms per call and µs per plane.  ``sess``: a session of
    ``preset`` to reuse (its keys are not used)."""
    dev = device_of(device)
    print(header(dev), flush=True)
    if sess is None:
        sess = Session.create(preset, seed=b"\x21" * 32, galois_steps=[1],
                              device=dev)
    ctx = sess.ctx
    rng = np.random.default_rng(0)
    lvl = len(ctx.params.moduli) - 1
    tabs = ctx.tables(lvl)
    L, N = lvl + 1, ctx.params.poly_degree
    q = tabs.q
    mc = ctx.mont(lvl)
    x = from_u32(rng.integers(0, ctx.params.moduli[0], (batch, L, N),
                              dtype=np.uint32), dev)

    plan = ctx.keyswitch_plan(lvl)
    R, J = len(plan.basis_tables.primes), plan.num_digits
    r_inv = from_u32(mont_constants(plan.basis_tables.primes)["r_inv"], dev)
    y = from_u32(rng.integers(0, ctx.params.moduli[0], (batch, J, R, N),
                              dtype=np.uint32), dev)

    def ip(d):
        d = d % plan.q
        acc = None
        for j in range(J):
            prod = mont_mul(d[:, j, None], d[:, (j + 1) % J, None], plan.q,
                            r_inv)
            acc = prod if acc is None else mod_add(acc, prod, plan.q)
        return acc[:, 0]

    rows = [(f"ntt_fwd [B,{L},N]", lambda d: ntt_fwd(d % q, tabs), x,
             batch * L),
            (f"ntt_fwd_mont [B,{L},N]", lambda d: ntt_fwd_mont(d % q, tabs),
             x, batch * L),
            (f"ntt_inv [B,{L},N]", lambda d: ntt_inv(d % q, tabs), x,
             batch * L),
            (f"ntt_inv strip [B,{L},N]",
             lambda d: ntt_inv(d % q, tabs, strip_mont=True), x, batch * L),
            (f"inner-product-ish [B,{J}x2x{R},N]", ip, y,
             batch * J * 2 * R),
            (f"shoup_mul [B,{L},N]",
             lambda d: shoup_mul(d % q, tabs.r, tabs.r_shoup, q), x,
             batch * L),
            (f"mont_mul [B,{L},N]",
             lambda d: mont_mul(d % q, d % q, mc["q"], mc["r_inv"]), x,
             batch * L)]
    out = []
    for name, f, data, planes in rows:
        ms = op_latency(f, data, iters) * 1e3
        print(f"{name:40s} {ms:8.3f} ms/call  {ms / planes * 1e3:7.2f} "
              f"us/plane  ({planes} planes)", flush=True)
        out.append({"name": name, "ms": ms, "planes": planes})
    return out
