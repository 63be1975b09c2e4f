#!/usr/bin/env python3
"""Time the ``ntt`` (K1) and ``ntt_fwd_fbc`` (K3) kernels of hetpu_torch
trees side by side on one NVIDIA card.

    python kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout holding ``hetpu_torch/``; each is measured in a
process of its own (the trees share the package name), in the order
given: to compare two trees, give them as A B B A.  Per root, one JSON
line:

  * ``kernels``: K1 and K3 at the bench_n14 B=8 shapes of the main path
    (``chip_smoke.ntt_cases`` / ``fbc_cases``), each exact against its
    plain version, timed cold (one call replayed from a CUDA graph after an
    L2 flush, ``probes.cold_ms``) and eagerly (``chip_smoke.median_ms``);
  * ``host_us``: host µs per call of K1 at the rescale's INTT [8,2,1,N]
    and K3 at the tail (``chip_smoke.host_us``: calls enqueued back to
    back, host clock);
  * ``infer_step``: ``chip_smoke.profile_calls`` over 5 calls on B=8,
    default FBC: device µs per call of K1 and K3, all device time, device
    kernels per call; and ms per call over 20 calls (CUDA events);
  * ``multiply_relin_rescale_ms``: ms per call over 100 calls at B=8.

The cases, timers and profile reduction come from the ``chip_smoke.py``
beside this file; only the trees' public entry points are called, so any
two revisions of the port compare.  Needs a CUDA card; builds each tree's
kernels into its own ``build/``.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
N_DIAGS, WSEED = 8, 7


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
    from hetpu_torch.core import fused_ntt
    from hetpu_torch.core.context import Context
    from hetpu_torch.core.ntt import (ntt_fwd, ntt_fwd_plain, ntt_inv,
                                      ntt_inv_plain)
    from hetpu_torch.core.params import preset
    from hetpu_torch.offload import pipeline
    from hetpu_torch.session import Session

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    smoke = _smoke()
    B = smoke.B
    rng = np.random.default_rng(4)
    ctx = Context(preset("bench_n14"))

    calls = {}
    for name, (x, t, kw) in smoke.ntt_cases(rng, ctx).items():
        fn, plain = ((ntt_inv, ntt_inv_plain) if name.startswith("ntt_inv")
                     else (ntt_fwd, ntt_fwd_plain))
        calls[name] = (x, lambda fn=fn, x=x, t=t, kw=kw: fn(x, t, **kw),
                       lambda fn=plain, x=x, t=t, kw=kw: fn(x, t, **kw))
    for name, (u, fbc, dt) in smoke.fbc_cases(rng, ctx).items():
        calls[name] = (u, lambda u=u, fbc=fbc, dt=dt:
                       fused_ntt.ntt_fwd_fbc(u, fbc, dt),
                       lambda u=u, fbc=fbc, dt=dt:
                       fused_ntt.ntt_fwd_fbc_plain(u, fbc, dt))
    kernels = {}
    for name, (a, call, plain) in calls.items():
        if not torch.equal(call(), plain()):
            raise AssertionError(f"{root}: {name} differs from plain")
        kernels[name] = {"cold_ms": probes.cold_ms(call),
                         "ms": smoke.median_ms(call), "shape": list(a.shape)}
    host = {name: smoke.host_us(calls[name][1])
            for name in ("ntt_inv_rescale", "ntt_fwd_fbc")}

    sess = Session.create("bench_n14", seed=b"\x21" * 32,
                          galois_steps=list(range(1, N_DIAGS)))
    xs = rng.uniform(-1, 1, (B, sess.slots))
    ct = smoke.stack([sess.encrypt(v) for v in xs])
    diags, act = pipeline._infer_weights(sess.slots, N_DIAGS, WSEED)
    step = lambda: pipeline.infer_step(sess, ct, diags, act)
    prof = smoke.profile_calls(step)
    b = ct.with_(data=ct.data.flip(0).contiguous())
    mrr = lambda: sess.ev.multiply_relin_rescale(ct, b, sess.rk)
    mrr()
    torch.cuda.synchronize()
    return {"root": root, "kernels": kernels, "host_us": host, "infer_step": {
        "k1_us": prof["ours"].get("ntt", 0.0),
        "k3_us": prof["ours"].get("ntt_fwd_fbc", 0.0),
        "device_us": prof["device_us"], "device_kernels": prof["kernels"],
        "ms": probes.window_ms(lambda: [step() for _ in range(20)]) / 20},
        "multiply_relin_rescale_ms":
            probes.window_ms(lambda: [mrr() for _ in range(100)]) / 100}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(_child(str(Path(argv[1]).resolve()))), flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    for root in argv:
        subprocess.run([sys.executable, __file__, "--child", root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
