"""The key-switching ops' outputs on fixed inputs, bit for bit, across
revisions of hetpu_torch.

    python3 op_bits.py save ROOT OUT.npz [--device cuda] [--cases A,B]
    python3 op_bits.py compare A.npz B.npz

``save`` imports ``hetpu_torch`` from ROOT (this checkout, or another
revision unpacked beside it with ``git archive``), makes each case's keys
from a seed fixed by the case's name and its ciphertext arrays from
uniform residues of a numpy generator seeded the same way, runs the ops
that switch a key (CKKS: ``multiply_relin_rescale``,
``square_relin_rescale``, ``relinearize``, ``rotate``, ``rotate_hoisted``
by two steps; BFV: ``multiply_relin``) and saves each output's residues as
``<case>.<op>``.  ``compare`` prints ``bitcmp <n> arrays; differ: <names
or none>`` and exits 1 when an array differs or is on one side only.
Nothing is timed.  On a card the default cases take ~1 min a root; on the
CPU, ``--device cpu --cases dnum_b3,bfv_crt_b2`` takes seconds.
"""

from __future__ import annotations

import argparse
import hashlib
import sys
import zlib
from pathlib import Path

import numpy as np

# case → (preset, batch rows, centered_fbc, BFV)
CASES = {
    "n14_b8": ("bench_n14", 8, False, False),
    "n14_b4_centered": ("bench_n14", 4, True, False),
    "deep_hi_b2": ("ckks_deep_hi", 2, False, False),
    "dnum_b3": ("test_dnum", 3, False, False),
    "bfv_batch_b2": ("bfv_batch", 2, False, True),
    "bfv_crt_b2": ("test_bfv_crt", 2, False, True),
}
CARD_CASES = ("n14_b8", "n14_b4_centered", "deep_hi_b2", "dnum_b3",
              "bfv_batch_b2")


def _outputs(name: str, device: str) -> dict:
    """Case ``name``'s op outputs as host uint32 arrays, by op."""
    import torch

    from hetpu_torch.bfv import BfvSession
    from hetpu_torch.core.ciphertext import Ciphertext
    from hetpu_torch.core.modular import from_u32, to_u32
    from hetpu_torch.session import Session

    params, rows, centered, bfv = CASES[name]
    seed = hashlib.sha256(name.encode()).digest()
    if bfv:
        sess = BfvSession.create(params, seed=seed, galois_steps=[],
                                 device=device)
    else:
        sess = Session.create(params, seed=seed, galois_steps=[1, 2],
                              device=device, centered_fbc=centered)
    ctx = sess.ctx
    L, n = ctx.num_data, ctx.params.poly_degree
    q = np.array(ctx.params.moduli[:L], dtype=np.uint64).reshape(-1, 1)
    rng = np.random.default_rng(zlib.crc32(name.encode()))

    def ct(parts: int) -> Ciphertext:
        x = rng.integers(0, 1 << 62, (rows, parts, L, n), dtype=np.uint64)
        return Ciphertext(data=from_u32((x % q).astype(np.uint32), device),
                          level=L - 1, scale=ctx.params.scale)

    a, b, c3 = ct(2), ct(2), ct(3)
    if bfv:
        outs = {"multiply_relin": sess.multiply_relin(a, b)}
    else:
        ev, rk, gk = sess.ev, sess.rk, sess.gk
        h1, h2 = ev.rotate_hoisted(a, [1, 2], gk)
        outs = {"multiply_relin_rescale": ev.multiply_relin_rescale(a, b, rk),
                "square_relin_rescale": ev.square_relin_rescale(a, rk),
                "relinearize": ev.relinearize(c3, rk),
                "rotate": ev.rotate(a, 1, gk),
                "rotate_hoisted_1": h1, "rotate_hoisted_2": h2}
    if device != "cpu":
        torch.cuda.synchronize()
    return {op: to_u32(o.data) for op, o in outs.items()}


def save(root: str, out: str, device: str, cases) -> None:
    sys.path.insert(0, str(Path(root).resolve()))
    import hetpu_torch
    print(f"hetpu_torch from {Path(hetpu_torch.__file__).parent}",
          flush=True)
    arrays = {}
    for name in cases:
        for op, x in _outputs(name, device).items():
            arrays[f"{name}.{op}"] = x
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, **arrays)
    print(f"saved {out} {len(arrays)}", flush=True)


def compare(a: str, b: str) -> int:
    za, zb = np.load(a), np.load(b)
    names = sorted(set(za.files) | set(zb.files))
    differ = [k for k in names if k not in za.files or k not in zb.files
              or not np.array_equal(za[k], zb[k])]
    print(f"bitcmp {len(names)} arrays; differ: "
          f"{', '.join(differ) if differ else 'none'}", flush=True)
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("root")
    s.add_argument("out")
    s.add_argument("--device", default="cuda")
    s.add_argument("--cases", default=",".join(CARD_CASES))
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args(argv)
    if args.cmd == "compare":
        return compare(args.a, args.b)
    cases = args.cases.split(",")
    unknown = [k for k in cases if k not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}; known: {sorted(CASES)}")
    save(args.root, args.out, args.device, cases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
