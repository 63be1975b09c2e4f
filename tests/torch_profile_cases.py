"""The chains of the port's op-profiling programs at ``--small`` (B=2,
K=3, test_dnum), each program's encryptions under one fixed seed
sequence.  Shared by ``test_torch_profile.py`` (against hetpu) and the
card tests (card against CPU); imports neither JAX nor hetpu."""

from hetpu_torch.bench import (bench_sweep, op_parts_chain, probe_n15,
                               profile_fused, profile_hotpath, trace_op)
from torch_demo_cases import fixed_seeds

B, K = 2, 3
PROGRAMS = ("profile_fused", "profile_hotpath", "op_parts_chain",
            "bench_sweep", "trace_op", "probe_n15", "probe_n15b")


def port_chains(program: str, sess, modules) -> dict:
    """label → Chain of ``program`` on ``sess`` (probe_n15b's directly
    dispatched op under ``FULL fused op B=1``, a function), its
    encryptions drawn under ``fixed_seeds("profile", modules)``."""
    with fixed_seeds("profile", modules):
        if program in ("profile_fused", "profile_hotpath"):
            mod = {"profile_fused": profile_fused,
                   "profile_hotpath": profile_hotpath}[program]
            return dict(mod.chains(sess, B))
        if program == "op_parts_chain":
            return {k: c for k, c, _ in op_parts_chain.chains(sess, (B,))}
        if program == "bench_sweep":
            return {"B=2 K=3": bench_sweep.chain(
                sess, *bench_sweep.operands(sess), B)}
        if program == "trace_op":
            return {"step": trace_op.chain(sess, B)}
        if program == "probe_n15":
            return {k: c for k, c, _, _ in probe_n15.chains_n15(
                sess, K, K, (1, B))}
        op, items = probe_n15.n15b(sess, K)
        out = {k: c for k, c, _, _ in items}
        out["FULL fused op B=1"] = op
        return out
