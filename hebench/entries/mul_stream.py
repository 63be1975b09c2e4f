"""A saturating stream of ``Evaluator.multiply_relin_rescale`` calls, each
on a batch of ciphertext pairs from a device-resident pool.

The host enqueues without waiting, as a server's batched evaluator
would.  Every output is folded (its first ``fold`` coefficients of every
limb, summed into one int64 tensor), so no call can be skipped; the
outputs of one sampled call a pool batch, and of the last call, are
kept for the comparison.
"""

from __future__ import annotations

import torch

from ..reference.ckks import Answer


def galois_steps(p: dict) -> list:
    return []


class Driver:
    """The stream; a subclass of another scheme's op gives its own
    ``draw``, ``op`` and ``plain``."""

    def __init__(self, sess, p: dict, inputs):
        self.ev, self.rk = sess.ev, sess.rk
        self.slots = sess.slots
        self.units = p["batch"]
        self.pool = []
        for _ in range(p["pool"]):
            x = self.draw(inputs.rng, p)
            y = self.draw(inputs.rng, p)
            self.pool.append((x, y, inputs.encrypt(sess, x),
                              inputs.encrypt(sess, y)))
        self.keep = set(inputs.sample(p["pool"], p["keep_within"]))
        self.min_calls = max(self.keep) + 1
        self.fold = p["fold"]
        self.kept, self.last = {}, None
        self.counts = [0] * p["pool"]
        self.acc = None

    def draw(self, rng, p: dict):
        """One batch of slot values."""
        lo, hi = p["value_range"]
        return rng.uniform(lo, hi, (p["batch"], self.slots))

    def op(self, a, b):
        return self.ev.multiply_relin_rescale(a, b, self.rk)

    def plain(self, x, y) -> dict:
        """The inputs of the plain math of one answer."""
        return {"x": x, "y": y}

    def warm(self) -> None:
        _, _, a, b = self.pool[0]
        out = self.op(a, b)
        self.acc = torch.zeros(out.data[..., : self.fold].shape,
                               dtype=torch.int64, device=out.data.device)

    def call(self, i: int, span) -> None:
        b = i % len(self.pool)
        _, _, ca, cb = self.pool[b]
        with span("evaluate"):
            out = self.op(ca, cb)
        with span("fold"):
            self.acc.add_(out.data[..., : self.fold])
        self.counts[b] += 1
        if i in self.keep:
            self.kept[i] = out
        self.last = (i, out)

    def answers(self) -> list:
        outs = dict(self.kept)
        outs.setdefault(*self.last)
        res = []
        for i in sorted(outs):
            x, y, _, _ = self.pool[i % len(self.pool)]
            out = outs[i]
            res.append(Answer(data=out.data.cpu(),
                              scales=[out.scale] * out.data.shape[0],
                              inputs=self.plain(x, y), slots=self.slots))
        return res

    def checks(self) -> dict:
        """Fold elements that differ from the kept outputs times their
        calls: every call of a pool batch must give its kept answer."""
        want = torch.zeros_like(self.acc)
        for i, out in self.kept.items():
            want += self.counts[i % len(self.pool)] * out.data[
                ..., : self.fold].to(torch.int64)
        return {"fold_mismatch": int((want != self.acc).sum())}
