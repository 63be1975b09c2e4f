"""Closed-loop encrypted inference, one caller: each request uploads a
batch of activation ciphertexts from a host-resident pool (as a server
holds received requests), runs ``offload.pipeline.infer_step`` with the
seed's weights, and brings the result to the host.  The weights' plain
diagonals are encoded once, in the warm-up, through the session's cache.

On the card the pool and the result buffer are pinned host memory, as a
server that moves its requests by DMA keeps them: pageable copies went
through the driver's staging and made a request 1.5–1.9× slower and its
rate noisier (A/B on the card, PERF.md).  A kept answer gets a buffer of
its own, allocated in the warm-up.
"""

from __future__ import annotations

import torch

from hetpu_torch.offload.pipeline import infer_step

from ..reference.ckks import Answer


def galois_steps(p: dict) -> list:
    return list(range(1, p["diagonals"]))


class Driver:
    def __init__(self, sess, p: dict, inputs):
        self.sess = sess
        self.units = 1
        lo, hi = p["value_range"]
        d = p["diagonals"]
        self.diags = inputs.rng.uniform(-1.0, 1.0, (d, sess.slots)) / d
        self.act = tuple(p["act"])
        self.pinned = sess.ctx.device.type == "cuda"
        self.pool = []
        for _ in range(p["pool"]):
            x = inputs.rng.uniform(lo, hi, (p["batch"], sess.slots))
            ct = inputs.encrypt(sess, x)
            host = ct.data.cpu()
            if self.pinned:
                host = host.pin_memory()
            self.pool.append((x, ct.with_(data=host)))
        self.keep = set(inputs.sample(p["pool"], p["keep_within"]))
        self.min_calls = max(self.keep) + 1
        self.kept, self.last = {}, None
        self.device = sess.ctx.device
        self.bufs = {}

    def _request(self, b: int, span, i=None):
        _, host = self.pool[b]
        with span("upload"):
            ct = host.with_(data=host.data.to(self.device,
                                              non_blocking=self.pinned))
        with span("evaluate"):
            out = infer_step(self.sess, ct, self.diags, self.act)
        with span("download"):
            if not self.pinned:
                return out.with_(data=out.data.cpu())
            buf = self.bufs.get(i if i in self.keep else None)
            buf.copy_(out.data, non_blocking=True)
            torch.cuda.current_stream().synchronize()
            return out.with_(data=buf)

    def warm(self) -> None:
        """One request's work; on the card it also sizes the pinned result
        buffers: one shared, one a kept request."""
        _, host = self.pool[0]
        out = infer_step(self.sess, host.with_(data=host.data.to(self.device)),
                         self.diags, self.act)
        if self.pinned:
            for k in [None, *self.keep]:
                self.bufs[k] = torch.empty(out.data.shape, dtype=torch.int32,
                                           pin_memory=True)

    def call(self, i: int, span) -> None:
        out = self._request(i % len(self.pool), span, i)
        if i in self.keep:
            self.kept[i] = out
        self.last = (i, out)

    def answers(self) -> list:
        outs = dict(self.kept)
        outs.setdefault(*self.last)
        res = []
        for i in sorted(outs):
            x, _ = self.pool[i % len(self.pool)]
            out = outs[i]
            res.append(Answer(data=out.data,
                              scales=[out.scale] * out.data.shape[0],
                              inputs={"x": x, "diags": self.diags,
                                      "act": self.act},
                              slots=self.sess.slots))
        return res

    def checks(self) -> dict:
        return {}
