"""Session: the user-facing bundle of context + keys + engines, on one
device.

Counterpart of ``hetpu/session.py`` (``Session.create``, ``from_wire``,
encode/encrypt/decrypt, the plaintext-constant cache, the level and scale
helpers, ``use_mesh`` and the ``mat_*`` protocol of the linalg layer).
``device`` chooses where the keys, tables and ciphertexts live: ``"cuda"``
(the default) runs the CUDA kernels, ``"cpu"`` their plain PyTorch
versions; both give the same bits.  ``centered_fbc=True`` routes the
key-switch base conversions through the centered FBC (the reference's
``HETPU_MXU_FBC=1``, see :mod:`.core.evaluator`).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .core.ciphertext import Ciphertext, Plaintext
from .core.context import Context
from .core.encoding import CkksEncoder
from .core.encrypt import Decryptor, Encryptor
from .core.evaluator import Evaluator
from .core.keys import GaloisKeys, KeyGenerator, RelinKeys
from .core.params import HeParams, preset
from .utils.profiling import phase


@dataclass
class Session:
    ctx: Context
    encoder: CkksEncoder
    ev: Evaluator
    rk: RelinKeys | None = None
    gk: GaloisKeys | None = None
    encryptor: Encryptor | None = None
    decryptor: Decryptor | None = None
    # (key, level, scale) → Plaintext on the session's device: constants
    # are encoded once and reused
    _pt_cache: dict = field(default_factory=dict, repr=False)
    # active mesh (use_mesh): the linalg matvec routes through
    # parallel.bucketed_matvec when set
    mesh: object = None
    mesh_axis: str = "rot"

    def use_mesh(self, mesh, axis: str = "rot") -> "Session":
        """Activate a :class:`..parallel.Mesh`: later ``BatchedMatrix``
        matvecs bucket their rotation loop over ``mesh[axis]``
        (``parallel.bucketed_matvec``); every rank of the mesh makes the
        same calls.  ``None`` deactivates.  Returns self."""
        self.mesh = mesh
        self.mesh_axis = axis
        return self

    # -- construction ---------------------------------------------------
    @classmethod
    def create(cls, params: HeParams | str, *, seed: bytes | None = None,
               galois_steps=None, with_secret: bool = True, device="cuda",
               centered_fbc: bool = False) -> "Session":
        """Keys in the reference's order (public, relin, galois), so a
        seed gives the reference's keys bit for bit."""
        if isinstance(params, str):
            with phase("context"):
                params = preset(params)
        ctx = Context(params, device)
        kg = KeyGenerator(ctx, seed=seed)
        pk = kg.create_public_key()
        rk = kg.create_relin_keys()
        gk = kg.create_galois_keys(galois_steps)
        return cls(
            ctx=ctx, encoder=CkksEncoder(ctx),
            ev=Evaluator(ctx, centered_fbc=centered_fbc), rk=rk, gk=gk,
            encryptor=Encryptor(ctx, public_key=pk, secret_key=kg.secret),
            decryptor=Decryptor(ctx, kg.secret) if with_secret else None,
        )

    @classmethod
    def from_wire(cls, params: HeParams, rk: RelinKeys | None = None,
                  gk: GaloisKeys | None = None, *, device="cuda",
                  centered_fbc: bool = False) -> "Session":
        """Evaluator-side session from received parameters and evaluation
        keys: no secret material, no encryptor or decryptor.  The keys
        move to ``device``."""
        ctx = Context(params, device)
        return cls(ctx=ctx, encoder=CkksEncoder(ctx),
                   ev=Evaluator(ctx, centered_fbc=centered_fbc),
                   rk=None if rk is None else rk.to(ctx.device),
                   gk=None if gk is None else gk.to(ctx.device))

    @property
    def slots(self) -> int:
        return self.encoder.slot_count

    # -- encode / encrypt / decrypt ------------------------------------
    def encode(self, values, level=None, scale=None) -> Plaintext:
        return self.encoder.encode(values, level, scale)

    def encrypt(self, values, level=None, scale=None,
                seed: bytes | None = None) -> Ciphertext:
        return self.encryptor.encrypt(self.encode(values, level, scale),
                                      seed=seed)

    def decrypt(self, ct: Ciphertext) -> np.ndarray:
        return self.decryptor.decrypt(ct)

    def const_like(self, ct: Ciphertext, values) -> Plaintext:
        """Encode at ct's exact level and scale (for exact additive
        alignment); scalar constants go through the plaintext cache."""
        if np.isscalar(values) or getattr(values, "ndim", 1) == 0:
            return self.cached_encode(("const", complex(values)), values,
                                      level=ct.level, scale=ct.scale)
        return self.encode(values, level=ct.level, scale=ct.scale)

    def cached_encode(self, key, values, level=None, scale=None) -> Plaintext:
        """Encode through the plaintext cache.  ``key`` identifies
        ``values`` (hashable); level and scale join the cache key after
        their defaults are resolved.  ``values`` may be a zero-argument
        callable, called only on a miss."""
        if level is None:
            level = self.ctx.num_data - 1
        if scale is None:
            scale = self.ctx.params.scale
        k = (key, level, float(scale))
        pt = self._pt_cache.get(k)
        if pt is None:
            v = values() if callable(values) else values
            pt = self._pt_cache[k] = self.encode(v, level=level, scale=scale)
        return pt

    # -- level / scale management ---------------------------------------
    def chain_index(self, ct: Ciphertext) -> int:
        return ct.level

    def drop_level(self, ct: Ciphertext) -> Ciphertext:
        """Burn one rescale level, keeping the scale exactly: multiply by 1
        encoded at scale q_level, then rescale."""
        g = self.ctx.params.rescale_group
        prod = 1.0
        for q in self.ctx.params.moduli[ct.level - g + 1: ct.level + 1]:
            prod *= q
        one = self.cached_encode(("const", 1.0 + 0j), 1.0,
                                 level=ct.level, scale=prod)
        return self.ev.rescale(self.ev.multiply_plain(ct, one))

    def reach_level(self, ct: Ciphertext, target: int) -> Ciphertext:
        while ct.level > target:
            ct = self.drop_level(ct)
        return ct

    def align(self, a: Ciphertext, b: Ciphertext):
        """Bring two ciphertexts to a common level for add/sub."""
        if a.level > b.level:
            a = self.reach_level(a, b.level)
        elif b.level > a.level:
            b = self.reach_level(b, a.level)
        return a, b

    # -- scheme protocol of the linalg layer (CKKS flavour) -------------
    def mat_multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.ev.multiply(a, b)

    def mat_reduce_finish(self, c3: Ciphertext) -> Ciphertext:
        """Finish an accumulated 3-part sum: relinearize + rescale."""
        return self.ev.rescale(self.ev.relinearize(c3, self.rk))

    def mat_mult_finish(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.ev.multiply_relin_rescale(a, b, self.rk)
