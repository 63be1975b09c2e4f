"""Versioned binary wire format for params / keys / ciphertexts.

Counterpart of ``hetpu/core/serial.py``, byte for byte: a blob dumped by
either package loads in the other to the same residues, so a ``hetpu``
client can talk to a ``hetpu_torch`` server.  Replaces SEAL's stream
``save``/``load`` and doubles as the checkpoint format.

Format: little-endian.  Every blob = MAGIC(5s="HETPU") ver(u8) tag(u8)
header-json-len(u32) header-json payload-bytes.  The JSON header carries
shapes/levels/scales; the payload is raw uint32 limb data.  Symmetric
ciphertexts serialize as (c0, seed) — half size; the receiver re-expands
`a` from the seed (``random.uniform_rns(seed, 101, ...)``).  Loaders put
tensors on the context's device, or on ``device`` (the card unless
``device="cpu"``) where they take no context.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from . import random as rnd
from .ciphertext import Ciphertext, Plaintext
from .context import Context
from .keys import GaloisKeys, KSwitchKey, PublicKey, RelinKeys
from .modular import from_u32, shoup_precompute, to_u32
from .params import HeParams, Scheme

MAGIC = b"HETPU"
VERSION = 2    # v2: key-switch keys carry Shoup companions (recomputed at
               # load from the header's public prime list — wire size is
               # unchanged; v1 blobs are rejected)

TAG_PARAMS = 1
TAG_CIPHERTEXT = 2
TAG_SEEDED_CT = 3
TAG_RELIN = 4
TAG_GALOIS = 5
TAG_PUBLIC = 6
TAG_PLAINTEXT = 7


def _pack(tag: int, header: dict, payload: bytes = b"") -> bytes:
    hj = json.dumps(header).encode()
    return MAGIC + struct.pack("<BBI", VERSION, tag, len(hj)) + hj + payload


def _unpack(blob: bytes):
    if blob[:5] != MAGIC:
        raise ValueError("bad magic")
    ver, tag, hlen = struct.unpack_from("<BBI", blob, 5)
    if ver != VERSION:
        raise ValueError(f"unsupported version {ver}")
    off = 11
    header = json.loads(blob[off: off + hlen].decode())
    return tag, header, blob[off + hlen:]


def _u32_bytes(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr, dtype="<u4").tobytes()


def _u32_from(b: bytes, shape) -> np.ndarray:
    return np.frombuffer(b, dtype="<u4").reshape(shape).astype(np.uint32)


# ----------------------------------------------------------------------
# params
# ----------------------------------------------------------------------

def dump_params(p: HeParams) -> bytes:
    return _pack(TAG_PARAMS, {
        "scheme": p.scheme.value, "n": p.poly_degree,
        "moduli": list(p.moduli), "special": list(p.special_moduli),
        "scale": p.scale, "t": p.plain_modulus, "sec": p.sec_level,
    })


def load_params(blob: bytes) -> HeParams:
    tag, h, _ = _unpack(blob)
    if tag != TAG_PARAMS:
        raise ValueError("not a params blob")
    return HeParams(scheme=Scheme(h["scheme"]), poly_degree=h["n"],
                    moduli=tuple(h["moduli"]), special_moduli=tuple(h["special"]),
                    scale=h["scale"], plain_modulus=h["t"], sec_level=h["sec"])


# ----------------------------------------------------------------------
# ciphertexts / plaintexts
# ----------------------------------------------------------------------

def dump_ciphertext(ct: Ciphertext, seed: bytes | None = None) -> bytes:
    """With `seed` (symmetric ct whose part-1 was expanded from it): send
    only c0 + the seed — the compact form."""
    d = to_u32(ct.data)
    if seed is not None:
        if ct.num_parts != 2:
            raise ValueError("seeded form is for 2-part ciphertexts")
        return _pack(TAG_SEEDED_CT,
                     {"shape": list(d[..., 0, :, :].shape), "level": ct.level,
                      "scale": ct.scale, "seed": seed.hex()},
                     _u32_bytes(d[..., 0, :, :]))
    return _pack(TAG_CIPHERTEXT,
                 {"shape": list(d.shape), "level": ct.level, "scale": ct.scale},
                 _u32_bytes(d))


def load_ciphertext(blob: bytes, ctx: Context) -> Ciphertext:
    tag, h, payload = _unpack(blob)
    if tag == TAG_CIPHERTEXT:
        d = _u32_from(payload, h["shape"])
        return Ciphertext(data=from_u32(d, ctx.device), level=h["level"],
                          scale=h["scale"])
    if tag == TAG_SEEDED_CT:
        c0 = _u32_from(payload, h["shape"])
        seed = bytes.fromhex(h["seed"])
        lvl = h["level"]
        q = np.array(ctx.params.moduli[: lvl + 1],
                     dtype=np.uint32).reshape(-1, 1)
        a = rnd.uniform_rns(seed, 101, q, ctx.params.poly_degree)
        d = np.stack([c0, a], axis=-3) if c0.ndim > 2 else np.stack([c0, a])
        return Ciphertext(data=from_u32(d, ctx.device), level=lvl,
                          scale=h["scale"])
    raise ValueError(f"not a ciphertext blob (tag {tag})")


def dump_plaintext(pt: Plaintext) -> bytes:
    d = to_u32(pt.data)
    return _pack(TAG_PLAINTEXT,
                 {"shape": list(d.shape), "level": pt.level, "scale": pt.scale},
                 _u32_bytes(d) + _u32_bytes(to_u32(pt.shoup)))


def load_plaintext(blob: bytes, device="cuda") -> Plaintext:
    tag, h, payload = _unpack(blob)
    if tag != TAG_PLAINTEXT:
        raise ValueError("not a plaintext blob")
    half = len(payload) // 2
    return Plaintext(
        data=from_u32(_u32_from(payload[:half], h["shape"]), device),
        shoup=from_u32(_u32_from(payload[half:], h["shape"]), device),
        level=h["level"], scale=h["scale"])


# ----------------------------------------------------------------------
# keys
# ----------------------------------------------------------------------

def dump_public_key(pk: PublicKey) -> bytes:
    d = to_u32(pk.data)
    return _pack(TAG_PUBLIC, {"shape": list(d.shape)}, _u32_bytes(d))


def load_public_key(blob: bytes, device="cuda") -> PublicKey:
    tag, h, payload = _unpack(blob)
    if tag != TAG_PUBLIC:
        raise ValueError("not a public-key blob")
    return PublicKey(data=from_u32(_u32_from(payload, h["shape"]), device))


def _ksk_from_wire(d: np.ndarray, primes, device) -> KSwitchKey:
    """Rebuild a Shoup-form KSwitchKey from wire data [J, 2, L, N]: the
    companion ⌊d·2^32/q⌋ is a function of (d, primes), so only the values
    travel."""
    q = np.array(primes, dtype=np.uint32).reshape(1, 1, -1, 1)
    return KSwitchKey(data=from_u32(d, device),
                      shoup=from_u32(shoup_precompute(d, q), device))


def dump_relin_keys(rk: RelinKeys) -> bytes:
    ds = [to_u32(k.data) for k in (rk.key, *rk.more)]
    return _pack(TAG_RELIN, {"shape": list(ds[0].shape), "count": len(ds)},
                 b"".join(_u32_bytes(d) for d in ds))


def load_relin_keys(blob: bytes, ctx: Context) -> RelinKeys:
    tag, h, payload = _unpack(blob)
    if tag != TAG_RELIN:
        raise ValueError("not a relin-keys blob")
    shape = h["shape"]
    count = h.get("count", 1)            # pre-count blobs: single s² key
    per = int(np.prod(shape)) * 4
    keys = [_ksk_from_wire(_u32_from(payload[i * per:(i + 1) * per], shape),
                           ctx.all_primes, ctx.device) for i in range(count)]
    return RelinKeys(key=keys[0], more=tuple(keys[1:]))


def dump_galois_keys(gk: GaloisKeys) -> bytes:
    ds = [to_u32(k.data) for k in gk.keys]
    header = {"elts": list(gk.elts),
              "shape": list(ds[0].shape) if ds else []}
    return _pack(TAG_GALOIS, header, b"".join(_u32_bytes(d) for d in ds))


def load_galois_keys(blob: bytes, ctx: Context) -> GaloisKeys:
    tag, h, payload = _unpack(blob)
    if tag != TAG_GALOIS:
        raise ValueError("not a galois-keys blob")
    shape = h["shape"]
    per = int(np.prod(shape)) * 4 if shape else 0
    keys = [_ksk_from_wire(_u32_from(payload[i * per:(i + 1) * per], shape),
                           ctx.all_primes, ctx.device)
            for i, _ in enumerate(h["elts"])]
    return GaloisKeys(elts=tuple(h["elts"]), keys=tuple(keys))
