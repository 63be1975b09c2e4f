"""The decomposition of K4 ``inner_product`` (``hetpu_torch/csrc/
ip_kernel.cu``), rebuilt on the host with the kernel's own constants: each
thread's (limb, x-quad, batch tile), the tile the wrapper chooses
(``ip_kernel.ip_tiles``), every output element written exactly once, and
the sums computed through that map (j ascending, a tile's rows at once)
against ``inner_product_plain`` and hetpu's ``inner_product_jnp``.  Exact,
on the CPU.  A change to the kernel's map is made here too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core import ip_kernel as ref_ip
from hetpu_torch.core import ip_kernel
from hetpu_torch.core.modular import from_u32, shoup_companion, to_u32

torch.set_num_threads(1)

# csrc/ip_kernel.cu: threads a block, one quad of 4 x each
THREADS = 128
PRIMES = (1073479681, 1072496641, 1071513601, 1070727169)


def thread_map(B: int, R: int, N: int):
    """For every (block, thread) of the launch: the quad index, the first
    batch row of its tile, its rows, and whether it runs (qi < R·N/4)."""
    bt, tiles, blocks = ip_kernel.ip_tiles(B, R, N)
    blk, t = np.meshgrid(np.arange(blocks), np.arange(THREADS),
                         indexing="ij")
    tile = blk % tiles
    qi = (blk // tiles) * THREADS + t
    b0 = tile * bt
    rows = np.minimum(bt, B - b0)
    return bt, qi.ravel(), b0.ravel(), rows.ravel(), \
        (qi < R * N // 4).ravel()


def written(B: int, R: int, N: int) -> np.ndarray:
    """How many times the launch writes each element of out [B, 2, R, N]."""
    bt, qi, b0, rows, live = thread_map(B, R, N)
    rn4 = R * N // 4
    idx = []
    for i in range(bt):
        ok = live & (i < rows)
        for c in range(2):
            base = ((b0[ok] + i) * 2 + c) * rn4 + qi[ok]
            idx.append((base[:, None] * 4 + np.arange(4)).ravel())
    idx = np.concatenate(idx)
    return np.bincount(idx, minlength=B * 2 * R * N)


def ip_tiled(ext: np.ndarray, k: np.ndarray, q: np.ndarray) -> np.ndarray:
    """out [B, 2, R, N] through the kernel's map: each live thread's tile
    accumulates its 2 x 4 sums per row over j ascending, modular adds from
    0, and stores them at its quad."""
    B, J, R, N = ext.shape
    bt, qi, b0, rows, live = thread_map(B, R, N)
    rn4 = R * N // 4
    e4 = ext.reshape(B, J, rn4, 4).astype(np.uint64)
    k4 = k.reshape(J, 2, rn4, 4).astype(np.uint64)
    out = np.full((B, 2, rn4, 4), 0xFFFFFFFF, dtype=np.uint64)
    qr = q.astype(np.uint64)[qi * 4 // N % R][:, None]
    for i in range(bt):
        ok = live & (i < rows)
        b, qq, qv = b0[ok] + i, qi[ok], qr[ok]
        acc = np.zeros((2, ok.sum(), 4), dtype=np.uint64)
        for j in range(J):
            for c in range(2):
                s = acc[c] + e4[b, j, qq] * k4[j, c, qq] % qv
                acc[c] = np.where(s >= qv, s - qv, s)
        out[b, 0, qq], out[b, 1, qq] = acc[0], acc[1]
    return out.reshape(B, 2, R, N).astype(np.uint32)


@pytest.mark.parametrize("B,R,N", [
    (64, 8, 1 << 15), (4, 9, 1 << 14), (8, 9, 1 << 14), (8, 14, 1 << 14),
    (1, 28, 1 << 15), (64, 14, 1 << 14), (1, 29, 1 << 15), (1, 20, 1 << 15),
    (3, 9, 1 << 14), (1, 1, 1 << 10), (5, 3, 1 << 12), (2, 2, 4096)])
def test_tiles_follow_the_rule(B, R, N):
    """The widest tile (4, 2, 1 rows, at most B) whose launch keeps
    IP_MIN_THREADS threads; the blocks cover every quad of every tile."""
    bt, tiles, blocks = ip_kernel.ip_tiles(B, R, N)
    quads = R * N // 4
    assert bt in ip_kernel.IP_TILE_ROWS and (bt <= B or bt == 1)
    assert tiles == -(-B // bt) and blocks * THREADS >= quads * tiles
    wider = [w for w in ip_kernel.IP_TILE_ROWS if bt < w <= B]
    assert all(quads * -(-B // w) < ip_kernel.IP_MIN_THREADS for w in wider)
    if bt > 1:
        assert quads * tiles >= ip_kernel.IP_MIN_THREADS


@pytest.mark.parametrize("min_threads", [None, 1])
@pytest.mark.parametrize("B", [1, 2, 3, 5, 7, 8, 9, 13, 64, 67])
@pytest.mark.parametrize("R,N", [(1, 16), (3, 64), (14, 1 << 10),
                                 (1, 1 << 14)])
def test_every_output_written_once(B, R, N, min_threads, monkeypatch):
    """Ragged B, partial last blocks; with IP_MIN_THREADS lowered every
    tile width (4, 2, 1) is taken."""
    if min_threads:
        monkeypatch.setattr(ip_kernel, "IP_MIN_THREADS", min_threads)
    assert (written(B, R, N) == 1).all()


@pytest.mark.parametrize("B,J,R,N", [
    (1, 1, 1, 64), (3, 2, 2, 128), (8, 7, 3, 64), (5, 27, 2, 32),
    (64, 3, 2, 16), (9, 4, 4, 128), (2, 27, 1, 1024)])
def test_tiled_sums_match_plain_and_hetpu(B, J, R, N, monkeypatch):
    """Sums through the kernel's map equal the plain version and hetpu's
    jnp inner product; ragged tiles and J = 1..27.  IP_MIN_THREADS is
    lowered so these small shapes take every tile width."""
    monkeypatch.setattr(ip_kernel, "IP_MIN_THREADS", 1)
    rng = np.random.default_rng(B * 1000 + J)
    q = np.resize(np.array(PRIMES, dtype=np.uint64), R)
    ext = (rng.integers(0, 1 << 62, (B, J, R, N), dtype=np.uint64)
           % q[:, None]).astype(np.uint32)
    k = (rng.integers(0, 1 << 62, (J, 2, R, N), dtype=np.uint64)
         % q[:, None]).astype(np.uint32)
    qcol = from_u32(q.reshape(R, 1))
    kt = from_u32(k)
    kst = shoup_companion(kt, qcol)
    got = ip_tiled(ext, k, q.astype(np.uint32))
    plain = to_u32(ip_kernel.inner_product_plain(from_u32(ext), kt, kst,
                                                 qcol))
    want = np.asarray(ref_ip.inner_product_jnp(
        jnp.asarray(ext), jnp.asarray(k), jnp.asarray(to_u32(kst)),
        jnp.asarray(q.astype(np.uint32).reshape(R, 1))))
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(got, want)
