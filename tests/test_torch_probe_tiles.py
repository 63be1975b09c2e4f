"""The decompositions of the probe kernels P1 ``copy_planes``, P3
``dot_i8`` and P4 ``plane_parts`` (``hetpu_torch/csrc/probes.cu``,
``csrc/dot_i8.cu``, ``csrc/plane_parts.cu``), rebuilt on the host here
with the kernels' own constants: the bulk copies of every P1 block, P3's
persistent tile walk, the swizzled shared-memory layouts its transposer,
its wgmma descriptors and its epilogue use; P4's cluster walk over (limb,
plane) items, each rank's slab of w, the x8ᵀ and g8ᵀ tiles the ranks fill
through distributed shared memory; and products computed through them,
against the plain versions and ``jax.lax.dot_general`` (the probe scripts'
product).  Exact, on the CPU.  A change to a kernel's constants or layouts
is made here too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu_torch.probes import copy as copy_probe
from hetpu_torch.probes import dot, kernel_parts

torch.set_num_threads(1)

H100_SMS = 132

# csrc/probes.cu: bytes of a ring stage, a lone block's stages
STAGE_BYTES, MAX_STAGES_COPY = 32768, 6

# csrc/dot_i8.cu: k bytes a chunk (one 128-byte swizzle row), a ring stage
# Bᵀ [128 n][128 k], an A box [64 m][128 k], an output box [64 m][32 n]
# int32, the dynamic shared memory a block may take, the ring's most stages
K_CHUNK, CHUNK, A_BOX, O_BOX = 128, 128 * 128, 64 * 128, 64 * 32 * 4
DYN_SMEM, MAX_STAGES = 232448 - 1024, 8


# ----------------------------------------------------------------------
# P1's decomposition on the host
# ----------------------------------------------------------------------

def copy_plan(R: int, L: int, E: int, rows_per_block: int,
              all_limbs: bool = False) -> list[list[list[tuple]]]:
    """The kernel's bulk copies: for each block, its fills in order, each
    a list of (byte offset in x and in out, byte offset in the stage,
    bytes).  A block's bytes are ``rows_per_block`` runs of its limbs'
    planes, one run when the planes are contiguous (all limbs, or L = 1),
    cut into 32 KB fills and each fill at run ends."""
    plane, rb = 4 * E, rows_per_block
    lb = L if all_limbs else 1
    lblocks = L // lb
    run, runs = lb * plane, rb
    if lb == L:
        run, runs = run * rb, 1
    total = run * runs
    fills = -(-total // STAGE_BYTES)
    plan = []
    for blk in range(R // rb * lblocks):
        base = ((blk // lblocks) * rb * L + blk % lblocks * lb) * plane
        block = []
        for f in range(fills):
            c, end = f * STAGE_BYTES, min((f + 1) * STAGE_BYTES, total)
            copies = []
            while c < end:
                i, off = divmod(c, run)
                n = min(run - off, end - c)
                copies.append((base + i * L * plane + off,
                               c - f * STAGE_BYTES, n))
                c += n
            block.append(copies)
        plan.append(block)
    return plan


def ring_stages(blocks: int, fills: int, sms: int = H100_SMS) -> int:
    """Stages of each block's ring (``copy_stages`` in csrc/probes.cu):
    192 KB an SM shared by the blocks that land on it, 2 to 6 stages, and
    no more than the block's fills."""
    per_sm = -(-blocks // sms)
    s = min(max(MAX_STAGES_COPY * STAGE_BYTES // (per_sm * STAGE_BYTES), 2),
            MAX_STAGES_COPY)
    return min(fills, s)


def copy_planes_tiled(x: torch.Tensor, rows_per_block: int = 8,
                      all_limbs: bool = False) -> torch.Tensor:
    """The copy through :func:`copy_plan`: each fill loaded into a stage
    buffer and stored from it, block after block."""
    R, limbs = x.shape[0], (x.shape[1] if x.dim() == 4 else 1)
    E = x.shape[-2] * x.shape[-1]
    src = x.view(torch.uint8).reshape(-1)
    dst = torch.empty_like(src)
    stage = torch.empty(STAGE_BYTES, dtype=torch.uint8)
    for block in copy_plan(R, limbs, E, rows_per_block, all_limbs):
        for copies in block:
            for g, s, n in copies:
                stage[s:s + n] = src[g:g + n]
            for g, s, n in copies:
                dst[g:g + n] = stage[s:s + n]
    return dst.view(torch.int32).reshape(x.shape)


# ----------------------------------------------------------------------
# P3's decomposition on the host
# ----------------------------------------------------------------------

def slab_rows(M: int, K: int) -> int:
    """Rows of A a tile: two consumer warpgroups of one (or, where A's
    slab of 256 rows fits beside the ring, two) m64 accumulators."""
    return 256 if K <= 512 and M >= 256 else 128


def dot_stages(M: int, K: int) -> int:
    """Ring stages: what shared memory leaves beside the slab of A, the two
    consumers' staging tiles (four output boxes each) and 1 KB of
    alignment, at most :data:`MAX_STAGES`."""
    fixed = 1024 + slab_rows(M, K) // 64 * -(-K // K_CHUNK) * A_BOX \
        + 2 * 4 * O_BOX
    return min(MAX_STAGES, (DYN_SMEM - fixed) // CHUNK)


def dot_tiles(M: int, K: int, batch: int, planes_per_block: int,
              sms: int = H100_SMS) -> list[list[tuple[int, int, int]]]:
    """The persistent walk: min(tiles, sms) blocks, block b taking tiles
    [tiles·b/grid, tiles·(b+1)/grid) of the slab-major order, each tile
    (slab, first plane, end plane)."""
    groups = -(-batch // planes_per_block)
    tiles = -(-M // slab_rows(M, K)) * groups
    grid = min(tiles, sms)
    return [[(t // groups, t % groups * planes_per_block,
              min(batch, (t % groups + 1) * planes_per_block))
             for t in range(tiles * b // grid, tiles * (b + 1) // grid)]
            for b in range(grid)]


def swizzle128(offset):
    """The 128-byte swizzle of a byte offset from a 1024-byte-aligned
    base: its 16-byte unit XOR its row (of 128 bytes) mod 8."""
    return offset ^ (((offset >> 7) & 7) << 4)


def _byte_perm(x, y, sel: int):
    """``__byte_perm(x, y, sel)`` on uint32 arrays (selectors below 8)."""
    v = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(np.shape(x), np.uint64)
    for i in range(4):
        b = (v >> np.uint64(8 * ((sel >> (4 * i)) & 7))) & np.uint64(255)
        out |= b << np.uint64(8 * i)
    return out.astype(np.uint32)


def _transpose4x4(r0, r1, r2, r3):
    t0, t1 = _byte_perm(r0, r1, 0x5140), _byte_perm(r0, r1, 0x7362)
    t2, t3 = _byte_perm(r2, r3, 0x5140), _byte_perm(r2, r3, 0x7362)
    return (_byte_perm(t0, t2, 0x5410), _byte_perm(t0, t2, 0x7632),
            _byte_perm(t1, t3, 0x5410), _byte_perm(t1, t3, 0x7632))


def transpose_chunk(rows: np.ndarray, stage: np.ndarray) -> None:
    """The producer's ``transpose_chunk`` on the host: ``rows`` [kv, 128]
    bytes of a plane (kv a multiple of 32) into ``stage`` (16384 bytes) as
    Bᵀ, thread pt taking k rows 16·(pt % 8).. and columns 8·(pt // 8)..
    as uint2 words, four 4×4 byte transposes a half, one 16-byte unit a
    column at unit (pt % 8) ^ (n % 8)."""
    kv = rows.shape[0]
    words = np.zeros((128, 32), np.uint32)       # uint32 words of each row
    words[:kv] = np.ascontiguousarray(rows).view(np.uint32)
    st = stage.view(np.uint32)
    pt = np.arange(128)
    pt = pt[16 * (pt & 7) < kv]                  # threads with rows to move
    kb, nb = pt & 7, pt >> 3
    r = 16 * kb[:, None] + np.arange(16)[None, :]
    for h in range(2):
        v = words[r, (2 * nb + h)[:, None]]      # [threads, 16 rows]
        c = [_transpose4x4(*v[:, 4 * q:4 * q + 4].T) for q in range(4)]
        for j in range(4):
            n = 8 * nb + 4 * h + j
            at = (n * K_CHUNK + ((kb ^ (n & 7)) << 4)) // 4
            for q in range(4):
                st[at + q] = c[q][j]


def bt_chunk_map() -> np.ndarray:
    """[128 k, 128 n] → byte of the stage where :func:`transpose_chunk`
    puts B[k, n] (-1 where none does), found by transposing bytes that name
    their own (k, n)."""
    idx = np.arange(CHUNK, dtype=np.int64).reshape(128, 128)
    named = np.zeros(CHUNK, np.int64)          # stage byte → k·128 + n
    for byte in range(2):
        stage = np.zeros(CHUNK, np.uint8)
        transpose_chunk(((idx >> (8 * byte)) & 255).astype(np.uint8), stage)
        named += stage.astype(np.int64) << (8 * byte)
    where = np.full(CHUNK, -1, np.int64)
    where[named] = np.arange(CHUNK)
    return where.reshape(128, 128)


def operand(smem: np.ndarray, start: int, rows: int) -> np.ndarray:
    """The [rows, 32] bytes a K-major 128-byte-swizzle descriptor at
    ``start`` (a 1024-byte-aligned tile plus 32·kk) gives one wgmma:
    row r at (r // 8)·1024 + (r % 8)·128, swizzled as addressed."""
    r = np.arange(rows)[:, None]
    j = np.arange(32)[None, :]
    return smem[swizzle128(start + r // 8 * 1024 + r % 8 * 128 + j)]


def fragment_rows_cols():
    """Thread lt (0..127) and accumulator d[i] (0..63) of an m64n128 s32
    wgmma → (row, column): warp w, lane 4g + t; d[4j + e] at row 16w + g
    (+ 8 for e ≥ 2), column 8j + 2t + e % 2."""
    lt = np.arange(128)[:, None]
    i = np.arange(64)[None, :]
    w, g, t = lt >> 5, (lt & 31) >> 2, lt & 3
    j, e = i >> 2, i & 3
    return 16 * w + g + 8 * (e >> 1), 8 * j + 2 * t + (e & 1)


def stage_offsets(threads: int = 128, box: int = O_BOX) -> np.ndarray:
    """Thread lt, accumulator i → byte of the staging tile where
    ``stage_box`` writes it: box j // 4 of four [rows][32] int32 boxes
    ``box`` bytes apart, 16-byte unit u = 2·(j % 4) + t // 2 of its row at
    u ^ (row % 8)."""
    lt = np.arange(threads)[:, None]
    i = np.arange(64)[None, :]
    w, g, t = lt >> 5, (lt & 31) >> 2, lt & 3
    j, e = i >> 2, i & 3
    r = 16 * w + g + 8 * (e >> 1)
    u = 2 * (j & 3) + (t >> 1)
    return (j >> 2) * box + r * 128 + ((u ^ g) << 4) + ((t & 1) << 3) \
        + 4 * (e & 1)


def dot_i8_tiled(a: torch.Tensor, b: torch.Tensor, planes_per_block: int = 1,
                 sms: int = H100_SMS) -> torch.Tensor:
    """out[p] = a @ b[p] through the kernel's decomposition: the tile walk,
    the slab of A as TMA lays it (boxes [64][128], 128-byte swizzle, zero
    past M and K), each 128-row chunk of a plane through
    :func:`transpose_chunk` into a ring of :func:`dot_stages` stages that
    keep what earlier chunks left there, all four wgmma k32 steps of a
    chunk read through :func:`operand` (past K, A's zeros cancel what the
    stage holds), each m64 accumulator through the fragment layout and the
    swizzled staging tile into out (rows past M clipped)."""
    (M, K), batch = a.shape, b.shape[0]
    A = a.contiguous().view(torch.uint8).numpy()
    B = b.contiguous().view(torch.uint8).numpy()
    sa = np.int8 if a.dtype == torch.int8 else np.uint8
    sb = np.int8 if b.dtype == torch.int8 else np.uint8
    mt, nkc = slab_rows(M, K), -(-K // K_CHUNK)
    stages = dot_stages(M, K)
    rows, cols = fragment_rows_cols()
    offs = stage_offsets() // 4
    out = np.zeros((batch, M, dot.N_COLS), np.int32)
    rng = np.random.default_rng(0)
    for tiles in dot_tiles(M, K, batch, planes_per_block, sms):
        # a block's ring starts with whatever shared memory held
        ring = rng.integers(0, 256, (stages, CHUNK), dtype=np.uint8)
        it, slab = 0, -1
        for s, p0, p1 in tiles:
            if s != slab:                              # the TMA load of A
                slab = s
                padded = np.zeros((s * mt + mt, nkc * K_CHUNK), np.uint8)
                lo = min(M, s * mt + mt)
                padded[s * mt:lo, :K] = A[s * mt:lo]
                As = np.zeros(mt // 64 * nkc * A_BOX, np.uint8)
                box = np.arange(A_BOX)
                for si in range(mt // 64):
                    for c in range(nkc):
                        tile = padded[s * mt + si * 64:s * mt + si * 64 + 64,
                                      c * K_CHUNK:(c + 1) * K_CHUNK]
                        As[(si * nkc + c) * A_BOX + swizzle128(box)] = \
                            tile.reshape(-1)
            for p in range(p0, p1):
                acc = np.zeros((mt // 64, 64, dot.N_COLS), np.int64)
                for c in range(nkc):
                    stage = ring[it % stages]
                    it += 1
                    kv = min(K_CHUNK, K - c * K_CHUNK)
                    transpose_chunk(B[p, c * K_CHUNK:c * K_CHUNK + kv], stage)
                    for kk in range(K_CHUNK // 32):
                        bop = operand(stage, 32 * kk, dot.N_COLS).view(sb)
                        for si in range(mt // 64):
                            aop = operand(As, (si * nkc + c) * A_BOX
                                          + 32 * kk, 64).view(sa)
                            acc[si] += aop.astype(np.int64) \
                                @ bop.astype(np.int64).T
                for si in range(mt // 64):
                    row = s * mt + si * 64
                    if row >= M:
                        continue
                    staging = np.zeros(O_BOX, np.int32)
                    staging[offs] = acc[si][rows, cols]
                    r = np.arange(64)[:, None]
                    col = np.arange(dot.N_COLS)[None, :]
                    got = staging[swizzle128(col // 32 * O_BOX + r * 128
                                             + col % 32 * 4) // 4]
                    out[p, row:row + 64] = got[:M - row]
    return torch.from_numpy(out)



# ----------------------------------------------------------------------
# P1: the bulk copies of each block
# ----------------------------------------------------------------------

COPY_CASES = [((4, 3, 8, 8), 2), ((32, 3, 8, 8), 2), ((32, 3, 8, 8), 8),
              ((32, 3, 8, 8), 32), ((32, 9, 128, 128), 2),
              ((32, 9, 128, 128), 8), ((32, 9, 128, 128), 32)]


@pytest.mark.parametrize("flat", [False, True])
@pytest.mark.parametrize("shape,rb", COPY_CASES)
def test_copy_plan_moves_every_byte_once(shape, rb, flat):
    R, L, E = shape[0], shape[1], shape[2] * shape[3]
    plan = copy_plan(R, L, E, rb, flat)
    total = R * L * E * 4
    seen = np.zeros(total, np.int8)
    block_bytes = rb * (L if flat else 1) * E * 4
    for block in plan:
        assert sum(n for fill in block for _, _, n in fill) == block_bytes
        for fill in block:
            used = 0
            for g, s, n in fill:
                assert g % 16 == 0 and s % 16 == 0 and n % 16 == 0 and n > 0
                assert s == used          # a fill packs its stage in order
                used += n
                seen[g:g + n] += 1
            assert used <= STAGE_BYTES
    assert len(plan) == R // rb * (1 if flat else L)
    assert (seen == 1).all()


@pytest.mark.parametrize("shape,rb,flat,copies", [
    ((32, 3, 8, 8), 32, True, 1),      # 32·3 planes of 256 B: one copy
    ((32, 3, 8, 8), 8, False, 8),      # one limb: 8 runs of one plane
    ((32, 1, 8, 8), 8, False, 1),      # L = 1: the rows are contiguous
    ((32, 9, 128, 128), 8, True, 1)])  # 64 KB planes: a copy a stage
def test_copy_plan_folds_contiguous_planes(shape, rb, flat, copies):
    """Small planes of a block share a stage; contiguous ones one copy."""
    R, L, E = shape[0], shape[1], shape[2] * shape[3]
    block = copy_plan(R, L, E, rb, flat)[0]
    assert len(block[0]) == copies


@pytest.mark.parametrize("shape,rb,flat", [((4, 3, 8, 8), 2, False),
                                           ((4, 3, 8, 8), 2, True),
                                           ((32, 9, 128, 128), 8, True),
                                           ((1152 // 8, 128, 128), 8, False)])
def test_copy_planes_tiled_copies(shape, rb, flat):
    x = copy_probe.planes_u32(shape, seed=rb)
    assert torch.equal(copy_planes_tiled(x, rb, flat),
                       copy_probe.copy_planes_plain(x, rb, flat))


def test_ring_stages_share_the_sm():
    """192 KB a lone block (8a: 36 blocks, 8b: 4), 96 KB where 144 blocks
    (8c) put two on some of 132 SMs; never more stages than fills, never
    more ring an SM than 192 KB."""
    assert ring_stages(36, 16) == 6
    assert ring_stages(4, 144) == 6
    assert ring_stages(144, 16) == 3
    assert ring_stages(4, 1) == 1
    for blocks in (1, 132, 133, 264, 396, 1000):
        per_sm = -(-blocks // H100_SMS)
        s = ring_stages(blocks, 100)
        assert 2 <= s <= MAX_STAGES_COPY
        if per_sm <= 3:
            assert per_sm * s * STAGE_BYTES <= 196608


# ----------------------------------------------------------------------
# P3: the tile walk, the layouts, products through them
# ----------------------------------------------------------------------

@pytest.mark.parametrize("M,K,batch,ppb,sms", [
    (512, 512, 288, 1, 132),   # 8g: 576 tiles over 132 blocks
    (512, 512, 288, 8, 132),   # 8h: 72 tiles, fewer than the SMs
    (512, 512, 19, 8, 132),    # a short last group
    (320, 96, 19, 8, 4),       # more tiles than SMs, a slab past M
    (192, 1024, 5, 2, 3),      # K = 1024: slabs of 128 rows
    (128, 256, 1, 1, 132)])    # 8e
def test_dot_tiles_cover_each_slab_plane_once(M, K, batch, ppb, sms):
    walk = dot_tiles(M, K, batch, ppb, sms)
    mt = slab_rows(M, K)
    slabs, groups = -(-M // mt), -(-batch // ppb)
    assert len(walk) == min(slabs * groups, sms)
    seen = np.zeros((slabs, batch), np.int64)
    for tiles in walk:
        assert tiles                                # every block has work
        assert len({s for s, _, _ in tiles}) <= 2   # at most one reload of A
        for s, p0, p1 in tiles:
            assert p1 - p0 <= ppb and p0 % ppb == 0
            seen[s, p0:p1] += 1
    assert (seen == 1).all()


def test_dot_slabs_and_stages():
    """256-row slabs where A's 128 KB fits beside two stages and the
    staging; 128 rows at K = 1024; never fewer than two stages."""
    assert (slab_rows(512, 512), dot_stages(512, 512)) == (256, 2)
    assert slab_rows(512, 1024) == 128 and dot_stages(512, 1024) == 2
    assert slab_rows(128, 256) == 128 and dot_stages(128, 256) >= 2
    assert dot_stages(64, 32) == MAX_STAGES


def test_bt_chunk_map_is_the_tma_swizzle():
    """The transposer puts each B[k, n] of a chunk at one byte of the stage
    (a bijection), the byte a TMA load of Bᵀ with the 128-byte swizzle
    would use."""
    where = bt_chunk_map()
    assert np.array_equal(np.sort(where.ravel()), np.arange(CHUNK))
    k, n = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    assert np.array_equal(where, swizzle128(n * 128 + k))


def test_operand_reads_the_k32_slices():
    """A K-major 128-byte-swizzle descriptor advanced by 32·kk inside the
    swizzle row reads columns 32·kk .. +31 of the tile it points at."""
    rng = np.random.default_rng(3)
    tile = rng.integers(0, 256, (128, 128), dtype=np.uint8)
    smem = np.zeros(2 * CHUNK, np.uint8)
    smem[CHUNK + swizzle128(np.arange(CHUNK))] = tile.ravel()
    for kk in range(4):
        assert np.array_equal(operand(smem, CHUNK + 32 * kk, 128),
                              tile[:, 32 * kk:32 * kk + 32])


def test_epilogue_layout_is_a_bijection():
    """The accumulator fragment covers the m64×n128 tile once, and the
    staging offsets cover the four boxes' 32 KB once, 4-byte aligned."""
    rows, cols = fragment_rows_cols()
    assert len(set(zip(rows.ravel(), cols.ravel()))) == 64 * 128
    offs = stage_offsets().ravel()
    assert np.array_equal(np.sort(offs), np.arange(0, 4 * O_BOX, 4))


def _dot_general(a, b):
    """The probe scripts' product: dot_general with int32 accumulation."""
    return np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("pair", [p[0] for p in dot.PAIRS])
def test_dot_i8_tiled_matches_plain_and_dot_general(pair):
    _, la, ra = next(p for p in dot.PAIRS if p[0] == pair)
    a, b = dot.pair_inputs(la, ra)
    got = dot_i8_tiled(torch.from_numpy(a), torch.from_numpy(b)[None])
    want = dot.dot_i8_plain(torch.from_numpy(a), torch.from_numpy(b)[None])
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got[0].numpy(), _dot_general(a, b))


@pytest.mark.parametrize("M,K,batch,ppb,sms", [(320, 96, 19, 8, 4),
                                               (192, 1024, 5, 2, 3),
                                               (512, 512, 3, 2, 2),
                                               (64, 32, 3, 1, 132)])
def test_dot_i8_tiled_edges(M, K, batch, ppb, sms):
    """Slabs past M, a last chunk past K (all four k32 steps over a stale
    stage), K = 1024, 256-row slabs, blocks with several tiles."""
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.integers(-128, 128, (M, K), dtype=np.int8))
    b = torch.from_numpy(rng.integers(0, 256, (batch, K, 128),
                                      dtype=np.uint8))
    got = dot_i8_tiled(a, b, ppb, sms)
    assert torch.equal(got, dot.dot_i8_plain(a, b))
    np.testing.assert_array_equal(got[1].numpy(),
                                  _dot_general(a.numpy(), b[1].numpy()))


# ----------------------------------------------------------------------
# P4 dot / dot2: the cluster walk, the layouts, products through them
# ----------------------------------------------------------------------

# csrc/plane_parts.cu: CTAs a cluster (one 128-row slab of w[l] each),
# threads a CTA, the plane side, w[l]'s side, an operand tile [128 n][128 k]
CLUSTER, DOT_THREADS, PN, WK = 4, 256, 128, 512
TILE = PN * K_CHUNK
PIECE = 64 * 32                          # a warpgroup's k32 step of w
ELEM_THREADS, ELEM_VECS = 128, 8         # the elementwise parts: a block


def plane_walk(rows: int, L: int, fit: int) -> list[list[tuple[int, int]]]:
    """The clusters' walk: min(planes, fit) clusters, cluster c taking
    items [items·c/C, items·(c+1)/C) of the limb-major order, item i =
    (limb i // rows, row i % rows), plane row·L + limb."""
    items = rows * L
    clusters = min(items, fit)
    return [[(i // rows, i % rows)
             for i in range(items * c // clusters, items * (c + 1) // clusters)]
            for c in range(clusters)]


def put_quarters(plane: np.ndarray) -> np.ndarray:
    """x8ᵀ as ``put_cols`` writes it in each rank and the bulk copies
    spread it: rank c's thread tid takes column n = 32c + tid % 32, k rows
    16·kb .. +15 (kb = tid // 32), their low bytes as one 16-byte unit kb
    of row n at unit kb ^ (n % 8); rank c's rows n are its 4 KB part."""
    tile = np.zeros(TILE, np.uint8)
    low = (plane & 0xFF).astype(np.uint8)                  # [k, n]
    tid = np.arange(DOT_THREADS)
    kb = tid >> 5
    for rank in range(CLUSTER):
        n = 32 * rank + (tid & 31)
        part = np.zeros(TILE, np.uint8)
        for r in range(16):
            part[n * K_CHUNK + ((kb ^ (n & 7)) << 4) + r] = low[16 * kb + r, n]
        lo, hi = 32 * rank * K_CHUNK, 32 * (rank + 1) * K_CHUNK
        tile[lo:hi] = part[lo:hi]                # the copied part
    return tile


def put_gs(acc: np.ndarray) -> np.ndarray:
    """g8ᵀ [4 chunks][128 n][128 k] as ``put_g`` leaves it in every CTA:
    ``acc`` [rank, warpgroup, thread, 64] int32 fragments; lane 4g + t packs
    the low bytes of d[4j .. 4j+3], lane g reads the packs of lanes
    16·(g >> 1 & 1) + 4s + t (s = 0..3), takes byte (g & 1) + 2·(g >> 2)
    of each and stores the word at word g >> 1 of unit 2·warp + wg of
    column 8j + 2t + (g & 1) in chunk ``rank``."""
    gt = np.zeros(4 * TILE, np.uint8)
    words = gt.view(np.uint32)
    lt = np.arange(128)
    w, lane = lt >> 5, lt & 31
    g, t = lane >> 2, lane & 3
    e, wi = g & 1, g >> 1
    sel = e + 2 * (wi >> 1)
    src = 16 * (wi & 1) + t                   # lane in the warp, s = 0
    for rank in range(CLUSTER):
        for wg in range(2):
            d = acc[rank, wg].astype(np.int64) & 0xFF
            for j in range(16):
                p = (d[:, 4 * j] | d[:, 4 * j + 1] << 8
                     | d[:, 4 * j + 2] << 16 | d[:, 4 * j + 3] << 24)
                word = np.zeros(128, np.int64)
                for s in range(4):
                    b = p[32 * w + src + 4 * s]    # the shuffle's source
                    word |= ((b >> (8 * sel)) & 0xFF) << (8 * s)
                n = 8 * j + 2 * t + e
                u = 2 * w + wg
                off = rank * TILE + n * K_CHUNK + ((u ^ (n & 7)) << 4) + 4 * wi
                words[off // 4] = word.astype(np.uint32)
    return gt


def swizzle32(offset):
    """The 32-byte swizzle of a byte offset from a 256-byte-aligned base:
    its 16-byte half XOR bit 2 of its row (of 32 bytes)."""
    return offset ^ (((offset >> 7) & 1) << 4)


def w_slab(w: np.ndarray, rank: int) -> np.ndarray:
    """Rank ``rank``'s 64 KB slab as its TMA loads lay it: piece (h, c, kk)
    (2 KB at ((4h + c)·4 + kk)·2048, one [4][16][32] box) holds rows
    128·b + 32·rank + 16·h .. +15 of blocks b = 0..3, columns 128·kk + 32·c
    .. +31, with the 32-byte swizzle (row 16·b + r of the piece)."""
    slab = np.zeros(2 * 16 * PIECE, np.uint8)
    box = np.arange(PIECE)
    for h in range(2):
        for c in range(4):
            for kk in range(4):
                rws = [128 * b + 32 * rank + 16 * h + r for b in range(4)
                       for r in range(16)]
                tile = w[np.ix_(rws, 128 * kk + 32 * c + np.arange(32))]
                at = ((h * 4 + c) * 4 + kk) * PIECE
                slab[at + swizzle32(box)] = tile.reshape(-1)
    return slab


def operand32(smem: np.ndarray, start: int) -> np.ndarray:
    """The [64, 32] bytes a K-major 32-byte-swizzle descriptor at
    ``start`` (a 256-byte-aligned piece) gives one wgmma: row r at
    (r // 8)·256 + (r % 8)·32, swizzled."""
    r = np.arange(64)[:, None]
    j = np.arange(32)[None, :]
    off = r // 8 * 256 + r % 8 * 32 + j
    return smem[start + swizzle32(off)]


def slab_products(slab: np.ndarray, b: np.ndarray, cstep: int,
                  kstep: int) -> np.ndarray:
    """``slab_product`` of both warpgroups: [2, 128 threads, 64] int32
    fragments of the slab's rows @ B over K in the permuted order, step
    (c, kk) reading piece (h, c, kk) and B at c·cstep + 32·kk·kstep."""
    rows, cols = fragment_rows_cols()
    out = np.zeros((2, 128, 64), np.int32)
    for wg in range(2):
        acc = np.zeros((64, PN), np.int64)
        for c in range(4):
            for kk in range(4):
                aop = operand32(slab, ((wg * 4 + c) * 4 + kk) * PIECE)
                bop = operand(b, c * cstep + 32 * kk * kstep, PN)
                acc += aop.view(np.int8).astype(np.int64) \
                    @ bop.view(np.int8).astype(np.int64).T
        out[wg] = acc[rows, cols]
    return out


def plane_dot_tiled(variant: str, x: torch.Tensor, w: torch.Tensor,
                    fit: int = H100_SMS // CLUSTER) -> torch.Tensor:
    """dot / dot2 through the kernel's decomposition: the clusters' walk,
    each rank's slab, x8ᵀ from the four ranks' parts, all 512 rows of each
    product through the descriptors and fragments in the permuted K order,
    dot2's int8 g through ``put_g``'s shuffles, each rank's warpgroup 0
    rows 0..31 stored as rows 32·rank .. +31 through the staging boxes."""
    rows, L = x.shape[:2]
    X = x.numpy().view(np.uint32)
    W = w.numpy().view(np.uint8)
    out = np.zeros(x.shape, np.int32)
    for items in plane_walk(rows, L, fit):
        limb = -1
        for l, r in items:
            if l != limb:
                limb = l
                slabs = [w_slab(W[l], rank) for rank in range(CLUSTER)]
            xt = put_quarters(X[r, l])
            acc = np.stack([slab_products(slabs[rank], xt, 32, 0)
                            for rank in range(CLUSTER)])
            if variant == "dot2":
                gt = put_gs(acc)
                acc = np.stack([slab_products(slabs[rank], gt, TILE, 1)
                                for rank in range(CLUSTER)])
            # warp 0 of each warpgroup: rows 0..15 of its fragment through
            # four [16][32] staging boxes, stored at rows 32·rank + 16·wg
            offs = stage_offsets(32, 16 * 128) // 4
            rr = np.arange(16)[:, None]
            col = np.arange(PN)[None, :]
            for rank in range(CLUSTER):
                for wg in range(2):
                    staging = np.zeros(4 * 16 * 32, np.int32)
                    staging[offs] = acc[rank, wg, :32]
                    r0 = 32 * rank + 16 * wg
                    out[r, l, r0:r0 + 16] = staging[swizzle128(
                        col // 32 * 16 * 128 + rr * 128 + col % 32 * 4) // 4]
    return torch.from_numpy(out)


@pytest.mark.parametrize("rows,L,fit", [
    (32, 9, 33), (32, 9, 32),       # the probe's shape, 33 or 32 clusters
    (1, 1, 33), (5, 3, 33), (5, 3, 4), (2, 9, 5), (32, 1, 7)])
def test_plane_walk_covers_each_item_once(rows, L, fit):
    """Every (limb, row) once; clusters ≤ fit, none idle; a cluster's items
    are consecutive in limb-major order, so it reloads w at most once per
    limb boundary it crosses."""
    walk = plane_walk(rows, L, fit)
    assert len(walk) == min(rows * L, fit) and all(walk)
    seen = np.zeros((L, rows), np.int64)
    for items in walk:
        order = [l * rows + r for l, r in items]
        assert order == list(range(order[0], order[0] + len(order)))
        assert len({l for l, _ in items}) <= 1 + (len(items) - 1) // rows + 1
        for l, r in items:
            seen[l, r] += 1
    assert (seen == 1).all()
    sizes = [len(items) for items in walk]
    assert max(sizes) - min(sizes) <= 1


def test_slabs_hold_interleaved_rows_in_permuted_k():
    """Rank c's piece (h, c', kk) holds rows 128·b + 32·c + 16·h .. +15 of
    blocks b = 0..3, columns 128·kk + 32·c' .. +31; the four ranks' slabs
    hold each byte of w[l] once; the stored rows 0..127 are block 0's,
    rows 0..15 of each warpgroup's tile (its warp 0)."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 256, (WK, WK), dtype=np.uint8)
    seen = np.zeros((WK, WK), np.int64)
    stored = set()
    for rank in range(CLUSTER):
        slab = w_slab(w, rank)
        for h in range(2):
            rws = np.array([128 * b + 32 * rank + 16 * h + r
                            for b in range(4) for r in range(16)])
            stored |= set(rws[:16].tolist())
            for c in range(4):
                for kk in range(4):
                    got = operand32(slab, ((h * 4 + c) * 4 + kk) * PIECE)
                    cls = 128 * kk + 32 * c + np.arange(32)
                    assert np.array_equal(got, w[np.ix_(rws, cls)])
                    seen[np.ix_(rws, cls)] += 1
    assert (seen == 1).all()
    assert stored == set(range(PN))


def test_x8t_is_the_swizzled_transpose():
    """The four ranks' quarters fill x8ᵀ once: byte (n, k) holds the low
    byte of x[k, n] at the 128-byte swizzle of n·128 + k."""
    rng = np.random.default_rng(6)
    plane = rng.integers(0, 1 << 32, (PN, PN), dtype=np.uint64) \
        .astype(np.uint32)
    tile = put_quarters(plane)
    k, n = np.meshgrid(np.arange(PN), np.arange(PN), indexing="ij")
    assert np.array_equal(tile[swizzle128(n * K_CHUNK + k)],
                          (plane & 0xFF).astype(np.uint8))


def test_g8t_is_the_swizzled_transpose():
    """``put_g``'s shuffles put the low byte of g row 128·w + 32·rank +
    16·wg + r (warp w's fragment row r of warpgroup wg) at k 32·w + 16·wg
    + r of chunk ``rank``, swizzled, each k once: chunk c holds g rows
    128·kk + 32·c + j at k 32·kk + j, the columns of w piece (c, kk)."""
    rng = np.random.default_rng(7)
    acc = rng.integers(-(1 << 31), 1 << 31, (CLUSTER, 2, 128, 64),
                       dtype=np.int64).astype(np.int32)
    gt = put_gs(acc)
    frow, fcol = fragment_rows_cols()                 # row 16·w + r
    g = np.zeros((WK, PN), np.int64)
    for rank in range(CLUSTER):
        for wg in range(2):
            grow = 128 * (frow // 16) + 32 * rank + 16 * wg + frow % 16
            g[grow, fcol] = acc[rank, wg]
    c, kk, j, n = np.meshgrid(np.arange(4), np.arange(4), np.arange(32),
                              np.arange(PN), indexing="ij")
    at = c * TILE + swizzle128(n * K_CHUNK + 32 * kk + j)
    assert np.array_equal(np.sort(at.ravel()), np.arange(4 * TILE))
    assert np.array_equal(gt[at], (g[128 * kk + 32 * c + j, n] & 0xFF)
                          .astype(np.uint8))


@pytest.mark.parametrize("variant", ["dot", "dot2"])
@pytest.mark.parametrize("rows,L,fit", [(1, 1, 33), (2, 3, 4), (3, 1, 2)])
def test_plane_dot_tiled_matches_plain_and_dot_general(variant, rows, L,
                                                       fit):
    """Products through the cluster decomposition equal the plain version
    and the probe's dot_general chain, with the extreme int32 values in x
    and clusters whose range crosses a limb boundary (2 x 3 over 4)."""
    x, w, tw, tws = kernel_parts.make_inputs(rows, L, seed=rows + L)
    x.view(-1)[:4] = torch.tensor([-(1 << 31), (1 << 31) - 1, -1, 0],
                                  dtype=torch.int32)
    got = plane_dot_tiled(variant, x, w, fit)
    assert torch.equal(got, kernel_parts.plane_parts_plain(variant, x, w, tw,
                                                           tws))
    xs = np.tile((x[-1, -1].numpy() & 0xFF).astype(np.uint8).view(np.int8),
                 (4, 1))
    g = _dot_general(w[-1].numpy(), xs)
    if variant == "dot2":
        g = _dot_general(w[-1].numpy(), (g & 0xFF).astype(np.uint8)
                         .view(np.int8))
    np.testing.assert_array_equal(got[-1, -1].numpy(), g[:PN])


def test_elementwise_blocks_cover_each_plane_once():
    """Four blocks a plane; block b's thread t takes uint4 1024·b + t +
    128·i (i = 0..7): every 16-byte unit of the plane once, a warp's 32 on
    512 contiguous bytes."""
    ctas = PN * PN // 4 // (ELEM_THREADS * ELEM_VECS)
    assert ctas == 4
    b = np.arange(ctas)[:, None, None]
    i = np.arange(ELEM_VECS)[None, :, None]
    t = np.arange(ELEM_THREADS)[None, None, :]
    idx = b * ELEM_THREADS * ELEM_VECS + i * ELEM_THREADS + t
    assert np.array_equal(np.sort(idx.ravel()), np.arange(PN * PN // 4))
    assert (np.diff(idx[..., :32], axis=-1) == 1).all()
