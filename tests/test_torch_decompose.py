"""The key switch's digit decomposition, built in place, on the CPU.

``Evaluator._decompose`` allocates the digits ext [..., J, R, N] once and
writes each of their J·R limbs a row once: K2 (``ntt_fwd_lifted``, or the
centered ``ntt_fwd_centered``) stores its F lifted limbs at
``KeySwitchPlan.ext_row``, and K8's ``own_limbs`` stores the L own-prime
limbs d·R⁻¹ at ``own_row``; K1 and ``own_limbs`` read the switched part
where it lies in its ciphertext (``cuda_lib.row_stride``).  Here:

  * the plain twins assembled so, and ``_decompose`` itself, equal the
    construction the evaluator had before (one lift into [..., F, N], a
    Shoup pass over each digit's own primes, a ``cat`` a digit and a
    ``stack``) bit for bit, and hetpu's ``_decompose`` for the CKKS
    presets: test_tiny (α=1, J=3), test_dnum (α=3, J=3, and one level down
    a short last digit), bfv_batch (α=2, J=4, a short last digit) and
    test_tiny with ``centered_fbc=True``;
  * the two maps cover each of the J·R limbs of a row exactly once, each
    lifted limb in its digit at its foreign prime;
  * ``row_stride`` reads the layouts the kernels take and refuses others;
  * a ``RowMap`` with a repeated, negative or too large limb cannot be
    made, and the wrappers, on either path, refuse a map that is not a
    ``RowMap`` or does not fit their output;
  * down the kernel path (the launch recorded, not made) K1 and
    ``own_limbs`` get the part's address and its row stride 3L, and K2
    the map and J·R limbs a row.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core.context import Context as RefContext
from hetpu.core.evaluator import Evaluator as RefEvaluator
from hetpu.core.params import preset as ref_preset
from hetpu_torch.core import cuda_lib, fused_ntt, ks_tail
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import from_u32, shoup_mul, to_u32
from hetpu_torch.core.ntt import ntt_inv, ntt_inv_plain
from hetpu_torch.core.params import preset

torch.set_num_threads(1)

B = 2
# case → (preset, level, centered, compared with hetpu)
CASES = {
    "test_tiny": ("test_tiny", 2, False, True),
    "test_dnum": ("test_dnum", 7, False, True),
    "test_dnum_short": ("test_dnum", 6, False, True),
    "bfv_batch_short": ("bfv_batch", 6, False, False),
    "test_tiny_centered": ("test_tiny", 2, True, False),
}
_CTX = {}


def _ctx(name):
    if name not in _CTX:
        _CTX[name] = Context(preset(name), "cpu")
    return _CTX[name]


def _part(ctx, level, seed):
    """Part 2 of a uniform [B, 3, ℓ+1, N] ciphertext array: rows 3(ℓ+1)
    planes apart, as ``relinearize`` hands it to ``_decompose``."""
    primes = np.array(ctx.params.moduli[: level + 1], dtype=np.uint64)
    n = ctx.params.poly_degree
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 62, (B, 3, level + 1, n), dtype=np.uint64)
    return from_u32((x % primes[:, None]).astype(np.uint32))[:, 2]


def _cat_stack(ev, d, level):
    """The decomposition as the evaluator built it before: the lift into
    [..., F, N], then per digit a ``cat`` of its foreign rows around the
    Shoup pass over its own primes, and a ``stack`` of the digits."""
    plan = ev.ctx.keyswitch_plan(level)
    tabs = ev.ctx.tables(level)
    d = d.contiguous()
    y = ntt_inv_plain(d, tabs, strip_mont=True, extra=plan.dig_inv)
    lift = (plan.lift_w, plan.lift_ws, plan.lift_dig)
    if ev.centered_fbc:
        cat = fused_ntt.ntt_fwd_centered_lift_plain(
            y, *lift, plan.q[: level + 1], plan.foreign_cat_tables)
    else:
        cat = fused_ntt.ntt_fwd_lifted_plain(y, *lift,
                                             plan.foreign_cat_tables)
    exts, off = [], 0
    for di, (lo, hi) in enumerate(plan.digit_bounds):
        nf = len(plan.foreign_idx[di])
        lifted = cat[..., off:off + nf, :]
        off += nf
        direct = shoup_mul(d[..., lo:hi, :], plan.rinv[lo:hi],
                           plan.rinv_shoup[lo:hi], tabs.q[lo:hi])
        exts.append(torch.cat([lifted[..., :lo, :], direct,
                               lifted[..., lo:, :]], dim=-2))
    return torch.stack(exts, dim=-3)


def _twins(ev, d, level):
    """The plain twins assembled as ``_decompose`` assembles the kernels."""
    plan = ev.ctx.keyswitch_plan(level)
    tabs = ev.ctx.tables(level)
    J, R = plan.num_digits, len(plan.basis_tables.primes)
    ext = torch.empty((*d.shape[:-2], J, R, d.shape[-1]), dtype=torch.int32)
    rows = ext.view(*d.shape[:-2], J * R, d.shape[-1])
    y = ntt_inv_plain(d, tabs, strip_mont=True, extra=plan.dig_inv)
    lift = (plan.lift_w, plan.lift_ws, plan.lift_dig)
    if ev.centered_fbc:
        fused_ntt.ntt_fwd_centered_lift_plain(
            y, *lift, plan.q[: level + 1], plan.foreign_cat_tables,
            out=rows, out_rows=plan.ext_row)
    else:
        fused_ntt.ntt_fwd_lifted_plain(y, *lift, plan.foreign_cat_tables,
                                       out=rows, out_rows=plan.ext_row)
    ks_tail.own_limbs_plain(d, rows, plan.own_row, plan.rinv,
                            plan.rinv_shoup, tabs.q)
    return ext


@pytest.mark.parametrize("case", sorted(CASES))
def test_decompose_in_place_equals_cat_stack(case):
    name, level, centered, vs_hetpu = CASES[case]
    ev = Evaluator(_ctx(name), centered_fbc=centered)
    d = _part(ev.ctx, level, seed=len(case) + level)
    assert not d.is_contiguous()
    want = _cat_stack(ev, d, level)
    assert torch.equal(_twins(ev, d, level), want)
    assert torch.equal(ev._decompose(d, level), want)
    if vs_hetpu:
        rctx = RefContext(ref_preset(name))
        ref = RefEvaluator(rctx)._decompose(jnp.asarray(to_u32(d)), level)
        np.testing.assert_array_equal(to_u32(want), np.asarray(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_digit_rows_cover_every_limb_once(case):
    name, level, _, _ = CASES[case]
    plan = _ctx(name).keyswitch_plan(level)
    J, R = plan.num_digits, len(plan.basis_tables.primes)
    ext_row = plan.ext_row.rows.to(torch.int64)
    own_row = plan.own_row.rows.to(torch.int64)
    assert plan.ext_row.limbs == plan.own_row.limbs == J * R
    assert torch.equal(torch.cat([ext_row, own_row]).sort().values,
                       torch.arange(J * R))
    # a lifted row lies in its own digit, at its foreign prime
    assert torch.equal(ext_row // R, plan.lift_dig.to(torch.int64))
    assert torch.equal(ext_row % R, torch.from_numpy(
        np.concatenate(plan.foreign_idx)).to(torch.int64))
    # own prime i in digit j's limb i, for lo_j ≤ i < hi_j
    for j, (lo, hi) in enumerate(plan.digit_bounds):
        assert torch.equal(own_row[lo:hi], j * R + torch.arange(lo, hi))


_BASE = torch.zeros((4, 3, 5, 64), dtype=torch.int32)
LAYOUTS = {
    "contiguous": (_BASE[:, 0].contiguous(), 5),
    "part": (_BASE[:, 2], 15),
    "part_of_two_lead_axes": (_BASE.view(2, 2, 3, 5, 64)[:, :, 1], 15),
    "limbs_dropped": (_BASE[:, 1, :3], 15),
    "one_row": (_BASE[:1, 1], 5),      # contiguous, whatever lies beside
    "no_lead": (_BASE[0, 1], 5),
    "lead_transposed": (_BASE.view(2, 2, 3, 5, 64)[:, :, 1].transpose(0, 1),
                        None),
    "broadcast": (_BASE[:1, 1].expand(4, 5, 64), None),
    "n_sliced": (_BASE[:, 1, :, :32], None),
    "limbs_strided": (_BASE[:, 1, ::2], None),
}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_row_stride(layout):
    t, want = LAYOUTS[layout]
    assert cuda_lib.row_stride(t) == want
    if want is None:
        with pytest.raises(ValueError, match="contiguous"):
            cuda_lib.check_rows("ntt", t)
    else:
        assert cuda_lib.check_rows("ntt", t) == want


def test_ntt_inv_reads_a_part_where_it_lies():
    ctx = _ctx("test_dnum")
    d = _part(ctx, 7, seed=3)
    t = ctx.tables(7)
    assert torch.equal(ntt_inv(d, t, strip_mont=True),
                       ntt_inv_plain(d.contiguous(), t, strip_mont=True))
    with pytest.raises(ValueError, match="contiguous"):
        ntt_inv(d.transpose(0, 1), t)


@pytest.fixture
def made(monkeypatch):
    """The wrappers' launches, as (entry, args), with every tensor taken
    for a card tensor and no launch made."""
    got = []

    def launch(kernel, fn_name, device, *args, nbytes):
        got.append((fn_name, args))
    monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "launch", launch)
    return got


@pytest.mark.parametrize("case", ["test_tiny", "test_dnum_short",
                                  "test_tiny_centered"])
def test_decompose_kernel_arguments(case, made):
    name, level, centered, _ = CASES[case]
    ev = Evaluator(_ctx(name), centered_fbc=centered)
    plan = ev.ctx.keyswitch_plan(level)
    L, J, R = level + 1, plan.num_digits, len(plan.basis_tables.primes)
    d = _part(ev.ctx, level, seed=5)
    ext = ev._decompose(d, level)
    lift = "hetpu_ntt_fwd_centered" if centered else "hetpu_ntt_fwd_lifted"
    assert [m[0] for m in made] == ["hetpu_ntt", lift,
                                    "hetpu_ks_tail_own_limbs"]
    (_, k1), (_, k2), (_, k8) = made
    # K1: x, out, rows, L, ..., inverse, in_stride
    assert (k1[0], k1[2], k1[3], k1[-2], k1[-1]) == (d.data_ptr(), B, L, 1,
                                                     3 * L)
    # K2 / K6: y is K1's output, out the digits, then out_map, out_limbs
    assert (k2[0], k2[1], k2[-2], k2[-1]) == (
        k1[1], ext.data_ptr(), plan.ext_row.rows.data_ptr(), J * R)
    # K8 own_limbs: d, d_stride, out, rows, L, n, map, out_limbs
    assert k8[:8] == (d.data_ptr(), 3 * L, ext.data_ptr(), B, L,
                      ev.ctx.params.poly_degree, plan.own_row.rows.data_ptr(),
                      J * R)


BAD_MAPS = {
    "repeated": (torch.tensor([0, 2, 2], dtype=torch.int32), 4),
    "negative": (torch.tensor([0, -1, 2], dtype=torch.int32), 4),
    "past_the_row": (torch.tensor([0, 1, 4], dtype=torch.int32), 4),
    "not_one_axis": (torch.tensor([[0, 1], [2, 3]], dtype=torch.int32), 4),
    "int64": (torch.tensor([0, 1, 2]), 4),
}


@pytest.mark.parametrize("bad", sorted(BAD_MAPS))
def test_row_map_refuses_a_bad_map(bad):
    rows, limbs = BAD_MAPS[bad]
    with pytest.raises(ValueError, match="RowMap"):
        cuda_lib.RowMap(rows, limbs)


def _map_calls(ev, level, out, ext_row, own_row):
    """The three wrappers that store through a map, on part 2 of a
    ciphertext: (name, call) with ``out``, ``ext_row`` and ``own_row``."""
    plan = ev.ctx.keyswitch_plan(level)
    tabs = ev.ctx.tables(level)
    d = _part(ev.ctx, level, seed=11)
    y = ntt_inv_plain(d, tabs, strip_mont=True, extra=plan.dig_inv)
    lift = (plan.lift_w, plan.lift_ws, plan.lift_dig)
    return {
        "ntt_fwd_lifted": lambda: fused_ntt.ntt_fwd_lifted(
            y, *lift, plan.foreign_cat_tables, out=out, out_rows=ext_row),
        "ntt_fwd_centered_lift": lambda: fused_ntt.ntt_fwd_centered_lift(
            y, *lift, plan.q[: level + 1], plan.foreign_cat_tables, out=out,
            out_rows=ext_row),
        "own_limbs": lambda: ks_tail.own_limbs(
            d, out, own_row, plan.rinv, plan.rinv_shoup, tabs.q)}


MAP_FAULTS = ("plain_tensor", "limbs", "count")


@pytest.mark.parametrize("path", ["cpu", "card"])
@pytest.mark.parametrize("fault", MAP_FAULTS)
def test_wrappers_refuse_a_map_that_does_not_fit(path, fault, monkeypatch):
    """A map that is a bare tensor, an output of other limbs than the
    map's, or a map of other rows than the launch's: refused before any
    store, down the plain path and down the kernel path (no launch)."""
    made = []
    if path == "card":
        monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
        monkeypatch.setattr(cuda_lib, "launch",
                            lambda *a, **k: made.append(a))
    level = 2
    ev = Evaluator(_ctx("test_tiny"))
    plan = ev.ctx.keyswitch_plan(level)
    J, R = plan.num_digits, len(plan.basis_tables.primes)
    n = ev.ctx.params.poly_degree
    M = J * R + (fault == "limbs")
    out = torch.full((B, M, n), -1, dtype=torch.int32)
    ext_row, own_row = plan.ext_row, plan.own_row
    if fault == "plain_tensor":
        ext_row, own_row = ext_row.rows, own_row.rows
    elif fault == "count":
        ext_row = cuda_lib.RowMap(ext_row.rows[:-1].clone(), J * R)
        own_row = cuda_lib.RowMap(own_row.rows[:-1].clone(), J * R)
    for name, call in _map_calls(ev, level, out, ext_row, own_row).items():
        with pytest.raises(TypeError if fault == "plain_tensor"
                           else ValueError, match="RowMap|out"):
            call()
        assert (out == -1).all() and not made, name
