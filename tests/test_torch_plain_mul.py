"""The plaintext products and their sum (``core/plain_mul.py``) on the
CPU: the plain twin ``plain_mul_sum_plain`` against hetpu's
``modular.shoup_mul`` and ``mod_add`` bit for bit, for 1, 2 and 3 terms
and both mask forms (one row, one a batch row), on residues that hold 0,
1 and q−1; ``Evaluator.multiply_plain`` as the one-term case of
``multiply_plain_sum`` and the latter's refusals; and the card wrapper's
launch arguments and bytes, and its masks of other broadcasts (expanded,
made contiguous or refused), every tensor taken for a card tensor and no
launch made.  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core import modular as ref_modular
from hetpu_torch.core import cuda_lib
from hetpu_torch.core.ciphertext import Ciphertext, Plaintext
from hetpu_torch.core.context import Context
from hetpu_torch.core.evaluator import Evaluator
from hetpu_torch.core.modular import (from_u32, mod_add, mont_constants,
                                      shoup_companion, shoup_mul, to_u32)
from hetpu_torch.core.params import preset
from hetpu_torch.core.plain_mul import (_card_masks, plain_mul_sum,
                                        plain_mul_sum_plain)

torch.set_num_threads(1)

B, N = 3, 64


def _edged(rng, shape, primes) -> torch.Tensor:
    """Uniform residues with 0, 1 and q−1 at the first three x of every
    plane, and the last plane of every limb all q−1."""
    q = np.array(primes, dtype=np.uint64).reshape(-1, 1)
    x = rng.integers(0, 1 << 62, shape, dtype=np.uint64) % q
    x[..., 0], x[..., 1] = 0, 1
    x[..., 2] = (q - 1)[:, 0]
    x.reshape(-1, *x.shape[-2:])[-1] = np.broadcast_to(q - 1, x.shape[-2:])
    return from_u32(x)


def _terms(rng, k, per_row, primes):
    L = len(primes)
    q = from_u32(mont_constants(primes)["q"])
    lead = (B,) if per_row else ()
    terms = []
    for _ in range(k):
        w = _edged(rng, (*lead, L, N), primes)
        terms.append((_edged(rng, (B, 2, L, N), primes), w,
                      shoup_companion(w, q)))
    return terms, q


@pytest.mark.parametrize("per_row", [False, True], ids=["one_row",
                                                        "per_row"])
@pytest.mark.parametrize("k", [1, 2, 3])
def test_plain_twin_is_shoup_then_mod_add(k, per_row):
    """The twin and the wrapper on the CPU equal hetpu's ``shoup_mul`` of
    each term (the mask broadcast over the parts axis) summed by hetpu's
    ``mod_add``, and the port's own, bit for bit."""
    primes = preset("test_tiny").moduli
    rng = np.random.default_rng(10 * k + per_row)
    terms, q = _terms(rng, k, per_row, primes)
    qj = jnp.asarray(to_u32(q))
    want = port = None
    for x, w, ws in terms:
        t = np.asarray(ref_modular.shoup_mul(
            jnp.asarray(to_u32(x)), jnp.asarray(to_u32(w))[..., None, :, :],
            jnp.asarray(to_u32(ws))[..., None, :, :], qj))
        want = t if want is None else np.asarray(
            ref_modular.mod_add(jnp.asarray(want), jnp.asarray(t), qj))
        p = shoup_mul(x, w.unsqueeze(-3), ws.unsqueeze(-3), q)
        port = p if port is None else mod_add(port, p, q)
    for got in (plain_mul_sum_plain(terms, q), plain_mul_sum(terms, q)):
        assert got.shape == (B, 2, len(primes), N)
        np.testing.assert_array_equal(to_u32(got), want)
        assert torch.equal(got, port)


@pytest.fixture(scope="module")
def ev():
    return Evaluator(Context(preset("test_tiny"), "cpu"))


def _ct(rng, ev, level, lead=(B,), scale=2.0 ** 20):
    primes = ev.ctx.params.moduli[: level + 1]
    return Ciphertext(data=_edged(rng, (*lead, 2, level + 1,
                                        ev.ctx.params.poly_degree), primes),
                      level=level, scale=scale)


def _pt(rng, ev, level, lead=(), scale=2.0 ** 20):
    primes = ev.ctx.params.moduli[: level + 1]
    d = _edged(rng, (*lead, level + 1, ev.ctx.params.poly_degree), primes)
    return Plaintext(data=d, shoup=shoup_companion(d, ev.ctx.tables(level).q),
                     level=level, scale=scale)


@pytest.mark.parametrize("lead", [(), (B,)], ids=["one_row", "per_row"])
def test_multiply_plain_is_the_one_term_sum(ev, lead):
    rng = np.random.default_rng(20 + len(lead))
    level = ev.ctx.num_data - 1
    ct, pt = _ct(rng, ev, level), _pt(rng, ev, level, lead)
    one = ev.multiply_plain(ct, pt)
    summed = ev.multiply_plain_sum([(ct, pt)])
    assert torch.equal(one.data, summed.data)
    assert (one.level, one.scale) == (summed.level, summed.scale) \
        == (level, ct.scale * pt.scale)
    q = ev.ctx.tables(level).q
    assert torch.equal(one.data, shoup_mul(ct.data, pt.data.unsqueeze(-3),
                                           pt.shoup.unsqueeze(-3), q))


@pytest.mark.parametrize("fault", ["levels", "shapes", "scales",
                                   "plain_level", "none", "four"])
def test_multiply_plain_sum_refuses(ev, fault):
    """Sources at two levels or of two shapes, products whose scales
    differ, a plaintext at another level than its source, no term, and
    more than three terms all raise."""
    rng = np.random.default_rng(30)
    a, pa = _ct(rng, ev, 1), _pt(rng, ev, 1)
    pairs = {
        "levels": [(a, pa), (_ct(rng, ev, 0), _pt(rng, ev, 0))],
        "shapes": [(a, pa), (_ct(rng, ev, 1, lead=(B + 1,)), pa)],
        "scales": [(a, pa), (a, _pt(rng, ev, 1, scale=2.0 ** 21))],
        "plain_level": [(a, _pt(rng, ev, 0))],
        "none": [],
        "four": [(a, pa)] * 4,
    }[fault]
    with pytest.raises(ValueError):
        ev.multiply_plain_sum(pairs)


@pytest.mark.parametrize("per_row", [False, True], ids=["one_row",
                                                        "per_row"])
@pytest.mark.parametrize("k", [1, 3])
def test_plain_mul_sum_launch_arguments(k, per_row, monkeypatch):
    """The card wrapper's launch: the k (source, mask, companion) pointers
    in order, the unused ones null, the mask's row stride (0 for one row,
    L·N words for a mask a batch row), q, a new output of the sources'
    shape, the batch rows, parts, L and N; the bytes are each source,
    mask and companion once and the sum written once."""
    made = []
    monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "launch", lambda kernel, fn, dev, *args,
                        nbytes: made.append((kernel, fn, args, nbytes)))
    primes = preset("test_tiny").moduli
    L = len(primes)
    terms, q = _terms(np.random.default_rng(40 + k), k, per_row, primes)
    out = plain_mul_sum(terms, q)
    assert out.shape == (B, 2, L, N) and out.dtype == torch.int32
    [(kernel, fn, args, nbytes)] = made
    assert (kernel, fn) == ("plain_mul_sum", "hetpu_plain_mul_sum")
    ptrs = [t.data_ptr() for term in terms for t in term]
    ptrs += [None] * 3 * (3 - k)
    assert args == (*ptrs, k, L * N if per_row else 0, q.data_ptr(),
                    out.data_ptr(), B, 2, L, N)
    mask_rows = B if per_row else 1
    assert nbytes == 4 * N * (k * B * 2 * L + 2 * k * mask_rows * L
                              + B * 2 * L)


@pytest.mark.parametrize("form", ["broadcast", "strided", "wider"])
def test_plain_mul_sum_other_masks_on_the_card(form, monkeypatch):
    """On a card tensor every mask is launched or refused, never taken to
    the plain route: a mask of another broadcast into the sources' leading
    axes is expanded to one a batch row (row stride L·N), a non-contiguous
    one-row mask is made contiguous (row stride 0), and a mask with a
    leading axis the sources lack raises."""
    made = []
    monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "launch", lambda kernel, fn, dev, *args,
                        nbytes: made.append(args))
    primes = preset("test_tiny").moduli
    L = len(primes)
    [(x, w, ws)], q = _terms(np.random.default_rng(50), 1,
                             form == "broadcast", primes)
    if form == "broadcast":
        x, want = torch.stack([x, x]), w.expand(2, *w.shape)
    elif form == "strided":
        w = torch.cat([w, w], dim=-1)[..., ::2]
        ws, want = shoup_companion(w, q), w
    else:
        w, ws = w.expand(4, 1, *w.shape), ws.expand(4, 1, *ws.shape)
        x = x[0]
        with pytest.raises(ValueError, match="broadcast"):
            plain_mul_sum([(x, w, ws)], q)
        assert not made
        return
    masks, w_row = _card_masks(x, [w, ws])
    assert w_row == (L * N if form == "broadcast" else 0)
    assert all(m.is_contiguous() for m in masks)
    assert torch.equal(masks[0], want)
    assert torch.equal(masks[1], shoup_companion(want.contiguous(), q))
    out = plain_mul_sum([(x, w, ws)], q)
    [args] = made
    assert out.shape == x.shape
    assert args[0] == x.data_ptr() and args[3:9] == (None,) * 6
    assert args[9:] == (1, w_row, q.data_ptr(), out.data_ptr(),
                        x.numel() // (2 * L * N), 2, L, N)


def test_plain_mul_sum_refuses_bad_input(monkeypatch):
    """On the card route: a non-contiguous source, N not a multiple of 4
    and primes of another limb count raise; so do sources of two shapes
    on either route."""
    monkeypatch.setattr(cuda_lib, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_lib, "launch", lambda *a, nbytes: None)
    primes = preset("test_tiny").moduli
    [(x, w, ws)], q = _terms(np.random.default_rng(60), 1, False, primes)
    with pytest.raises(ValueError, match="contiguous"):
        plain_mul_sum([(x.transpose(0, 1), w, ws)], q)
    with pytest.raises(ValueError, match="multiple of 4"):
        plain_mul_sum([(x[..., :6].contiguous(), w[..., :6].contiguous(),
                        ws[..., :6].contiguous())], q)
    with pytest.raises(ValueError, match="limbs"):
        plain_mul_sum([(x[..., :1, :].contiguous(),
                        w[:1].contiguous(), ws[:1].contiguous())], q)
    with pytest.raises(ValueError, match="shape"):
        plain_mul_sum_plain([(x, w, ws), (x[0], w, ws)], q)
