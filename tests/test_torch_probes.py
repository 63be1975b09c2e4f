"""The card micro-benchmarks of hetpu_torch.probes against the TPU probes'
computations, on the CPU (plain versions), exact.

The probe scripts run at import, so nothing imports them: each probe's
per-step computation is rebuilt here in jnp from the helpers the script
uses (``hetpu.core.mxu_ntt._extract_digit_list``, ``_shoup_scalarish``) and
``jax.lax.dot_general(..., preferred_element_type=jnp.int32)``, at small
sizes (1–2 rows, 2 limbs, 2 planes).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hetpu.core.mxu_ntt import _extract_digit_list, _shoup_scalarish
from hetpu_torch import probes
from hetpu_torch.core.modular import from_u32, to_u32
from hetpu_torch.core.mxu_digits import wrap_i8
from hetpu_torch.probes import copy as copy_probe
from hetpu_torch.probes import dot, kernel_parts, overhead2

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
Q = np.uint32((1 << 30) + 1)
STEPS = 3


def _jnp_chain(f, x):
    """The scripts' scan body: o = f(c); c = o ^ (o[..., :1, :1] & 1)."""
    for _ in range(STEPS):
        o = f(x)
        x = o ^ (o[..., :1, :1] & 1)
    return np.asarray(x)


def _port_chain(f, x):
    for _ in range(STEPS):
        x = probes.feedback(f(x))
    return to_u32(x)


def _u32(shape, seed, hi=1 << 30):
    return np.random.default_rng(seed).integers(0, hi, shape,
                                                dtype=np.uint64
                                                ).astype(np.uint32)


@pytest.mark.parametrize("rb,flat", [(1, False), (2, False), (1, True),
                                     (2, True)])
def test_copy_chain_matches_grid_probe(rb, flat):
    """probe_grid's copy chain (8a, 8b): every block shape copies."""
    x = _u32((2, 2, 8, 8), 1)
    want = _jnp_chain(lambda c: c, jnp.asarray(x))
    got = _port_chain(lambda c: copy_probe.copy_planes(c, rb, flat),
                      from_u32(x))
    np.testing.assert_array_equal(got, want)


def test_copy_chain_matches_overhead_probe():
    """probe_overhead's 2-copy step on [rows, n, n] (8c) and its torch-only
    steps."""
    x = _u32((8, 8, 8), 2)
    c1 = lambda v: copy_probe.copy_planes(v, 8)
    np.testing.assert_array_equal(
        _port_chain(lambda v: c1(c1(v)), from_u32(x)),
        _jnp_chain(lambda v: v, jnp.asarray(x)))
    np.testing.assert_array_equal(
        _port_chain(lambda v: v ^ 1, from_u32(x)),
        _jnp_chain(lambda v: v ^ jnp.uint32(1), jnp.asarray(x)))


@pytest.mark.parametrize("launches", [1, 2, 8])
def test_muladd_chain_matches_overhead2_probe(launches):
    """probe_overhead2's pcall body (8d), x * 2654435761 + 1 mod 2^32, on
    values anywhere in [0, 2^32)."""
    x = _u32((2, 2, 8, 8), 3, hi=1 << 32)
    x[0, 0, 0, :4] = [0, 1, (1 << 31), (1 << 32) - 1]

    def ref(c):
        for _ in range(launches):
            c = c * jnp.uint32(2654435761) + jnp.uint32(1)
        return c

    def ours(c):
        for _ in range(launches):
            c = overhead2.muladd_u32(c)
        return c
    np.testing.assert_array_equal(_port_chain(ours, from_u32(x)),
                                  _jnp_chain(ref, jnp.asarray(x)))


def _dot_general(a, b, contract=((1,), (0,))):
    return np.asarray(jax.lax.dot_general(
        jnp.asarray(a), jnp.asarray(b), (contract, ((), ())),
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("pair", [p[0] for p in dot.PAIRS])
def test_dot_pairs_match_u8_dot_probe(pair):
    """probe_u8_dot's four signedness pairs (8e): numpy int64 and
    dot_general agree with the plain version."""
    _, la, ra = next(p for p in dot.PAIRS if p[0] == pair)
    a, b = dot.pair_inputs(la, ra)
    got = dot.dot_i8_plain(torch.from_numpy(a),
                           torch.from_numpy(b)[None])[0].numpy()
    np.testing.assert_array_equal(got, a.astype(np.int64)
                                  @ b.astype(np.int64))
    np.testing.assert_array_equal(got, _dot_general(a, b))


def test_dot_matches_pallas_s8_probe():
    """probe_pallas_s8 (8f): s8 [512,512] @ [512,128]."""
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (512, 512), dtype=np.int8)
    x = rng.integers(-128, 128, (512, 128), dtype=np.int8)
    got = dot.dot_i8_plain(torch.from_numpy(w), torch.from_numpy(x)[None])
    np.testing.assert_array_equal(got[0].numpy(), _dot_general(w, x))


def test_int8_feedback_chain_matches_int8_mxu_probe():
    """probe_int8_mxu's chain (8g, 8h) at B=2: x ← int8(moveaxis(
    dot_general(w, x, contract w:1 with x:1))), the int8 cast wrapping."""
    w, a = dot.int8_mxu_inputs(2)
    jx, x = jnp.asarray(a.numpy()), a
    for _ in range(2):
        o = jax.lax.dot_general(jnp.asarray(w.numpy()), jx,
                                (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.int32)
        jx = jnp.moveaxis(o, 1, 0).astype(jnp.int8)
        x = wrap_i8(dot.dot_i8_plain(w, x))
    assert x.dtype == torch.int8
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))


def _parts_ref(variant, x, w, tw, tws):
    """probe_kernel_parts' kernel body, plane by plane, in jnp."""
    x, tw, tws = (jnp.asarray(v) for v in (x, tw, tws))
    n1 = x.shape[-2]
    out = np.zeros(x.shape, np.uint32)
    for r in range(x.shape[0]):
        for l in range(x.shape[1]):
            xx = x[r, l]
            if variant in ("dot", "dot2"):
                xs = jnp.concatenate([xx.astype(jnp.int8)] * 4, axis=0)
                g = _dot_general(w[l], xs)
                if variant == "dot2":
                    g = _dot_general(w[l], jnp.asarray(g).astype(jnp.int8))
                o = jnp.asarray(g)[:n1].astype(jnp.uint32)
            elif variant == "extract":
                ds = _extract_digit_list(xx, Q, Q // 2)
                o = (ds[0].astype(jnp.uint32) ^ ds[1].astype(jnp.uint32)
                     ^ ds[2].astype(jnp.uint32) ^ ds[3].astype(jnp.uint32))
            elif variant == "recomb":
                acc = None
                for j in range(4):
                    t = _shoup_scalarish(xx + jnp.uint32(j), tw[l, 0, j],
                                         tws[l, 0, j], Q)
                    acc = t if acc is None else jnp.where(
                        acc + t >= Q, acc + t - Q, acc + t)
                o = acc
            elif variant == "twiddle":
                o = _shoup_scalarish(xx, tw[l], tws[l], Q)
            else:
                o = xx
            out[r, l] = np.asarray(o)
    return out


@pytest.mark.parametrize("variant", kernel_parts.VARIANTS)
def test_plane_parts_match_kernel_parts_probe(variant):
    """probe_kernel_parts (8i), every variant, at 2 rows × 2 limbs of
    [128, 128] planes, on inputs that also hold the high bit and q."""
    x, w, tw, tws = kernel_parts.make_inputs(rows=2, limbs=2, seed=11)
    xn = to_u32(x).copy()
    xn[0, 0, 0, :6] = [0, Q // 2, Q // 2 + 1, Q, (1 << 31) + 5,
                       (1 << 32) - 1]
    x = from_u32(xn)
    want = _parts_ref(variant, xn, w.numpy(), to_u32(tw), to_u32(tws))
    got = kernel_parts.plane_parts(variant, x, w, tw, tws)
    np.testing.assert_array_equal(to_u32(got), want)


def test_kernel_parts_companion_is_shoup():
    _, _, tw, tws = kernel_parts.make_inputs(rows=1, limbs=2)
    t = to_u32(tw).astype(np.uint64)
    np.testing.assert_array_equal(to_u32(tws),
                                  ((t << np.uint64(32)) // np.uint64(Q))
                                  .astype(np.uint32))


def test_wrappers_refuse_bad_input():
    x = torch.zeros((3, 2, 8, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        copy_probe.copy_planes(x, 2)                  # 3 rows, blocks of 2
    with pytest.raises(TypeError):
        overhead2.muladd_u32(x.to(torch.int64))
    with pytest.raises(TypeError):
        dot.dot_i8(torch.zeros((4, 4), dtype=torch.int32),
                   torch.zeros((1, 4, 4), dtype=torch.int8))
    with pytest.raises(ValueError):
        dot.dot_i8(torch.zeros((4, 4), dtype=torch.int8),
                   torch.zeros((1, 8, 4), dtype=torch.int8))
    xp, w, tw, tws = kernel_parts.make_inputs(rows=1, limbs=1, n=8)
    with pytest.raises(ValueError):
        kernel_parts.plane_parts("fft", xp, w, tw, tws)
    with pytest.raises(ValueError):
        kernel_parts.plane_parts("copy", xp, w[:, :8], tw, tws)


TINY = {"grid": dict(rows=2, limbs=2, n=8, k=2, rbs=(1, 2)),
        "overhead": dict(rows=8, n=8, k=2),
        "overhead2": dict(rows=2, limbs=2, n=8, k=2),
        "u8_dot": {}, "pallas_s8": {},
        "int8_mxu": dict(batch=2, k=2),
        "kernel_parts": dict(rows=1, limbs=1, k=1),
        "kernel_micro": dict(preset="test_tiny", batch=2, iters=1)}


@pytest.mark.parametrize("name", probes.NAMES)
def test_probe_runs_on_the_cpu(name, capsys):
    """Each probe's entry point at a tiny size on the plain versions: it
    prints its lines, and its results are exact where it checks."""
    res = probes.run(name, device="cpu", **TINY[name])
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    if name in ("u8_dot", "pallas_s8"):
        assert all(r["exact"] for r in (res if isinstance(res, list)
                                        else [res]))
    else:
        assert res and all(r.get("graph_ms") is None for r in res)


def test_count_replay_adds_the_recorded_launches(monkeypatch):
    """A replay of a CUDA graph counts the launches its capture recorded,
    as many times as it is replayed."""
    from hetpu_torch.core import cuda_lib
    monkeypatch.setattr(cuda_lib, "launches", dict.fromkeys(
        cuda_lib.launches, 0))
    for _ in range(3):
        cuda_lib.count_replay({"copy_planes": 2, "dot_i8": 1})
    assert cuda_lib.launches["copy_planes"] == 6
    assert cuda_lib.launches["dot_i8"] == 3
    assert cuda_lib.launches["ntt"] == 0


def test_recording_counts_apart_and_ends():
    """Inside ``recording`` the counts go to a fresh dict; after it, to
    ``launches`` again."""
    from hetpu_torch.core import cuda_lib
    with cuda_lib.recording() as rec:
        assert cuda_lib._recorded is rec and not any(rec.values())
        assert set(rec) == set(cuda_lib.launches)
    assert cuda_lib._recorded is None


def test_window_ms_off_the_card():
    """The probes' one timing window: the host clock off the card."""
    assert probes.window_ms(lambda: sum(range(1000)), cuda=False) >= 0


def test_probe_cli_raises_without_a_card(tmp_path):
    """``python -m hetpu_torch.probes grid`` runs on the card by default and
    fails where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(REPO), PATH="/usr/bin:/bin",
               CUDA_HOME=str(tmp_path / "no-cuda"))
    proc = subprocess.run([sys.executable, "-m", "hetpu_torch.probes",
                           "grid"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is false" in proc.stderr
    assert "eager" not in proc.stdout
