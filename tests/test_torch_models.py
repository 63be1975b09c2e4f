"""The port's encrypted least-squares fit (``hetpu_torch.models``) against
hetpu's on the CPU at test_deep, bit for bit on both fitted coefficients'
ciphertexts, and the decrypts against the closed form with
tests/test_models.py's bound (rtol 1e-2).

The data are tests/test_models.py's (5 points on a noisy line); the sums
take sum_elems' doubling branch (keys 1, 2, 4 only).  The inversion's
guess is 1/D, so two iterations already converge (hetpu compiles every op
at every level it reaches, and each iteration costs two levels).
"""

import numpy as np
import pytest

from hetpu.models.least_squares import least_squares_2d as ref_lsq
from hetpu.session import Session as RefSession
from hetpu_torch.models.least_squares import least_squares_2d
from hetpu_torch.session import Session
from torch_app_cases import assert_same, encrypt_pair

SEED = b"\x06" * 32
N_POINTS, INV_ITERS = 5, 2


@pytest.fixture(scope="module")
def fit():
    ref = RefSession.create("test_deep", seed=SEED, galois_steps=[1, 2, 4])
    port = Session.create("test_deep", seed=SEED, galois_steps=[1, 2, 4],
                          device="cpu")
    rng = np.random.default_rng(6)
    x = rng.uniform(0.5, 2.0, N_POINTS)
    y = 0.7 * x + 0.3 + rng.normal(0, 0.02, N_POINTS)
    px, py = np.zeros((2, port.slots))
    px[:N_POINTS], py[:N_POINTS] = x, y
    (rx, cx), (ry, cy) = (encrypt_pair(ref, v, bytes([0x40 + i]) * 32)
                          for i, v in enumerate((px, py)))
    sx, sy, sxx, sxy = x.sum(), y.sum(), (x * x).sum(), (x * y).sum()
    D = N_POINTS * sxx - sx * sx
    want = ref_lsq(ref, rx, ry, N_POINTS, inv_guess=1.0 / D,
                   inv_iters=INV_ITERS)
    got = least_squares_2d(port, cx, cy, N_POINTS, inv_guess=1.0 / D,
                           inv_iters=INV_ITERS)
    closed = ((N_POINTS * sxy - sx * sy) / D, (sxx * sy - sx * sxy) / D)
    return port, got, want, closed


@pytest.mark.parametrize("k,name", [(0, "a"), (1, "b")])
def test_least_squares_2d(fit, k, name):
    port, got, want, closed = fit
    assert_same(got[k], want[k])
    val = port.decrypt(got[k]).real[0]
    np.testing.assert_allclose(val, closed[k], rtol=1e-2)
