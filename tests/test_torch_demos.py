"""The port's ``matrix_operations`` demos (CKKS) against hetpu's: what
``python -m hetpu_torch.demos matrix_operations <name> --small --cpu``
prints equals what ``python -m hetpu.demos`` prints, Timer lines aside
(``torch_demo_cases``).  The fft, rotation and client/server demos are in
``test_torch_demos_fft_offload.py``; the BFV demos, the dispatch and the
level-sweep timers in ``test_torch_demos_port.py``."""

import pytest

from torch_demo_cases import assert_prints_hetpus

NAMES = ["op", "sum_elems", "batch_matmul_ckks", "batched_matmul_ckks",
         "least_squares_2d"]


@pytest.mark.parametrize("name", NAMES)
def test_matrix_demo_prints_hetpus_results(name, tmp_path, monkeypatch):
    assert_prints_hetpus("matrix_operations", name, tmp_path, monkeypatch)
