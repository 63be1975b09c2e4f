"""The port's fft, rotation and client/server demos against hetpu's:
``fft fft``, ``fft bfft``, ``math_operations bench_rot`` and
``client_server_rookie simple`` / ``fft`` print hetpu's results at
``--small --cpu``, Timer lines aside (``torch_demo_cases``)."""

import pytest

from torch_demo_cases import assert_prints_hetpus

DEMOS = [("fft", "fft"), ("fft", "bfft"), ("math_operations", "bench_rot"),
         ("client_server_rookie", "simple"), ("client_server_rookie", "fft")]


@pytest.mark.parametrize("suite,name", DEMOS,
                         ids=[f"{s}-{n}" for s, n in DEMOS])
def test_demo_prints_hetpus_results(suite, name, tmp_path, monkeypatch):
    assert_prints_hetpus(suite, name, tmp_path, monkeypatch)
