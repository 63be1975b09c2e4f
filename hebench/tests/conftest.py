"""The port's presets made once a test process: a preset's prime search
is deterministic, and test_hi's takes about a minute on the CPU, which
every run of a tiny row at it would otherwise pay twice."""

import functools

import pytest


@pytest.fixture(autouse=True, scope="session")
def _presets_once():
    from hetpu_torch.core import params
    made = dict(params._PRESETS)
    params._PRESETS.update({k: functools.cache(f) for k, f in made.items()})
    yield
    params._PRESETS.update(made)
