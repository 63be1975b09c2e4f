"""Utilities: counterparts of ``hetpu/utils/{metrics,timer,profiling,
debug,keycache}.py`` on PyTorch."""

from __future__ import annotations

import dataclasses

import torch


def leaves(obj) -> list:
    """The leaves of a nest of tuples, lists, dicts and dataclasses, in
    order (a tensor or any other object is a leaf)."""
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in leaves(o)]
    if isinstance(obj, dict):
        return [x for k in obj for x in leaves(obj[k])]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj)
                for x in leaves(getattr(obj, f.name))]
    return [obj]


def tensor_leaves(obj) -> list[torch.Tensor]:
    return [x for x in leaves(obj) if isinstance(x, torch.Tensor)]


# hetpu's export (``hetpu/utils/__init__.py``); last, since timer.py
# imports tensor_leaves from here
from .timer import Timer  # noqa: E402
