"""Shared helpers of the demos tests: a CLI call's standard output under
fixed seeds, and two outputs compared on what they print.

The port's output is compared with hetpu's (test_torch_demos,
test_torch_demos_fft_offload) and, on the card, with the port's own CPU
run (test_torch_cuda).  The card's host has no JAX, so this module
imports hetpu only inside :func:`assert_prints_hetpus`.

Under the same seeds and empty key caches, both runs draw the same keys
and encryptions and reach the same residues.  Every printed line but the
``Timer`` lines must match: the same words, integers and booleans, and
decoded floats within 1e-9 (the float64 decode of equal residues).
"""

import contextlib
import hashlib
import io
import itertools
import re

from hetpu_torch.core import random as port_rnd
from hetpu_torch.demos.__main__ import main as port_main
from hetpu_torch.utils import keycache

FLOAT_ATOL = 1e-9
TIMER = re.compile(r"^[^:]*time: -?\d+\.\d+ s$")
TOKEN = re.compile(r"True|False|nan|inf|[-+]?(?:\d+\.\d*|\.\d+|\d+)"
                   r"(?:[eE][-+]?\d+)?j?")


@contextlib.contextmanager
def fixed_seeds(tag: str, modules=(port_rnd,)):
    """Inside the block, ``new_seed`` of each of ``modules`` returns the
    same sequence (restarted by every block with the same tag)."""
    counter = itertools.count()

    def new_seed() -> bytes:
        return hashlib.sha256(f"{tag}:{next(counter)}".encode()).digest()

    saved = [m.new_seed for m in modules]
    for m in modules:
        m.new_seed = new_seed
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.new_seed = fn


def run(main, argv, tag: str, modules=(port_rnd,)) -> str:
    """Standard output of one CLI call (return code 0) under fixed seeds."""
    out = io.StringIO()
    with fixed_seeds(tag, modules), contextlib.redirect_stdout(out):
        assert main(argv) == 0
    return out.getvalue()


def printed(text: str):
    """The non-Timer lines as (words with every number replaced by #,
    the numbers' tokens)."""
    lines = [" ".join(ln.split()) for ln in text.splitlines()
             if ln.strip() and not TIMER.match(ln.strip())]
    body = "\n".join(lines)
    return TOKEN.sub("#", body), TOKEN.findall(body)


def assert_same_printed(got: str, want: str) -> None:
    words, numbers = printed(got)
    ref_words, ref_numbers = printed(want)
    assert words == ref_words, (got, want)
    assert numbers and len(numbers) == len(ref_numbers), (got, want)
    for g, w in zip(numbers, ref_numbers):
        if g in ("True", "False", "nan", "inf") or not re.search(
                r"[.eEj]", w):
            assert g == w, (got, want)
        else:
            assert abs(float(g.rstrip("j")) - float(w.rstrip("j"))) \
                <= FLOAT_ATOL, (g, w)


def assert_prints_hetpus(suite: str, name: str, tmp_path, monkeypatch):
    """``<suite> <name> --small --cpu`` prints hetpu's results, both
    packages drawing one seed sequence, each from an empty key cache."""
    from hetpu.core import random as ref_rnd
    from hetpu.demos.__main__ import main as ref_main
    from hetpu.utils import keycache as ref_keycache

    monkeypatch.setattr(ref_keycache, "CACHE_DIR", tmp_path / "hetpu")
    monkeypatch.setattr(keycache, "CACHE_DIR", tmp_path / "port")
    argv = [suite, name, "--small", "--cpu"]
    both = (ref_rnd, port_rnd)
    want = run(ref_main, argv, f"{suite}.{name}", both)
    got = run(port_main, argv, f"{suite}.{name}", both)
    assert_same_printed(got, want)
