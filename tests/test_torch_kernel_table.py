"""The port's kernel table (``cuda_lib.KERNELS``) against the sources, on
the CPU: ``csrc/*.cu`` read as text, nothing built.

  * each kernel's C entry points are ``extern "C"`` functions of
    ``csrc/`` whose parameters have the table's ctypes types, in order,
    and its device functions are ``__global__`` there;
  * every such function and every ``__global__`` is declared once, as a
    kernel's or a helper's (``cuda_lib.HELPERS``);
  * ``cuda_lib.package_kernel`` books each device function, as the torch
    profiler spells it, to its kernel, and PyTorch's own kernels to none;
  * ``launches`` keeps its keys and their order (``hebench`` reads them),
    and ``hebench.trace.package_kernels`` finds the table's device
    functions in ``csrc/`` and no other;
  * ``cuda_lib`` imports no module of the port above it, and
    ``reset_launches`` clears the counters wrapper modules register.
"""

import ast
import ctypes
import os
import re
import subprocess
import sys
import textwrap
from collections import Counter
from pathlib import Path

import pytest

from hetpu_torch.core import cuda_lib, rns

REPO = Path(__file__).resolve().parents[1]
DEVICE_FN = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                       r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(")
ENTRY = re.compile(r'extern "C"[^;{(]*?\b(hetpu_\w+)\s*\(([^)]*)\)')
SOURCES = "\n".join(p.read_text()
                    for p in sorted(cuda_lib.CSRC.glob("*.cu")))
DEFINED = Counter(DEVICE_FN.findall(SOURCES))
# a C parameter's type (its declaration less its name) → its ctypes type
CTYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
          "long long": ctypes.c_longlong,
          "unsigned long long": ctypes.c_ulonglong}


def _ctype(param: str):
    if "*" in param or param.startswith("cudaStream_t"):
        return ctypes.c_void_p
    return CTYPES[param.rsplit(None, 1)[0]]


# every C entry point of csrc/ with its parameters' ctypes types
ENTRIES = [(name, tuple(_ctype(" ".join(p.split()))
                        for p in params.split(",") if p.strip()))
           for name, params in ENTRY.findall(SOURCES)]
TYPES = dict(ENTRIES)


@pytest.mark.parametrize("kernel", cuda_lib.KERNELS, ids=lambda k: k.name)
def test_kernel_entries_and_functions_are_in_csrc(kernel):
    assert kernel.entries and kernel.functions
    for name, args in kernel.entries.items():
        assert name in TYPES, f"{name} is no extern \"C\" function of csrc/"
        assert TYPES[name] == args, name
    for fn in kernel.functions:
        assert DEFINED[fn] == 1, f"{fn} is no single __global__ of csrc/"


def test_every_entry_point_is_declared_once():
    declared = Counter([*(n for k in cuda_lib.KERNELS for n in k.entries),
                        *cuda_lib.HELPERS])
    assert Counter(name for name, _ in ENTRIES) == declared
    assert set(declared.values()) == {1}
    for name, args in cuda_lib.HELPERS.items():
        assert TYPES[name] == args, name


def test_every_device_function_is_declared_once():
    declared = Counter(f for k in cuda_lib.KERNELS for f in k.functions)
    assert declared == DEFINED
    assert set(declared.values()) == {1}


# device functions as the torch profiler names their kernels
PROFILED = [
    ("void (anonymous namespace)::ntt_kernel<8, true>(unsigned int const*, "
     "unsigned int*, int, int, unsigned int const*, unsigned int const*, "
     "unsigned int const*, unsigned int const*, unsigned int const*, int)",
     "ntt"),
    ("void (anonymous namespace)::lifted_kernel<8>(unsigned int const*, "
     "unsigned int*, int, int, int, int, unsigned int const*, int)",
     "ntt_fwd_lifted"),
    ("void (anonymous namespace)::fbc_kernel<8>(unsigned int const*, "
     "unsigned int*, int, int, int, unsigned int const*)", "ntt_fwd_fbc"),
    ("void (anonymous namespace)::centered_kernel<8, true>(unsigned int "
     "const*, unsigned int*, int, int, int, int, unsigned int const*)",
     "ntt_fwd_centered"),
    ("void (anonymous namespace)::ip_kernel<4>(uint4 const*, uint4 const*, "
     "uint4 const*, unsigned int const*, uint4*, int, int, int, int)",
     "inner_product"),
    ("void (anonymous namespace)::centered_fbc_kernel<6>(unsigned int "
     "const*, unsigned int*, long long, int, int, int, int, int)",
     "centered_fbc"),
    ("void (anonymous namespace)::tensor_product_kernel<false>(uint4 const*,"
     " uint4 const*, unsigned int const*, unsigned int const*, uint4*, "
     "unsigned long, int, int)", "tensor_product"),
    ("void (anonymous namespace)::ks_tail_kernel<1>((anonymous namespace)::"
     "Planes, (anonymous namespace)::Planes, (anonymous namespace)::Planes, "
     "uint4*, unsigned long, int, int, int, int, (anonymous namespace)::"
     "Consts)", "ks_tail"),
    ("void (anonymous namespace)::fbc_precise_kernel<7>(unsigned int const*,"
     " unsigned int*, long long, int, int, int, unsigned int const*)",
     "fbc_precise"),
    ("(anonymous namespace)::copy_planes_kernel(unsigned char const*, "
     "unsigned char*, int, long long, int, int, int)", "copy_planes"),
    ("(anonymous namespace)::muladd_kernel(uint4 const*, uint4*, unsigned "
     "long)", "muladd_u32"),
    ("void (anonymous namespace)::dot_i8_kernel<false, true, 2>(CUtensorMap"
     " const, CUtensorMap const, int, int, int)", "dot_i8"),
    ("void (anonymous namespace)::elem_kernel<3>(uint4 const*, uint4 const*, "
     "uint4 const*, uint4*, int, unsigned int, int)", "plane_parts"),
    ("void (anonymous namespace)::plane_dot_kernel<1>(CUtensorMap const, "
     "CUtensorMap const, unsigned int, int, int)", "plane_parts"),
    ("(anonymous namespace)::peer_store((anonymous namespace)::StoreArgs)",
     "peer_permute"),
    ("(anonymous namespace)::peer_read((anonymous namespace)::ReadArgs)",
     "peer_permute"),
    ("void (anonymous namespace)::tensor_product_acc_kernel<false>(uint4 "
     "const*, uint4 const*, unsigned long, unsigned int const*, unsigned "
     "int const*, uint4*, unsigned long, int, unsigned long)",
     "tensor_product_acc"),
    ("void (anonymous namespace)::plain_mul_sum_kernel<3, false>((anonymous "
     "namespace)::Terms, unsigned int const*, uint4*, int, int, int, int, "
     "unsigned long)", "plain_mul_sum"),
]


@pytest.mark.parametrize("name, kernel", PROFILED, ids=[
    re.search(r"::(\w+)", n)[1] for n, _ in PROFILED])
def test_package_kernel_books_each_device_function(name, kernel):
    assert cuda_lib.package_kernel(name) == kernel


@pytest.mark.parametrize("name", [
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl"
    "_nocast<at::native::BinaryFunctor<long, long, long, at::native::binary"
    "_internal::MulFunctor<long> > >(at::TensorIteratorBase&, at::native::"
    "BinaryFunctor<long, long, long, at::native::binary_internal::MulFunctor"
    "<long> > const&)::{lambda(int)#1}>(int, at::native::gpu_kernel_impl"
    "_nocast<at::native::BinaryFunctor<long, long, long, at::native::binary"
    "_internal::MulFunctor<long> > >(at::TensorIteratorBase&, at::native::"
    "BinaryFunctor<long, long, long, at::native::binary_internal::MulFunctor"
    "<long> > const&)::{lambda(int)#1})",
    "void at::native::vectorized_elementwise_kernel<2, at::native::AUnary"
    "Functor<long, long, long, at::native::binary_internal::MulFunctor<long>"
    " >, std::array<char*, 2ul> >(int, at::native::AUnaryFunctor<long, long,"
    " long, at::native::binary_internal::MulFunctor<long> >, std::array"
    "<char*, 2ul>)",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy"
    "_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const"
    "::{lambda()#7}::operator()() const::{lambda(long)#1}, std::array<char*,"
    " 2ul>, 4, TrivialOffsetCalculator<1, unsigned int>, TrivialOffset"
    "Calculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
    "at::native::memory::StoreWithCast<1> >(int, at::native::direct_copy"
    "_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}::operator()() const"
    "::{lambda()#7}::operator()() const::{lambda(long)#1}, std::array<char*,"
    " 2ul>, TrivialOffsetCalculator<1, unsigned int>, TrivialOffset"
    "Calculator<1, unsigned int>, at::native::memory::LoadWithCast<1>, "
    "at::native::memory::StoreWithCast<1>)",
], ids=["elementwise", "vectorized_elementwise", "unrolled_elementwise"])
def test_package_kernel_books_torch_kernels_to_none(name):
    assert cuda_lib.package_kernel(name) is None


def test_launch_counters_keep_their_keys():
    names = ["ntt", "ntt_fwd_lifted", "ntt_fwd_fbc", "ntt_fwd_centered",
             "inner_product", "centered_fbc", "tensor_product", "ks_tail",
             "fbc_precise", "copy_planes", "muladd_u32", "dot_i8",
             "plane_parts", "peer_permute", "tensor_product_acc",
             "plain_mul_sum"]
    assert [k.name for k in cuda_lib.KERNELS] == names
    assert list(cuda_lib.launches) == list(cuda_lib.launch_bytes) == names
    rec = cuda_lib.Recorded()
    assert list(rec) == list(rec.nbytes) == names


def test_benchmark_reads_the_table_device_functions():
    """``hebench.trace.package_kernels`` finds every device function of
    the table in ``csrc/`` (the multiply-and-accumulate
    ``tensor_product_acc_kernel`` and the plaintext products' sum
    ``plain_mul_sum_kernel`` with the rest), and nothing else."""
    from hebench import trace
    names = trace.package_kernels(cuda_lib.CSRC)
    assert "tensor_product_acc_kernel" in names
    assert "plain_mul_sum_kernel" in names
    assert names == {f for k in cuda_lib.KERNELS for f in k.functions}


def test_cuda_lib_imports_no_module_above_it(tmp_path):
    """In a fresh interpreter ``import hetpu_torch.core.cuda_lib`` loads no
    other module of ``hetpu_torch.core``, and its only import from the
    port is ``utils.profiling``."""
    code = textwrap.dedent("""
        import sys
        import hetpu_torch.core.cuda_lib
        print(sorted(m for m in sys.modules
                     if m.startswith("hetpu_torch.core.")))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=dict(os.environ, PYTHONPATH=str(REPO)),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == \
        "['hetpu_torch.core.cuda_lib']"
    tree = ast.parse(Path(cuda_lib.__file__).read_text())
    ours = [(n.level, n.module) for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and (n.level or (
                n.module or "").startswith("hetpu_torch"))]
    assert ours == [(2, "utils.profiling")]


def test_reset_launches_clears_registered_counters():
    cuda_lib.launches["ntt"] += 1
    cuda_lib.launch_bytes["fbc_precise"] += 4
    rns.convert_bytes["fbc_apply"] += 8
    cuda_lib.reset_launches()
    assert not any(cuda_lib.launches.values())
    assert not any(cuda_lib.launch_bytes.values())
    assert rns.convert_bytes == {"fbc_apply": 0}
