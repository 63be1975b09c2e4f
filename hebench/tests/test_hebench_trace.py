"""The trace reader on a hand-made Chrome trace, and the program's kernel
names read from its CUDA sources."""

from pathlib import Path

from hebench import trace as tr

ROOT = Path(__file__).resolve().parents[2]


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_parse_spans_kernels_and_gaps():
    ev = [_x("user_annotation", "request", 0, 100),
          _x("user_annotation", "evaluate", 10, 50),
          _x("user_annotation", "download", 70, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
          _x("cuda_runtime", "cudaLaunchKernel", 20, 2, correlation=2),
          _x("cuda_runtime", "cudaMemcpyAsync", 72, 2, correlation=3),
          _x("kernel", "void ntt_kernel<8, true>(int)", 15, 10,
             correlation=1),
          _x("kernel", "void at::native::elementwise_kernel<4>()", 30, 20,
             correlation=2),
          _x("gpu_memcpy", "Memcpy DtoH", 80, 10, correlation=3),
          _x("user_annotation", "other", 0, 5)]
    t = tr.parse(ev, calls=1, units=4, package=frozenset({"ntt_kernel"}))
    assert [o.span for o in t.ops] == ["evaluate", "evaluate", "download"]
    assert [t.is_package(k) for k in t.kernels] == [True, False]
    assert t.window_s == 100e-6 and t.busy_s == 40e-6
    assert [g[1] for g in t.gaps[:2]] == ["evaluate", "request"]
    assert abs(sum(g[0] for g in t.gaps) - 60e-6) < 1e-12
    b = tr.breakdown(t)
    assert b["device_ops"][0][0].startswith("void at::native")
    assert len(b["idle_gaps"]) == len(t.gaps)


def test_package_kernel_names():
    names = tr.package_kernels(ROOT / "hetpu_torch" / "csrc")
    assert {"ntt_kernel", "lifted_kernel", "fbc_kernel", "centered_kernel",
            "ip_kernel", "tensor_product_kernel", "ks_tail_kernel"} <= names
    k = tr.Op("void (anonymous namespace)::centered_fbc_kernel<1>()",
              "kernel", 0, 1)
    t = tr.Trace([k], [], 1, 1, 1, 1, names)
    assert t.is_package(k)
    plain = tr.Op("void at::native::vectorized_elementwise_kernel<4>()",
                  "kernel", 0, 1)
    assert not t.is_package(plain)
