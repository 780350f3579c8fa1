"""The port's probes P1 and P2 (plain versions on CPU tensors), the kernel
name matching of ``profile_burst`` and the ptxas report parser.

P2's plain version is held to the JAX probe's arithmetic (the sum of each
8-row block of the zero-padded array, ``tools/probe_l2ica3.py``) in numpy;
the JAX probe itself is a TPU Pallas kernel without an interpret switch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_port_helpers import kernel_counts, t  # noqa: E402

from hmsr_tpu_torch.ops import _build, cuda_probes  # noqa: E402
from hmsr_tpu_torch.profile_burst import kernel_base_name  # noqa: E402


@pytest.mark.parametrize("h,w", [(64, 96), (187, 250), (5, 7)])
def test_row_block_sum(h, w):
    x = np.random.RandomState(h).rand(h, w).astype(np.float32)
    xp = np.pad(x.astype(np.float64), ((0, -h % 8), (0, 0)))
    want = xp.reshape(-1, 8 * w).sum(1)
    got = cuda_probes.row_block_sum(t(x))
    assert got.shape == (-(-h // 8),)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert cuda_probes.row_block_sum.launches == 0


@pytest.mark.parametrize("kind,n", [("empty", 0), ("stage", 64), ("chain", 100)])
def test_cta_probe_plain(kind, n):
    """What each P1 body writes: the block index, the block's last staged
    float, the chain of n float32 multiply-adds (each rounded once)."""
    nb = 40
    x = cuda_probes.probe_input(kind, nb, n, "cpu")
    got = cuda_probes.cta_probe(kind, x, n, nb)
    if kind == "empty":
        want = np.arange(nb, dtype=np.float32)
    elif kind == "stage":
        want = x.numpy().reshape(nb, n)[:, -1]
    else:
        want = x.numpy().copy()
        for _ in range(n):
            want = want * np.float32(1.000001) + np.float32(0.000001)
    np.testing.assert_array_equal(got.numpy(), want)
    assert cuda_probes.cta_probe.launches == 0
    assert kernel_counts() == (0,) * 8


def test_probe_wrapper_checks():
    with pytest.raises(ValueError):
        cuda_probes.cta_probe("stage", torch.zeros(10), 3, 4)
    with pytest.raises(ValueError):
        cuda_probes.cta_probe("unknown", torch.zeros(1), 0, 4)
    with pytest.raises(ValueError):
        cuda_probes.row_block_sum(torch.zeros(8, 8, dtype=torch.float64))


@pytest.mark.parametrize("key,want", [
    ("merge_kernel(float const*, int, int, float const*, int)", "merge_kernel"),
    ("void merge_kernel<4>(float const*, int, int, float*, float*, int)", "merge_kernel"),
    ("void merge_burst_kernel<2>(float const*, int, int)", "merge_burst_kernel"),
    ("void ns::inner::bm_kernel<(int)2, float>(float const*)", "bm_kernel"),
    ("warp_kernel", "warp_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
     "at::detail::Array<char*, 1> >(int, at::native::FillFunctor<float>, "
     "at::detail::Array<char*, 1>)", "vectorized_elementwise_kernel"),
])
def test_profiler_kernel_names(key, want):
    """Profiler rows of templated or plain kernels match the bare names the
    per-stage table looks for."""
    assert kernel_base_name(key) == want


def test_ptxas_report():
    text = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z12merge_kernelILi4EEvPKfiiS1_iS1_iiS1_PfS2_iiiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z12merge_kernelILi4EEvPKfiiS1_iS1_iiS1_PfS2_iiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Function properties for __internal_expf_slowpath
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z9bm_kernelPKfiiiiS0_iiS0_iiiiiPfS1_' for 'sm_90a'
ptxas info    : Function properties for _Z9bm_kernelPKfiiiiS0_iiS0_iiiiiPfS1_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 38 registers, 1024 bytes smem, 420 bytes cmem[0]
"""
    rep = _build.ptxas_report(text)
    assert rep == {
        "merge_kernel": dict(registers=40, smem_bytes=0, stack_bytes=0, spill_stores=0,
                             spill_loads=0),
        "bm_kernel": dict(registers=38, smem_bytes=1024, stack_bytes=8, spill_stores=4,
                          spill_loads=4)}


@pytest.mark.parametrize("sym,want", [
    ("_Z9bm_kernelILi16ELi4ELi1EEvPKfiiiiS1_iiS1_iiiiPi", "bm_kernel<16,4,1>"),
    ("_Z9bm_kernelILi0ELi0ELi0EEvPKfiiiiS1_iiS1_iiiiPi", "bm_kernel<0,0,0>"),
    ("_Z11warp_kernelILi3EEvPKfiiS1_iiiiiiiPfPh", "warp_kernel<3>"),
    ("_Z12merge_kernelPKfiiS0_iS0_iiS0_PfS1_iiiiii", "merge_kernel"),
    ("_Z1fILin2EEvv", "f<-2>"),
])
def test_kernel_name(sym, want):
    """Integer template arguments of a mangled kernel symbol are kept."""
    assert _build.kernel_name(sym) == want


def test_ptxas_report_instantiations():
    """A kernel with several instantiations is reported per instantiation."""
    text = """ptxas info    : Compiling entry function '_Z11warp_kernelILi1EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z11warp_kernelILi1EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 30 registers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z11warp_kernelILi3EEvPKf' for 'sm_90a'
ptxas info    : Function properties for _Z11warp_kernelILi3EEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, 400 bytes cmem[0]
"""
    rep = _build.ptxas_report(text)
    assert sorted(rep) == ["warp_kernel<1>", "warp_kernel<3>"]
    assert rep["warp_kernel<3>"]["registers"] == 48


def _c_entry_points():
    """``{name: [parameter, ...]}`` of every ``extern "C"`` function in csrc."""
    import glob
    import os
    import re
    out = {}
    for path in sorted(glob.glob(os.path.join(_build.CSRC, "*.cu"))):
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', text):
            out[m.group(1)] = [p.strip() for p in m.group(2).split(",")]
    return out


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_c_entry_point(name):
    """Each ctypes signature has the C entry point's parameters, a pointer
    (c_void_p) where C takes one, a c_int where C takes an int and a
    c_float where C takes a float."""
    params = _c_entry_points()[name]
    want = [_build._P if "*" in p else _build._F if p.startswith("float ") else _build._I
            for p in params]
    assert [p for p in params
            if "*" not in p and not p.startswith(("int ", "float "))] == []
    assert _build.SIGNATURES[name] == want


def test_every_c_entry_point_has_a_signature():
    assert sorted(_c_entry_points()) == sorted(_build.SIGNATURES)
