"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all
started together), and the objects are linked into one shared library with a
plain C interface, loaded with ``ctypes``. The build happens
at first use (never at import), into ``build/hmsr_kernels/`` at the root of
the checkout, which ``.gitignore`` lists; the library's file name carries a
hash of the sources and flags, so an edited source is rebuilt. Without
``--use_fast_math``: parity with the plain versions needs IEEE ``expf`` and
division. With ``-fmad=false``: every multiply and add rounds once, as the
plain versions' elementwise torch ops do; a contracted FMA changes the merge
weights' quadratic form ``d^T Omega^-1 d`` and the covariance determinant,
both differences of large terms for anisotropic kernels, by more than the
1e-5 the kernels are held to.

With ``-Xptxas -v``: ptxas reports each kernel's registers, shared memory
and spills; the build keeps that report beside the library
(``libhmsr_kernels_<hash>.ptxas.txt``) and :func:`ptxas_report` parses it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hmsr_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: argtypes of every C entry point (pointers and the stream as c_void_p,
#: floats as c_float).
SIGNATURES = {
    "hmsr_block_match": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I,
                         _I, _P, _P],
    "hmsr_ica_steps": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P,
                       _P],
    "hmsr_ica_fused": [_P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                       _P, _P],
    "hmsr_ica_layout": [_I, _I, _I, _P],
    "hmsr_upscale_warp": [_P, _I, _I, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "hmsr_warp_layout": [_I, _I, _I, _P],
    "hmsr_bm_layout": [_I, _I, _I, _I, _P],
    "hmsr_merge": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                   _I, _I, _I, _I, _I, _P],
    "hmsr_merge_burst": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _I, _P],
    "hmsr_merge_layout": [_I, _I, _I, _I, _I, _P],
    "hmsr_merge_fused": [_P, _I, _I, _I, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P,
                         _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "hmsr_cta_probe": [_I, _P, _I, _P, _I, _P],
    "hmsr_row_block_sum": [_P, _I, _I, _P, _P],
}

_lib = None
build_seconds = None
#: paths of the loaded library and of its kept ptxas report
library_path = None
ptxas_log = None


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")
    return path


def library():
    """The loaded kernel library, built on first call."""
    global _lib, build_seconds, library_path, ptxas_log
    if _lib is not None:
        return _lib
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"libhmsr_kernels_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}"
        nvcc = _nvcc()
        cus = [s for s in srcs if s.endswith(".cu")]
        objs = [f"{tmp}.{os.path.basename(s)}.o" for s in cus]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", s, "-o", o] for s, o in zip(cus, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for c in cmds]
        outs = [p.communicate() for p in procs]
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", f"{tmp}.tmp", *objs]
        try:
            for cmd, p, (out, err) in zip(cmds, procs, outs):
                _check_run(cmd, p.returncode, out, err)
            res = subprocess.run(link, capture_output=True, text=True)
            _check_run(link, res.returncode, res.stdout, res.stderr)
            with open(f"{tmp}.ptxas", "w") as f:
                f.write("".join(out + err for out, err in outs))
            os.replace(f"{tmp}.ptxas", so[:-3] + ".ptxas.txt")
            os.replace(f"{tmp}.tmp", so)
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_seconds = time.perf_counter() - t0
    library_path, ptxas_log = so, so[:-3] + ".ptxas.txt"
    _lib = lib
    return lib


def ptxas_report(text):
    """``{kernel: {"registers", "smem_bytes", "spill_stores", "spill_loads",
    "stack_bytes"}}`` from ``-Xptxas -v`` output, by the kernels' base
    names (:func:`demangle`), with their template arguments where a kernel
    has several instantiations (``bm_kernel<16,4,1>``)."""
    out, name, sym, props = {}, None, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            sym, name = m.group(1), kernel_name(m.group(1))
            out[name] = {}
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == sym:
            out[name].update(stack_bytes=int(m.group(1)), spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[name]["smem_bytes"] = int(m.group(1)) if m else 0
    bases = [k.split("<")[0] for k in out]
    return {(k.split("<")[0] if bases.count(k.split("<")[0]) == 1 else k): v
            for k, v in out.items()}


def demangle(sym):
    """Base name of an Itanium-mangled function symbol (``_Z12merge_kernelPKf...``
    -> ``merge_kernel``); other symbols as they are."""
    m = re.match(r"_Z(\d+)(\w+)", sym)
    return m.group(2)[:int(m.group(1))] if m else sym


def kernel_name(sym):
    """:func:`demangle` with integer template arguments
    (``_Z9bm_kernelILi16ELi4ELi1EEvPKf...`` -> ``bm_kernel<16,4,1>``)."""
    base = demangle(sym)
    m = re.match(r"_Z\d+" + re.escape(base) + r"I((?:Lin?\d+E)+)E", sym)
    if not m:
        return base
    args = re.findall(r"Li(n?)(\d+)E", m.group(1))
    return base + "<" + ",".join(("-" if neg else "") + v for neg, v in args) + ">"


def _check_run(cmd, returncode, stdout, stderr):
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{stdout}\n{stderr}")


def check(code, name):
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_of(t):
    """The current CUDA stream of tensor ``t``'s device, as a pointer."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def check_arg(cond, msg):
    if not cond:
        raise ValueError(msg)


def check_f32(name, t, ndim, device):
    check_arg(t.dtype == torch.float32, f"{name}: expected float32, got {t.dtype}")
    check_arg(t.dim() == ndim, f"{name}: expected {ndim}-D, got {tuple(t.shape)}")
    check_arg(t.device == device, f"{name}: on {t.device}, expected {device}")


def require_cuda(device):
    """Wrappers run their kernel only on CUDA tensors; anything that is
    neither CPU nor CUDA is refused."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
