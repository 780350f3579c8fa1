"""P1 (per-block fixed cost) and P2 (row-block sum): CUDA probe wrappers and
their plain PyTorch versions.

Counterparts of the JAX package's TPU probes ``tools/probe_program_cost.py``
(P1) and ``tools/probe_l2ica3.py:trivial_pallas_sum`` (P2); the kernels are
in ``csrc/probes.cu``, whose header says what bounds them. They compute
nothing of the pipeline: :mod:`hmsr_tpu_torch.probe_cta_cost` drives them.
A wrapper launches its kernel for CUDA tensors and runs the plain version
only for CPU tensors; ``cta_probe.launches`` and ``row_block_sum.launches``
count kernel launches.
"""

import torch
import torch.nn.functional as F

from . import _build

#: threads of a P1 block (``PROBE_THREADS`` in ``csrc/probes.cu``)
PROBE_THREADS = 128
#: P1 bodies: the kernel's ``kind`` code
KINDS = {"empty": 0, "stage": 1, "chain": 2}
MAX_STAGE = 12 * 1024        # floats a stage body may hold (48 KB)


def _input_size(kind, n_blocks, n):
    return {"empty": 1, "stage": n_blocks * n, "chain": n_blocks * PROBE_THREADS}[kind]


def probe_input(kind, n_blocks, n, device):
    """The input a body reads: nothing (empty), ``n`` floats per block
    (stage), one float per thread (chain); ramps of distinct values."""
    return torch.arange(_input_size(kind, n_blocks, n), device=device,
                        dtype=torch.float32) * 1e-6


def cta_probe_plain(kind, x, n, n_blocks):
    """Plain version of P1: what each body writes."""
    if kind == "empty":
        return torch.arange(n_blocks, device=x.device, dtype=torch.float32)
    if kind == "stage":
        return x.view(n_blocks, n)[:, n - 1].clone()
    y = x.clone()
    for _ in range(n):
        y = y * 1.000001 + 0.000001
    return y


def cta_probe(kind, x, n, n_blocks):
    """P1: one launch of ``n_blocks`` blocks of the ``kind`` body ("empty",
    "stage" with ``n`` floats per block, "chain" of ``n`` multiply-adds) on
    ``x`` from :func:`probe_input`; returns what the body writes."""
    _build.check_arg(kind in KINDS, f"unknown probe body {kind!r}")
    _build.check_arg(x.dtype == torch.float32 and x.is_contiguous()
                     and x.numel() == _input_size(kind, n_blocks, n),
                     f"{kind} probe: input {tuple(x.shape)} {x.dtype}")
    _build.check_arg(kind != "stage" or 1 <= n <= MAX_STAGE, f"stage of {n} floats")
    if x.device.type == "cpu":
        return cta_probe_plain(kind, x, n, n_blocks)
    _build.require_cuda(x.device)
    out = torch.empty(n_blocks * (PROBE_THREADS if kind == "chain" else 1),
                      device=x.device, dtype=torch.float32)
    code = _build.library().hmsr_cta_probe(KINDS[kind], _build.ptr(x), n,
                                           _build.ptr(out), n_blocks,
                                           _build.stream_of(x))
    _build.check(code, "hmsr_cta_probe")
    cta_probe.launches += 1
    return out


cta_probe.launches = 0


def row_block_sum_plain(x):
    """Plain version of P2: the sum of each 8-row block of ``x`` (h, w)."""
    h, w = x.shape
    return F.pad(x, (0, 0, 0, -h % 8)).view(-1, 8 * w).sum(1)


def row_block_sum(x):
    """P2: the sum of each 8-row block of the float32 (h, w) array ``x``
    (the last block may hold fewer rows); returns ``(ceil(h / 8),)``."""
    _build.check_f32("x", x, 2, x.device)
    if x.device.type == "cpu":
        return row_block_sum_plain(x)
    _build.require_cuda(x.device)
    _build.check_arg(x.is_contiguous(), "x must be contiguous")
    h, w = x.shape
    out = torch.empty(-(-h // 8), device=x.device, dtype=torch.float32)
    code = _build.library().hmsr_row_block_sum(_build.ptr(x), h, w, _build.ptr(out),
                                               _build.stream_of(x))
    _build.check(code, "hmsr_row_block_sum")
    row_block_sum.launches += 1
    return out


row_block_sum.launches = 0
