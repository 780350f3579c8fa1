"""What the port's scripts on the card share: the card's name and power
limit, CUDA-event timing, and the least time a piece of work could take on
an H100 SXM (``chip_smoke.py``, :mod:`hmsr_tpu_torch.probe_cta_cost`,
:mod:`hmsr_tpu_torch.profile_burst`)."""

import statistics
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores


def card():
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def timed(fn, n=5):
    """Median milliseconds of ``fn()`` on the card (CUDA events, 1 warm-up)."""
    fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` of device memory and do ``flops`` float32 operations."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"
