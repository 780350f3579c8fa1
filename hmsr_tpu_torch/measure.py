"""What the port's scripts on the card share: the card's name and power
limit, device-time and host-time measurement, and the least time a piece of
work could take on an H100 SXM (``chip_smoke.py``,
:mod:`hmsr_tpu_torch.probe_cta_cost`, :mod:`hmsr_tpu_torch.profile_burst`).

A kernel's time is its device time alone. CUDA events around one wrapper
call measure mostly the host: between the events the card waits while the
wrapper checks its arguments, allocates and enqueues (about 80-160 us per
call), which is more than most alignment kernels run. :func:`timed`
therefore holds the stream with a spin kernel until ``n`` calls are
enqueued, then times the ``n`` back-to-back calls between two events, and
reports the host's enqueue time per call as a number of its own.
"""

import subprocess
import time
from typing import NamedTuple

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores


def card():
    """The first card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


class Timing(NamedTuple):
    ms: float           # ms per call between the events
    host_us: float      # host us per call: enqueue time, not synchronised


#: spin-kernel clock cycles per millisecond, about the H100's SM clock; the
#: hold is checked against the events, not against this number
SPIN_CYCLES_PER_MS = 2_000_000
#: holds a timing may take, each twice the last, before it gives up
HOLD_TRIES = 4


def timed(fn, n=10, hold=True):
    """Time per call of ``fn()`` on the card, after one warm-up call, and
    the host's enqueue time per call (the host clock around ``n`` calls
    that are not synchronised).

    ``hold``: a spin kernel holds the stream until all ``n`` calls are
    enqueued, so the ``n`` calls run back to back and the events between
    them measure device time alone; a hold that ends before the host has
    enqueued them is doubled and run again, and after
    :data:`HOLD_TRIES` such holds this raises. Without ``hold`` (plain
    versions of thousands of launches, whose launch queue fills) the events
    around ``n`` calls include the card's waits for the host."""
    def calls():
        for _ in range(n):
            fn()

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    hold_ms = 2 * host_ms + 1.0
    for _ in range(HOLD_TRIES if hold else 1):
        e0, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        e0.record()
        if hold:
            torch.cuda._sleep(int(hold_ms * SPIN_CYCLES_PER_MS))
        a.record()
        t0 = time.perf_counter()
        calls()
        enqueue_ms = 1e3 * (time.perf_counter() - t0)
        b.record()
        torch.cuda.synchronize()
        if not hold or enqueue_ms + 0.05 < e0.elapsed_time(a):
            return Timing(a.elapsed_time(b) / n, 1e3 * host_ms / n)
        hold_ms *= 2
    raise RuntimeError(f"{n} calls took {enqueue_ms:.2f} ms to enqueue, longer than "
                       f"a hold of {e0.elapsed_time(a):.2f} ms")


def bound(nbytes, flops):
    """(ms, "bytes" | "operations"): the least time the card could take to
    move ``nbytes`` of device memory and do ``flops`` float32 operations."""
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return 1e3 * max(t_mem, t_ops), "bytes" if t_mem >= t_ops else "operations"
