"""The card's published peaks and the least time a piece of work could take.

NVIDIA H100 SXM data sheet, dense rates: 3.35 TB/s of HBM3, 67 TFLOP/s of
float32 outside the tensor cores, both at the full 700 W power limit.
"""

import subprocess

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12


def least_seconds(nbytes, flops):
    """The larger of moving ``nbytes`` of device memory and doing ``flops``
    float32 operations at the peaks."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS)


def card():
    """The first card's name and power limit as ``nvidia-smi`` reads them,
    or None where it cannot be run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None
