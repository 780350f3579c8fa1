"""Dtype policy and the device convention of the port.

float32 everywhere on the compute path, as in :mod:`hmsr_tpu.utils.types`.

The entry points (``make_pipeline``, ``process``, ``process_arrays``,
``process_burst``) run on the card unless the caller asks for the CPU: their
``device`` defaults to ``"cuda"``. Other functions derive the device from
their tensor inputs. There is no automatic pick: asking for CUDA on a host
without it raises instead of running on the CPU.
"""

import torch

DEFAULT_FLOAT = torch.float32

# Guard used by the analytic 2x2 inversions (reference utils.py:21).
EPSILON_DIV = 1e-10


def resolve_device(device):
    """``torch.device`` for ``device``; raises if it names CUDA and none is
    available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           f"available on this host")
    return device
