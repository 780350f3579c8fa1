"""hmsr_tpu_torch — the Handheld Multi-frame Super-Resolution pipeline in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The port of :mod:`hmsr_tpu` (JAX/XLA/Pallas), which stays the reference it is
tested against. Plain tensor code is PyTorch; every Pallas kernel on the main
burst path is a CUDA C++ kernel under ``csrc/`` built with ``nvcc`` at first
use (``ops/_build.py``). Layouts at public functions match the JAX package:
flow ``(ny, nx, 2)`` in (x, y) order, covariances ``(3, gh, gw)``,
accumulators ``(n_ch, H*s, W*s)`` and the image ``(H*s, W*s, c)``.

The package imports neither JAX nor :mod:`hmsr_tpu`: it has its own
configuration tree (``configs.py``) and its own synthetic workload
(``synthetic.py``). The command line is ``python -m
hmsr_tpu_torch.run_handheld``.
"""

import torch

from .configs import default_config, load_yaml, merge, update  # noqa: F401

# float32 throughout: cuDNN convolutions and cuBLAS matmuls default to TF32
# on Hopper (about three decimal digits), which flips block-matching argmins.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def process(burst_path, config=None, device="cuda"):
    """Process a raw burst folder / bundle into an RGB image; returns
    ``(image, debug)`` on ``device`` (imported lazily, as the JAX package's
    ``process``)."""
    from .models.process import process as _process
    return _process(burst_path, config, device)
