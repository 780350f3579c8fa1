"""The raw ingestion hot loop on the card (twin of
:mod:`hmsr_tpu.io.native_loader`, the JAX package's g++/ctypes host loader):
per-CFA black-level subtraction, normalisation and white-balance gains
(K8), and MIPI RAW10/RAW12 unpacking (K9), both hand-written kernels of
``csrc/ingest.cu`` (:mod:`hmsr_tpu_torch.ops.cuda_ingest`).

On the card the raw stack is uploaded as uint16 (half the bytes of the
float32 it becomes) and normalized there; on ``"cpu"`` the kernels' plain
versions run, bit for bit the same. There is no fallback: ``device="cuda"``
without a card raises (:func:`~hmsr_tpu_torch.utils.types.resolve_device`),
and a failed build or launch raises. The JAX package's ``threads`` argument
has no counterpart: the card needs none.
"""

import numpy as np
import torch

from ..ops import _build, cuda_ingest
from ..utils.types import resolve_device


def have_native():
    """True where a CUDA device is present and the port's kernel library
    loads (built on first use)."""
    if not torch.cuda.is_available():
        return False
    try:
        _build.library()
    except (OSError, RuntimeError):
        return False
    return True


def _tensor(array, dtype, device):
    """``array`` (numpy or a tensor of ``dtype``) as a tensor on ``device``."""
    if isinstance(array, torch.Tensor):
        if array.dtype != dtype:
            raise TypeError(f"expected {dtype}, got {array.dtype}")
        return array.to(device)
    np_dtype = {torch.uint16: np.uint16, torch.uint8: np.uint8}[dtype]
    return torch.from_numpy(np.ascontiguousarray(array, dtype=np_dtype)).to(device)


def normalize_burst(frames_u16, cfa, black_levels, white_level, white_balance,
                    device="cuda"):
    """uint16 ``(n, h, w)`` raw stack (numpy, or a uint16 tensor) ->
    normalized float32 ``(n, h, w)`` on ``device``:
    ``(in - black[c]) / (white - black[c]) * wb[c] / wb[1]`` with c the CFA
    channel at (y % 2, x % 2), computed as ``(in - black[c]) * gain[c]``
    with the gains in numpy float32 on the host, as the JAX package does."""
    device = resolve_device(device)
    frames = _tensor(frames_u16, torch.uint16, device)
    return cuda_ingest.normalize_bayer(
        frames, *normalization(cfa, black_levels, white_level, white_balance))


def normalization(cfa, black_levels, white_level, white_balance):
    """``(cfa, black, gain)``: the 4 CFA channel ids and the per-channel
    float32 blacks and gains, computed in numpy as the JAX package does."""
    cfa = np.asarray(cfa, dtype=np.int32).reshape(4)
    nc = int(cfa.max()) + 1
    black = np.asarray(black_levels, dtype=np.float32)[:nc]
    wb = np.asarray(white_balance, dtype=np.float32)
    gain = (wb[:nc] / wb[1]) / (float(white_level) - black)
    return cfa, black, gain


def _packed(packed, device):
    if device is None:
        device = packed.device if isinstance(packed, torch.Tensor) else "cuda"
    return _tensor(packed, torch.uint8, resolve_device(device))


def unpack_raw10(packed, n_pixels, device=None):
    """MIPI RAW10 packed bytes (uint8) -> ``n_pixels`` uint16 pixels
    (``n_pixels`` a multiple of 4) on ``device``: None takes the packed
    tensor's device, and the card for a numpy array."""
    return cuda_ingest.unpack_raw(_packed(packed, device), n_pixels, 10)


def unpack_raw12(packed, n_pixels, device=None):
    """MIPI RAW12 packed bytes (uint8) -> ``n_pixels`` uint16 pixels
    (``n_pixels`` a multiple of 2), on ``device`` as :func:`unpack_raw10`."""
    return cuda_ingest.unpack_raw(_packed(packed, device), n_pixels, 12)
