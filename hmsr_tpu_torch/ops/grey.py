"""Raw (CFA) -> grey conversions (twin of :mod:`hmsr_tpu.ops.grey`).

Only the FFT low-pass and the 2x2 decimation are ported; the circulant,
Cooley-Tukey and matmul variants of the JAX package exist only for the TPU.
"""

import functools

import numpy as np
import torch

from ..utils.types import DEFAULT_FLOAT


def _lowpass_mask(h, w):
    """Binary keep-mask replicating the reference's slice-zeroing exactly:
    ``-h//4`` is ``(-h)//4`` (floor), so the band is asymmetric for sizes that
    are not multiples of 4."""
    my = np.ones((h, 1), dtype=np.float32)
    mx = np.ones((1, w), dtype=np.float32)
    my[: h // 4] = 0.0
    my[-h // 4:] = 0.0
    mx[:, : w // 4] = 0.0
    mx[:, -w // 4:] = 0.0
    return my * mx


@functools.lru_cache(maxsize=4)
def _half_plane_mask(h, w, device):
    """Unshifted, Hermitian-symmetrized mask on the rfft half-plane, on
    ``device``: for real input ``Re ifft2(M fft2 x) = irfft2(Msym rfft2 x)``
    with ``Msym = (M(k) + M(-k)) / 2``. Cached per size and device: built on
    the host it costs ~0.1 s at 12 MP, per frame otherwise."""
    m_u = np.fft.ifftshift(_lowpass_mask(h, w))
    m_sym = 0.5 * (m_u + m_u[np.ix_((-np.arange(h)) % h, (-np.arange(w)) % w)])
    return torch.as_tensor(m_sym[:, : w // 2 + 1].astype(np.float32), device=device)


def fft_lowpass_grey(img):
    """Low-pass grey image via spectral masking (Alg. 3)."""
    h, w = img.shape
    mask = _half_plane_mask(h, w, img.device)
    spec = torch.fft.rfft2(img.to(DEFAULT_FLOAT))
    return torch.fft.irfft2(spec * mask, s=(h, w)).to(DEFAULT_FLOAT)


def decimate_to_grey(img):
    """2x2 mean over each Bayer quad -> (h/2, w/2) grey image.

    Summed in the order ((q00 + q01) + q10) + q11, the reference's, on every
    device (a reduction kernel's order is its own).
    """
    h, w = img.shape
    q = img[: (h // 2) * 2, : (w // 2) * 2].to(DEFAULT_FLOAT)
    return (((q[0::2, 0::2] + q[0::2, 1::2]) + q[1::2, 0::2]) + q[1::2, 1::2]) / 4.0


def compute_grey_image(img, method):
    """Dispatch on the config's grey method name."""
    if method == "FFT":
        return fft_lowpass_grey(img)
    if method == "decimating":
        return decimate_to_grey(img)
    raise NotImplementedError(f"Unknown grey method {method}")
