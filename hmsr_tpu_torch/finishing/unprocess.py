"""The inverse ISP for data generation (twin of
:mod:`hmsr_tpu.finishing.unprocess`): a JPEG-domain RGB image becomes a
synthetic linear camera-RGB image and its metadata.

Random CCM (a convex combination of four cameras' xyz2cam matrices), random
gains and noise levels from the published log-log model, inverse
smoothstep, gamma expansion, the RGB -> camera CCM and the safe inversion of
the gains. The draws and the 3x3 matrices stay on the host and take explicit
generators (``rng``: :class:`random.Random`, ``np_rng``:
:class:`numpy.random.RandomState`) where the JAX package's module draws
from the global ``random`` and ``np.random``: seeded alike, both draw the
same numbers. The per-pixel work is torch, on the image's device and in its
dtype; it divides by tensors, since on the card torch divides by a Python
float through its rounded reciprocal.
"""

import math

import numpy as np
import torch

from .raw2rgb import RGB2XYZ

XYZ2CAMS = [[[1.0234, -0.2969, -0.2266],
             [-0.5625, 1.6328, -0.0469],
             [-0.0703, 0.2188, 0.6406]],
            [[0.4913, -0.0541, -0.0202],
             [-0.613, 1.3513, 0.2906],
             [-0.1564, 0.2151, 0.7183]],
            [[0.838, -0.263, -0.0639],
             [-0.2887, 1.0725, 0.2496],
             [-0.0627, 0.1427, 0.5438]],
            [[0.6596, -0.2079, -0.0562],
             [-0.4782, 1.3016, 0.1933],
             [-0.097, 0.1581, 0.5181]]]


def get_random_ccm(np_rng):
    """Random RGB -> camera CCM (a convex combination of the cameras'
    matrices), numpy float64 (3, 3) with rows summing to 1."""
    weights = np_rng.rand(len(XYZ2CAMS), 1, 1)
    xyz2cam = (np.asarray(XYZ2CAMS) * weights).sum(axis=0) / weights.sum()
    rgb2cam = xyz2cam @ RGB2XYZ
    return rgb2cam / rgb2cam.sum(axis=-1, keepdims=True)


def get_random_noise_parameters(rng, log_min_shot=0.0001, log_max_shot=0.012,
                                sigma_read_noise=0.26):
    """Random (shot, read) noise levels from the log-log linear model."""
    log_shot = rng.uniform(math.log(log_min_shot), math.log(log_max_shot))
    shot_noise = math.exp(log_shot)
    log_read = 2.18 * log_shot + 1.20 + rng.gauss(0.0, sigma_read_noise)
    return shot_noise, math.exp(log_read)


def get_random_gains(rng):
    """Random brightening and white-balance gains ``(rgb, red, blue)``."""
    rgb_gain = 1.0 / rng.gauss(0.8, 0.1)
    red_gain = rng.uniform(1.9, 2.4)
    blue_gain = rng.uniform(1.5, 1.9)
    return rgb_gain, red_gain, blue_gain


def _gains(image, values):
    """Per-channel gains (computed in float64 on the host) as a (1, 1, c)
    tensor in the image's dtype, on its device."""
    return torch.as_tensor(np.asarray(values), dtype=image.dtype,
                           device=image.device).reshape(1, 1, -1)


def _check_rgb(image, channels=(3,)):
    if image.ndim != 3 or image.shape[-1] not in channels:
        raise ValueError(f"expected an (H, W, {'|'.join(map(str, channels))}) "
                         f"image, got {tuple(image.shape)}")


def safe_invert_gains(image, red_gain, blue_gain, rgb_gain):
    """Invert the gains of an (H, W, 3) image, smoothly protecting
    near-white pixels (grey level above 0.9)."""
    _check_rgb(image)
    gains = _gains(image, np.array([1.0 / red_gain, 1.0, 1.0 / blue_gain]) / rgb_gain)
    gray = torch.mean(image, dim=-1, keepdim=True)
    inflection = 0.9
    span = torch.as_tensor(1.0 - inflection, dtype=image.dtype, device=image.device)
    mask = (torch.clamp(gray - inflection, min=0.0) / span) ** 2
    safe_gains = torch.maximum(mask + (1.0 - mask) * gains, gains)
    return image * safe_gains


def apply_gains(image, red_gain, blue_gain, rgb_gain):
    """Apply the white-balance and brightness gains to an (H, W, 3) RGB or
    (H, W, 4) RGGB image, clipped to [0, 1]."""
    _check_rgb(image, (3, 4))
    greens = [1.0] if image.shape[-1] == 3 else [1.0, 1.0]
    gains = _gains(image, np.array([red_gain, *greens, blue_gain]) * rgb_gain)
    return torch.clamp(image * gains, 0.0, 1.0)


def invert_smoothstep(image):
    """The inverse of the smoothstep tone curve ``3x^2 - 2x^3`` on [0, 1]."""
    image = torch.clamp(image, 0.0, 1.0)
    three = torch.as_tensor(3.0, dtype=image.dtype, device=image.device)
    return 0.5 - torch.sin(torch.asin(1.0 - 2.0 * image) / three)


def gamma_expansion(img, gamma=2.2):
    return torch.clamp(img, 1e-8, 1.0) ** gamma


def unprocess_isp(jpg, rng, np_rng, log_max_shot=0.012):
    """JPEG-domain (H, W, 3) tensor -> ``(raw, metadata)``: the synthetic
    linear camera-RGB tensor (on ``jpg``'s device, in its dtype) and the
    draws (``rgb2cam``, ``cam2rgb`` numpy float64, gains and noise levels as
    floats). Draws in the JAX package's order: the CCM, the gains, the noise
    levels."""
    rgb2cam = get_random_ccm(np_rng)
    cam2rgb = np.linalg.inv(rgb2cam)
    rgb_gain, red_gain, blue_gain = get_random_gains(rng)
    lambda_shot, lambda_read = get_random_noise_parameters(
        rng, log_max_shot=log_max_shot)
    metadata = {"rgb2cam": rgb2cam, "cam2rgb": cam2rgb, "rgb_gain": rgb_gain,
                "red_gain": red_gain, "blue_gain": blue_gain,
                "lambda_shot": lambda_shot, "lambda_read": lambda_read}

    img = gamma_expansion(invert_smoothstep(jpg))
    ccm = torch.as_tensor(rgb2cam, dtype=jpg.dtype, device=jpg.device)
    raw = torch.einsum("ij,hwj->hwi", ccm, img)
    raw = safe_invert_gains(raw, red_gain, blue_gain, rgb_gain)
    return raw, metadata
