"""The finishing chain on the device (twin of
:mod:`hmsr_tpu.finishing.device`), plain torch: the JAX package computes it
with XLA, not Pallas.

- colour correction : row-normalized CCM, clipped to [0, 1];
- unsharp mask      : separable Gaussian with scipy ``gaussian_filter``'s
                      radius ``int(4 sigma + 0.5)`` and nearest boundary
                      (``F.conv2d`` after replicate padding; TF32 is off,
                      :mod:`hmsr_tpu_torch`);
- devignette        : inverse cos^4 model;
- tonemap           : the smoothstep ``3x^2 - 2x^3`` (OpenCV's Mertens
                      fusion is the host chain's,
                      :mod:`hmsr_tpu_torch.finishing.raw2rgb`);
- gamma             : clip + ``x^(1/2.2)``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .raw2rgb import get_color_matrix


def _gauss_kernel(sigma):
    """scipy.ndimage.gaussian_filter kernel: radius int(4*sd + 0.5)."""
    lw = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-lw, lw + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32), lw


def gaussian_blur_nearest(img, sigma):
    """Per-channel separable Gaussian on (H, W, C), nearest boundary:
    ``scipy.ndimage.gaussian_filter(x, sigma, mode="nearest")`` per channel.
    Rows first, then columns, as the JAX twin."""
    k, lw = _gauss_kernel(sigma)
    kern = torch.as_tensor(k, device=img.device)
    x = img.permute(2, 0, 1)[:, None]                        # (C, 1, H, W)
    x = F.conv2d(F.pad(x, (0, 0, lw, lw), mode="replicate"),
                 kern.reshape(1, 1, 2 * lw + 1, 1))
    x = F.conv2d(F.pad(x, (lw, lw, 0, 0), mode="replicate"),
                 kern.reshape(1, 1, 1, 2 * lw + 1))
    return x[:, 0].permute(1, 2, 0)


def make_postprocess_device(do_color_correction=True, do_tonemapping=True,
                            do_gamma=True, sharpening_config=None,
                            do_devignette=False, xyz2cam=None):
    """Build an (H, W, 3) -> (H, W, 3) finishing function on tensors; it runs
    on the device of its input.

    ``do_tonemapping`` applies the smoothstep only (see the module doc).
    """
    cam2rgb = np.linalg.inv(get_color_matrix(xyz2cam)) if do_color_correction \
        else None
    sharpen = (sharpening_config is not None
               and sharpening_config.get("enabled", False))
    if sharpen:
        radius = sharpening_config.get("radius", 3)
        amount = sharpening_config.get("amount", 0.5)

    def fn(img):
        img = img.to(torch.float32)
        if cam2rgb is not None:
            m = torch.as_tensor(cam2rgb, device=img.device)
            img = torch.clamp(torch.einsum("ij,hwj->hwi", m, img), 0.0, 1.0)
        if sharpen:
            img = img + amount * (img - gaussian_blur_nearest(img, radius))
        if do_devignette:
            h, w, _ = img.shape
            vy = torch.abs(torch.linspace(-h / w * np.pi / 2, h / w * np.pi / 2, h,
                                          device=img.device))
            vx = torch.abs(torch.linspace(-np.pi / 2, np.pi / 2, w, device=img.device))
            vf = torch.outer(vy, vx)
            img = (2.0 - torch.cos(vf) ** 4)[:, :, None] * img
        if do_tonemapping:
            img = torch.clamp(img, 0.0, 1.0)
            img = 3.0 * img ** 2 - 2.0 * img ** 3
        img = torch.clamp(img, 0.0, 1.0)
        if do_gamma:
            img = img ** (1.0 / 2.2)
        return torch.clamp(img, 0.0, 1.0)

    return fn
