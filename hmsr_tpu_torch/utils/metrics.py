"""Image comparison metrics, RMSE and PSNR (twin of
:mod:`hmsr_tpu.utils.metrics`): NumPy in float64, on float images in [0, 1].
Tensors are read back to the host first."""

import numpy as np
import torch


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else x


def compute_rmse(image1, image2):
    """Root mean square error between two same-shaped images."""
    image1 = np.asarray(_host(image1), dtype=np.float64)
    image2 = np.asarray(_host(image2), dtype=np.float64)
    assert image1.shape == image2.shape, "images have different sizes"
    err = image1 - image2
    return float(np.sqrt(np.mean(err * err)))


def compute_psnr(image, noisy_image, max_value=1.0):
    """Peak signal-to-noise ratio between a clean and a noisy image; None
    for different shapes, inf for equal images."""
    image = np.asarray(_host(image), dtype=np.float64)
    noisy_image = np.asarray(_host(noisy_image), dtype=np.float64)
    if image.shape != noisy_image.shape:
        return None
    mse = np.mean((image - noisy_image) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(max_value ** 2 / mse))
