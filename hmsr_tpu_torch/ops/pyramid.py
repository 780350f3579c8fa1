"""Gaussian pyramid (twin of :mod:`hmsr_tpu.ops.pyramid`, its per-tap slice
branch): valid separable correlation, then ``[::factor]`` subsampling; level
shapes shrink by the kernel support first; the list is returned coarse-first.

The blur is written as weighted strided slices rather than ``conv2d``, so no
cuDNN algorithm (TF32 or otherwise) decides the summation order.
"""

import numpy as np


def gaussian_kernel1d(sigma, radius):
    """Normalized order-0 Gaussian taps on [-radius, radius] (float32)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    phi /= phi.sum()
    return phi.astype(np.float32)


def downsample(img, factor):
    """Gaussian blur (sigma = 0.5 * factor) + decimation by ``factor``."""
    if factor == 1:
        return img
    radius = int(4 * factor * 0.5 + 0.5)
    taps = [float(t) for t in gaussian_kernel1d(sigma=factor * 0.5, radius=radius)]

    h, w = img.shape
    h2, w2 = (h - 2 * radius) // factor, (w - 2 * radius) // factor
    if h2 <= 0 or w2 <= 0:
        return img.new_zeros((max(h2, 0), max(w2, 0)))

    out = None
    for t, tap in enumerate(taps):
        v = img[t:t + (h2 - 1) * factor + 1:factor, :]
        out = tap * v if out is None else out + tap * v
    out2 = None
    for t, tap in enumerate(taps):
        v = out[:, t:t + (w2 - 1) * factor + 1:factor]
        out2 = tap * v if out2 is None else out2 + tap * v
    return out2


def build_gaussian_pyramid(image, factors):
    """The coarse-first Gaussian pyramid for the given factor chain."""
    pyramid = [downsample(image, factors[0])]
    for factor in factors[1:]:
        pyramid.append(downsample(pyramid[-1], factor))
    return pyramid[::-1]
