"""Image gradient operators (twin of :mod:`hmsr_tpu.ops.gradients`)."""

import torch
import torch.nn.functional as F


def sobel_gradients(img):
    """(gradx, grady) with gradx[y, x] = img[y, x+1] - img[y, x-1], zero-padded."""
    px = F.pad(img, (1, 1, 0, 0))
    py = F.pad(img, (0, 0, 1, 1))
    gradx = px[:, 2:] - px[:, :-2]
    grady = py[2:, :] - py[:-2, :]
    return gradx, grady


def halfpixel_gradients(grey):
    """Half-pixel gradients, shape (H-1, W-1, 2) with [..., 0] = gx."""
    dx = 0.5 * (grey[:, 1:] - grey[:, :-1])
    gx = 0.5 * (dx[:-1, :] + dx[1:, :])
    ax = 0.5 * (grey[:, 1:] + grey[:, :-1])
    gy = 0.5 * (ax[1:, :] - ax[:-1, :])
    return torch.stack([gx, gy], dim=-1)
