"""Final accumulator normalization: guarded divide + starved-pixel refill
(twin of :mod:`hmsr_tpu.ops.accumfix`).

Pixels whose accumulated weight is below ``STARVED_DEN`` are re-normalized
from the 5x5 neighbourhood sums of well-fed ``(num, den)``, twice. With
``refill_border=B`` the refill runs only on the four B-wide border strips,
each extracted with an 8-px margin, which is exact against the full-image
refill (starvation is a border phenomenon).
"""

import torch
import torch.nn.functional as F

from ..utils.types import EPSILON_DIV

STARVED_DEN = 1e-4
_ITERS = 2
REFILL_BORDER = 32
_REFILL_MARGIN = 8


def _box5(x):
    """Zero-padded 5x5 box sum over the last two dims ('SAME' window)."""
    h, w = x.shape[-2:]
    p = F.pad(x, (0, 0, 2, 2))
    r = p[..., 0:h, :] + p[..., 1:1 + h, :] + p[..., 2:2 + h, :] \
        + p[..., 3:3 + h, :] + p[..., 4:4 + h, :]
    p = F.pad(r, (2, 2))
    return p[..., 0:w] + p[..., 1:1 + w] + p[..., 2:2 + w] \
        + p[..., 3:3 + w] + p[..., 4:4 + w]


def _strip_image(num, den):
    """Full refill + guarded divide of one (extracted) region."""
    good = den > STARVED_DEN
    zero = torch.zeros((), dtype=num.dtype, device=num.device)
    n = torch.where(good, num, zero)
    d = torch.where(good, den, zero)
    for _ in range(_ITERS):
        bn = _box5(n)
        bd = _box5(d)
        n = torch.where(good, n, bn)
        d = torch.where(good, d, bd)
        good = d > STARVED_DEN
    return n / torch.clamp(d, min=EPSILON_DIV)


def normalize_accum(num, den, refill_border=None):
    """``(c, H, W)`` accumulators -> ``(c, H, W)`` image."""
    if refill_border is not None:
        B = int(refill_border)
        M = B + _REFILL_MARGIN
        h, w = num.shape[-2:]
        if h > 2 * M and w > 2 * M:
            img = num / torch.clamp(den, min=EPSILON_DIV)
            img[..., :B, :] = _strip_image(num[..., :M, :], den[..., :M, :])[..., :B, :]
            img[..., h - B:, :] = _strip_image(
                num[..., h - M:, :], den[..., h - M:, :])[..., M - B:, :]
            img[..., :, :B] = _strip_image(num[..., :, :M], den[..., :, :M])[..., :, :B]
            img[..., :, w - B:] = _strip_image(
                num[..., :, w - M:], den[..., :, w - M:])[..., :, M - B:]
            return img
    return _strip_image(num, den)
