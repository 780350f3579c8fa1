"""Final accumulator normalization: guarded divide + starved-pixel refill
(twin of :mod:`hmsr_tpu.ops.accumfix`).

Pixels whose accumulated weight is below ``STARVED_DEN`` are re-normalized
from the 5x5 neighbourhood sums of well-fed ``(num, den)``, twice. With
``refill_border=B`` the refill runs only on the four B-wide border strips,
each extracted with an 8-px margin, which is exact against the full-image
refill where starvation is a border phenomenon (the scan, chunked and
vmapped pipelines). The fused pipeline's merges normalize per group
instead (:func:`normalize_groups`): each B-row slab
(``models/merge_slab.py``) or each (B, B) tile (``models/merge_fused.py``)
gets the full refill, interior included, with zero context past its edges.
On the card both are K7, which these functions' operations define bit for
bit: :func:`hmsr_tpu_torch.ops.cuda_merge.refill_groups` per group and
:func:`hmsr_tpu_torch.ops.cuda_merge.refill_image` for the border strips,
which it computes as :func:`normalize_border_whole` formulates them.
"""

import torch
import torch.nn.functional as F

from ..utils.types import EPSILON_DIV

STARVED_DEN = 1e-4
_ITERS = 2
REFILL_BORDER = 32
_REFILL_MARGIN = 8
#: tile rows normalized together by normalize_groups
_GROUP_TILE_ROWS = 16


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


def strip_width(shape, refill_border):
    """The width B of the border strips that ``normalize_accum(...,
    refill_border=B)`` keeps the refill to on an image of ``shape`` (its
    last two entries); None where it refills everywhere: no
    ``refill_border``, or a side of ``2 (B + 8)`` or less (no distinct
    strips)."""
    if refill_border is None:
        return None
    B = int(refill_border)
    M = B + _REFILL_MARGIN
    h, w = shape[-2:]
    return B if h > 2 * M and w > 2 * M else None


def normalize_accum(num, den, refill_border=None):
    """``(c, H, W)`` accumulators -> ``(c, H, W)`` image."""
    B = strip_width(num.shape, refill_border)
    if B is not None:
        M = B + _REFILL_MARGIN
        h, w = num.shape[-2:]
        img = num / torch.clamp(den, min=EPSILON_DIV)
        img[..., :B, :] = _strip_image(num[..., :M, :], den[..., :M, :])[..., :B, :]
        img[..., h - B:, :] = _strip_image(
            num[..., h - M:, :], den[..., h - M:, :])[..., M - B:, :]
        img[..., :, :B] = _strip_image(num[..., :, :M], den[..., :, :M])[..., :, :B]
        img[..., :, w - B:] = _strip_image(
            num[..., :, w - M:], den[..., :, w - M:])[..., :, M - B:]
        return img
    return _strip_image(num, den)


def normalize_border_whole(num, den, refill_border):
    """:func:`normalize_accum` with ``refill_border=B`` as K7's image layout
    computes it: the refill of the whole image where a pixel lies within B
    of an edge, the guarded divide elsewhere (everywhere the refill where
    :func:`strip_width` says so). Equal to it bit for bit: the strips' 8-px
    margin makes their refill exact at every pixel they keep, and a
    well-fed pixel keeps its divide whatever its neighbours hold. Not on the
    path: it holds that formulation on the CPU."""
    full = _strip_image(num, den)
    B = strip_width(num.shape, refill_border)
    if B is None:
        return full
    h, w = num.shape[-2:]
    ys = torch.arange(h, device=num.device)
    xs = torch.arange(w, device=num.device)
    edge = ((ys < B) | (ys >= h - B))[:, None] | ((xs < B) | (xs >= w - B))[None, :]
    return torch.where(edge, full, num / torch.clamp(den, min=EPSILON_DIV))


def normalize_groups(num, den, B, tiles=False):
    """``(c, nty*B, ntx*B)`` accumulators -> image, each B-row slab (or each
    (B, B) tile with ``tiles``) refilled and divided on its own, as
    :func:`normalize_accum` without ``refill_border`` on that group alone.
    Evaluated :data:`_GROUP_TILE_ROWS` tile rows at a time (the groups are
    independent), which bounds the temporaries."""
    c, h, w = num.shape
    out = torch.empty_like(num)
    for y0 in range(0, h, B * _GROUP_TILE_ROWS):
        y1 = min(y0 + B * _GROUP_TILE_ROWS, h)
        nt = (y1 - y0) // B
        if tiles:
            def split(x):
                return x[:, y0:y1].reshape(c, nt, B, w // B, B).permute(1, 3, 0, 2, 4)
            img = _strip_image(split(num), split(den)).permute(2, 0, 3, 1, 4)
        else:
            def split(x):
                return x[:, y0:y1].reshape(c, nt, B, w).permute(1, 0, 2, 3)
            img = _strip_image(split(num), split(den)).permute(1, 0, 2, 3)
        out[:, y0:y1] = img.reshape(c, y1 - y0, w)
    return out
