"""Small fixed-window stencils as shifted-slice reductions (twin of
:mod:`hmsr_tpu.ops.stencils`)."""

import torch


def edge_pad(img, r, dim):
    """Replicate-pad ``img`` by ``r`` on both sides of ``dim``."""
    n = img.shape[dim]
    idx = torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1)
    return img.index_select(dim, idx)


def local_stats_3x3(img):
    """Clamped-boundary 3x3 local mean and variance over the last two dims."""
    h, w = img.shape[-2], img.shape[-1]

    def box3(x):
        p = edge_pad(x, 1, -2)
        r = p[..., 0:h, :] + p[..., 1:1 + h, :] + p[..., 2:2 + h, :]
        p = edge_pad(r, 1, -1)
        return p[..., :, 0:w] + p[..., :, 1:1 + w] + p[..., :, 2:2 + w]

    s = box3(img)
    s2 = box3(img * img)
    mean = s / 9.0
    var = s2 / 9.0 - mean * mean
    return mean, var


def local_min_5x5(img):
    """Clamped-boundary 5x5 local minimum, separable (min of mins)."""
    h, w = img.shape[-2], img.shape[-1]
    p = edge_pad(img, 2, -2)
    rows = p[..., 0:h, :]
    for i in range(1, 5):
        rows = torch.minimum(rows, p[..., i:i + h, :])
    p = edge_pad(rows, 2, -1)
    out = p[..., :, 0:w]
    for j in range(1, 5):
        out = torch.minimum(out, p[..., :, j:j + w])
    return out


def box_sum_valid(img, k):
    """Valid k x k box sum over the last two dims via integral images;
    output spatial shape ``(H - k + 1, W - k + 1)``."""
    c = torch.cumsum(torch.cumsum(img, dim=-2), dim=-1)
    c = torch.nn.functional.pad(c, (1, 0, 1, 0))
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = h - k + 1, w - k + 1
    return (c[..., k:k + oh, k:k + ow] - c[..., k:k + oh, 0:ow]
            - c[..., 0:oh, k:k + ow] + c[..., 0:oh, 0:ow])
