"""Dodgson quadratic interpolation kernel (twin of :mod:`hmsr_tpu.ops.dogson`)."""

import torch


def dogson_quadratic_kernel(x):
    """w(x) = -2x^2 + 1 for |x| <= 0.5 ; x^2 - 2.5|x| + 1.5 for |x| <= 1.5 ; 0."""
    ax = torch.abs(x)
    near = -2.0 * ax * ax + 1.0
    mid = ax * ax - 2.5 * ax + 1.5
    return torch.where(ax <= 0.5, near,
                       torch.where(ax <= 1.5, mid, torch.zeros_like(ax)))
