"""``jax.image.resize``'s ``linear`` and ``cubic`` methods in torch, for the
flow upscaling between pyramid levels (``flow_upscale_mode`` bilinear and
bicubic; :func:`hmsr_tpu_torch.models.alignment.upscale_flow`).

JAX's rule, not torch's (``F.interpolate``'s cubic has a = -0.75 and clamps
at the edges): output x samples the input at ``(x + 0.5) / r - 0.5``; the
kernel is the triangle or Keys' cubic with a = -0.5 (scaled by ``1/r`` when
downsampling); taps outside the input get zero weight and each output's
weights are renormalised by their sum (outputs whose sum is below ``1000
eps`` are zero), and outputs whose sample lies outside ``[-0.5, n - 0.5]``
are zero. Each resized axis is one dense (n_in, n_out) weight matrix,
computed once per size on the host in float32 with JAX's operations, and
the axes are contracted one ``einsum`` each, width first (flow grids are
tiny).
"""

import functools

import numpy as np
import torch

from ..utils.types import DEFAULT_FLOAT


def _triangle(x):
    return np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))


def _keys_cubic(x):
    out = ((np.float32(1.5) * x - np.float32(2.5)) * x) * x + np.float32(1.0)
    out = np.where(x >= 1.0, ((np.float32(-0.5) * x + np.float32(2.5)) * x
                              - np.float32(4.0)) * x + np.float32(2.0), out)
    return np.where(x >= 2.0, np.float32(0.0), out).astype(np.float32)


KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


def weight_matrix_np(n_in, n_out, method):
    """(n_in, n_out) float32 weights of one axis (``compute_weight_mat`` of
    ``jax._src.image.scale``, antialiased, no translation)."""
    inv_scale = 1.0 / (n_out / n_in)
    f32 = np.float32
    kernel_scale = f32(max(inv_scale, 1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale
    w = KERNELS[method](x.astype(f32))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in, n_out, method, device):
    """:func:`weight_matrix_np` as a tensor on ``device`` (cached)."""
    return torch.as_tensor(weight_matrix_np(n_in, n_out, method), device=device)


def resize(x, out_hw, method):
    """Resize the two leading axes of ``x`` (h, w, ...) to ``out_hw`` with
    ``method`` "linear" or "cubic"; an axis that keeps its size is left as
    it is (both kernels interpolate)."""
    if method not in KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    h, w = x.shape[:2]
    x = x.to(DEFAULT_FLOAT)
    # the width axis first, as JAX contracts them
    if out_hw[1] != w:
        x = torch.einsum("hw...,wW->hW...", x,
                         weight_matrix(w, out_hw[1], method, x.device))
    if out_hw[0] != h:
        x = torch.einsum("h...,hH->H...", x,
                         weight_matrix(h, out_hw[0], method, x.device))
    return x
