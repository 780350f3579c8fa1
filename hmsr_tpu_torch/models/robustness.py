"""Noise-model-aware robustness estimation, Algs. 6-9 (twin of
:mod:`hmsr_tpu.models.robustness`).

The reference's statistics: guide image -> 3x3 local stats -> Dodgson
upscale-warp to the raw grid with zero flow (K4,
:func:`hmsr_tpu_torch.ops.cuda_warp.upscale_warp`) -> the noise curves' terms.
Each compared frame's map is one launch of K10
(:func:`hmsr_tpu_torch.ops.cuda_robustness.robustness_fused`), whose plain
version holds the chain: guide image -> 3x3 local means -> warp -> channel
distance -> noise-model correction -> flow-discontinuity term S -> threshold
-> 5x5 local min. Out-of-grid warped statistics are carried as an explicit
validity mask (R = 0 there), as in the JAX package.
"""

from typing import NamedTuple

import torch

from ..ops.cuda_robustness import (compute_guide_image, compute_s,  # noqa: F401
                                   robustness_fused)
from ..ops.cuda_warp import upscale_warp
from ..ops.lut import lut_lookup
from ..ops.stencils import local_stats_3x3
from ..utils.types import DEFAULT_FLOAT


class RefStats(NamedTuple):
    """Reference-frame statistics, upscaled to the raw grid."""
    means: torch.Tensor     # (C, H, W)
    d_t: torch.Tensor       # (C, H, W) diff-curve value at the local mean
    sigma_sq: torch.Tensor  # (H, W) sum_c max(local var, sigma_t^2)
    valid: torch.Tensor     # (H, W) bool


def upscale_warp_stats_tiled(stats, upscale, tile_size, flow, out_shape):
    """Dodgson upscale-warp of guide-grid stats (c, lh, lw) to the raw grid
    ``out_shape``; returns ``(hr_stats (c, H, W), valid (H, W))``. K4 on
    CUDA tensors, its plain version on CPU tensors."""
    return upscale_warp(stats.contiguous(), upscale, tile_size,
                        flow.to(DEFAULT_FLOAT).contiguous(), out_shape)


def _guide(raw, cfa_pattern, white_balance, config):
    if config.mode == "bayer":
        return compute_guide_image(raw, cfa_pattern, white_balance), 2
    return raw[None], 1


def init_robustness(ref_raw, cfa_pattern, white_balance, noise_curves, config):
    """Reference-frame statistics + precomputed noise-model terms."""
    if not config.robustness.enabled:
        return None
    guide, upscale = _guide(ref_raw, cfa_pattern, white_balance, config)
    means, stds = local_stats_3x3(guide)
    Ts = int(config.block_matching.tuning.tile_size)
    out_shape = (guide.shape[1] * upscale, guide.shape[2] * upscale)
    zero_flow = torch.zeros((-(-out_shape[0] // Ts), -(-out_shape[1] // Ts), 2),
                            dtype=DEFAULT_FLOAT, device=ref_raw.device)
    hr_means, valid_m = upscale_warp_stats_tiled(means, upscale, Ts, zero_flow,
                                                 out_shape)
    hr_stds, _ = upscale_warp_stats_tiled(stds, upscale, Ts, zero_flow, out_shape)

    std_curve, diff_curve = noise_curves
    sigma_t, d_t = lut_lookup([std_curve, diff_curve], hr_means)
    sigma_sq = torch.sum(torch.maximum(hr_stds, sigma_t * sigma_t), dim=0)
    return RefStats(means=hr_means, d_t=d_t, sigma_sq=sigma_sq, valid=valid_m)


def compute_robustness(comp_img, ref_stats, flow, cfa_pattern, white_balance,
                       config):
    """Robustness map r of the compared frame at raw resolution (Alg. 6): K10
    on CUDA tensors, its plain version on CPU tensors."""
    if not config.robustness.enabled:
        return torch.ones(comp_img.shape, dtype=DEFAULT_FLOAT, device=comp_img.device)
    tun = config.robustness.tuning
    return robustness_fused(comp_img.to(DEFAULT_FLOAT).contiguous(), ref_stats,
                            flow.to(DEFAULT_FLOAT).contiguous(), cfa_pattern,
                            white_balance, config.mode != "bayer",
                            int(config.block_matching.tuning.tile_size), tun.Mt, tun.s1,
                            tun.s2, tun.t)
