"""Noise-model-aware robustness estimation, Algs. 6-9 (twin of
:mod:`hmsr_tpu.models.robustness`).

Chain: guide image -> 3x3 local stats -> Dodgson upscale-warp to the raw
grid (K4, :func:`hmsr_tpu_torch.ops.cuda_warp.upscale_warp`) -> channel
distance -> noise-model correction -> flow-discontinuity term S ->
threshold -> 5x5 local min. Out-of-grid warped statistics are carried as an
explicit validity mask (R = 0 there), as in the JAX package.
"""

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda_warp import upscale_warp
from ..ops.lut import lut_lookup
from ..ops.stencils import edge_pad, local_min_5x5, local_stats_3x3
from ..utils.types import DEFAULT_FLOAT


class RefStats(NamedTuple):
    """Reference-frame statistics, upscaled to the raw grid."""
    means: torch.Tensor     # (C, H, W)
    d_t: torch.Tensor       # (C, H, W) diff-curve value at the local mean
    sigma_sq: torch.Tensor  # (H, W) sum_c max(local var, sigma_t^2)
    valid: torch.Tensor     # (H, W) bool


def compute_guide_image(raw, cfa_pattern, white_balance):
    """Bayer quad -> half-res RGB (3, H/2, W/2) with white balance undone
    (Alg. 7), from strided quad phases."""
    h, w = raw.shape
    cfa = np.asarray(cfa_pattern, dtype=np.int64)
    quads = raw[: (h // 2) * 2, : (w // 2) * 2].reshape(h // 2, 2, w // 2, 2)
    chans = [None, None, None]
    green = 0.0
    for i in range(2):
        for j in range(2):
            c = int(cfa[i, j])
            x = quads[:, i, :, j] / white_balance[c]
            if c == 1:
                green = green + x
            else:
                chans[c] = x
    chans[1] = green / 2.0
    return torch.stack(chans, dim=0).to(DEFAULT_FLOAT)


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


def compute_s(flow, m_th, s1, s2):
    """Flow-discontinuity map: s1 where the 3x3 flow range exceeds Mt, else s2."""
    def rng3(a):
        h, w = a.shape
        p = edge_pad(edge_pad(a, 1, 0), 1, 1)
        hi = lo = p[0:h, 0:w]
        for i in range(3):
            for j in range(3):
                v = p[i:i + h, j:j + w]
                hi = torch.maximum(hi, v)
                lo = torch.minimum(lo, v)
        return hi - lo

    d0 = rng3(flow[..., 0])
    d1 = rng3(flow[..., 1])
    return torch.where(d0 * d0 + d1 * d1 > m_th * m_th,
                       torch.full_like(d0, float(s1)),
                       torch.full_like(d0, float(s2)))


def compute_robustness(comp_img, ref_stats, flow, cfa_pattern, white_balance,
                       config):
    """Robustness map r of the compared frame at raw resolution (Alg. 6)."""
    if not config.robustness.enabled:
        return torch.ones(comp_img.shape, dtype=DEFAULT_FLOAT, device=comp_img.device)
    tile_size = int(config.block_matching.tuning.tile_size)
    tun = config.robustness.tuning

    guide, upscale = _guide(comp_img, cfa_pattern, white_balance, config)
    comp_means, _ = local_stats_3x3(guide)
    out_shape = (guide.shape[1] * upscale, guide.shape[2] * upscale)
    comp_means, comp_valid = upscale_warp_stats_tiled(comp_means, upscale,
                                                      tile_size, flow, out_shape)

    d_p = torch.abs(ref_stats.means - comp_means)
    d_t = ref_stats.d_t
    d_p_sq = d_p * d_p
    shrink = d_p_sq / (d_p_sq + d_t * d_t)
    d_sq = torch.sum(d_p_sq * shrink * shrink, dim=0)

    S = compute_s(flow, tun.Mt, tun.s1, tun.s2)
    h, w = d_sq.shape
    s_map = S.repeat_interleave(tile_size, 0).repeat_interleave(tile_size, 1)[:h, :w]

    R = torch.clamp(s_map * torch.exp(-d_sq / ref_stats.sigma_sq) - tun.t, 0.0, 1.0)
    R = torch.where(ref_stats.valid & comp_valid, R, torch.zeros((), device=R.device))
    return local_min_5x5(R)
