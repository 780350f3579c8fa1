"""Steerable merge-kernel covariance estimation, Alg. 5 (twin of
:mod:`hmsr_tpu.models.kernels`)."""

import torch
import torch.nn.functional as F

from ..ops.gat import gat
from ..ops.gradients import halfpixel_gradients
from ..ops.grey import decimate_to_grey
from ..ops.linalg2x2 import eigen_2x2
from ..utils.types import DEFAULT_FLOAT


def _compute_k(l1, l2, k_detail, k_denoise, d_th, d_tr, k_stretch, k_shrink,
               selection_law):
    tr = l1 + l2
    one = torch.ones_like(tr)
    safe_tr = torch.where(tr > 0, tr, one)
    A = torch.where(tr > 0, 1.0 + torch.sqrt(torch.clamp(l1 - l2, min=0.0) / safe_tr),
                    one)
    D = torch.clamp(1.0 - torch.sqrt(torch.clamp(l1, min=0.0)) / d_tr + d_th, 0.0, 1.0)

    if selection_law == "hard_threshold":
        k1 = torch.where(A > 1.95, torch.full_like(tr, 1.0 / k_shrink), one)
        k2 = torch.where(A > 1.95, torch.full_like(tr, k_stretch), one)
    elif selection_law == "linear":
        k1 = 1.0 + A / 2.0 * (1.0 / k_shrink - 1.0)
        k2 = 1.0 + A / 2.0 * (k_stretch - 1.0)
    else:
        raise ValueError(f"Unknown selection law: {selection_law}")

    kk1 = k_detail * ((1.0 - D) * k1 + D * k_denoise)
    kk2 = k_detail * ((1.0 - D) * k2 + D * k_denoise)
    return kk1, kk2


def estimate_kernels(img, config):
    """Covariances Omega at every grey-grid pixel, (3, gh, gw) = (xx, xy, yy)."""
    bayer = config.mode == "bayer"
    mt = config.merging.tuning

    vst = gat(img, config.noise_model.alpha, config.noise_model.beta)
    grey = decimate_to_grey(vst) if bayer else vst
    grads = halfpixel_gradients(grey)

    gxx = grads[..., 0] * grads[..., 0]
    gxy = grads[..., 0] * grads[..., 1]
    gyy = grads[..., 1] * grads[..., 1]

    def window_sum(a):
        p = F.pad(a, (1, 1, 1, 1))
        return p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]

    st00 = window_sum(gxx)
    st01 = window_sum(gxy)
    st11 = window_sum(gyy)

    (l1, l2), (e10, e11), (e20, e21) = eigen_2x2(st00, st01, st01, st11)
    k1, k2 = _compute_k(l1, l2, mt.k_detail, mt.k_denoise, mt.D_th, mt.D_tr,
                        mt.k_stretch, mt.k_shrink, config.merging.selection_law)

    k1_sq = k1 * k1
    k2_sq = k2 * k2
    c00 = k1_sq * e10 * e10 + k2_sq * e20 * e20
    c01 = k1_sq * e10 * e11 + k2_sq * e20 * e21
    c11 = k1_sq * e11 * e11 + k2_sq * e21 * e21
    return torch.stack([c00, c01, c11]).to(DEFAULT_FLOAT)
