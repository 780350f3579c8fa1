"""K12 (the merge kernels' covariances of one frame, one launch): CUDA kernel
wrapper and its plain PyTorch version.

The chain of :func:`hmsr_tpu.models.kernels.estimate_kernels` (Alg. 5): the
VST of the raw frame (:mod:`.gat`), its 2x2 decimation to grey in Bayer mode
(:mod:`.grey`), the half-pixel gradients (:mod:`.gradients`), their
zero-padded 2x2 window sums (the structure tensor), its eigen-decomposition
(:mod:`.linalg2x2`), the stretch and shrink of the selection law and the
covariances. The kernel is ``csrc/estimate.cu``; its header says what bounds
it on the H100 and how the design answers it. The wrapper launches it for
CUDA tensors and runs the plain version only for CPU tensors;
``estimate_kernels_fused.launches`` counts kernel launches.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import _build
from .gat import gat
from .gradients import halfpixel_gradients
from .grey import decimate_to_grey
from .linalg2x2 import eigen_2x2
from ..utils.types import DEFAULT_FLOAT

#: the selection laws, in the order of K12's ``LAW`` template parameter
SELECTION_LAWS = ("hard_threshold", "linear")


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


def estimate_kernels_plain(img, config):
    """Plain version of K12: covariances Omega at every grey-grid pixel,
    (3, gh, gw) = (xx, xy, yy)."""
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


def _f32(x):
    return float(np.float32(x))


def estimate_params(config):
    """K12's run-time constants after the frame's geometry: the plain
    version's Python constants as its ops on the card take them, each folded
    in double and rounded to float32 (``alpha I + 3/8 alpha^2 + beta``,
    ``2 / alpha``, ``1 / k_shrink``), the division by ``D_tr`` as the
    multiply by the float32 reciprocal that PyTorch's CUDA division by a
    Python number is; ``(k1, k2)`` of the law: the hard threshold's values,
    or the linear law's slopes ``1 / k_shrink - 1`` and ``k_stretch - 1``."""
    alpha, beta = config.noise_model.alpha, config.noise_model.beta
    mt = config.merging.tuning
    k1, k2 = 1.0 / mt.k_shrink, mt.k_stretch
    if config.merging.selection_law == "linear":
        k1, k2 = k1 - 1.0, k2 - 1.0
    return [_f32(alpha), _f32((3.0 / 8.0) * alpha * alpha), _f32(beta), _f32(2.0 / alpha),
            float(np.float32(1.0) / np.float32(mt.D_tr)), _f32(mt.D_th),
            _f32(mt.k_detail), _f32(mt.k_denoise), _f32(k1), _f32(k2)]


def estimate_kernels_fused(img, config):
    """K12: the covariances of one frame in one launch (the arguments and the
    result of :func:`estimate_kernels_plain`). ``img``: a 2-D float32 tensor
    with at least one whole grey pixel; the covariances are contiguous
    (3, gh, gw), gh x gw = H/2 x W/2 in Bayer mode (an odd last row or column
    cropped) and H x W in grey mode. On CPU tensors it runs the plain
    version."""
    alpha = config.noise_model.alpha
    if not alpha > 0:
        raise ValueError(f"alpha should be positive, got {alpha} (VST is ill "
                         f"defined and kernels would be wrong)")
    law = config.merging.selection_law
    if law not in SELECTION_LAWS:
        raise ValueError(f"Unknown selection law: {law}")
    dev = img.device
    _build.check_f32("img", img, 2, dev)
    bayer = config.mode == "bayer"
    h, w = img.shape
    gh, gw = (h // 2, w // 2) if bayer else (h, w)
    _build.check_arg(gh > 0 and gw > 0,
                     f"img {(h, w)}: no whole grey pixel in {config.mode} mode")
    if dev.type == "cpu":
        return estimate_kernels_plain(img, config)
    _build.require_cuda(dev)
    img = img.contiguous()
    out = torch.empty((3, gh, gw), dtype=DEFAULT_FLOAT, device=dev)
    err = _build.library().hmsr_estimate(
        _build.ptr(img), h, w, int(bayer), SELECTION_LAWS.index(law),
        *estimate_params(config), _build.ptr(out), _build.stream_of(img))
    _build.check(err, "hmsr_estimate")
    estimate_kernels_fused.launches += 1
    return out


estimate_kernels_fused.launches = 0
