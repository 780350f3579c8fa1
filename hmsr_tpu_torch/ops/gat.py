"""Generalized Anscombe Transform (twin of :mod:`hmsr_tpu.ops.gat`)."""

import torch


def gat(image, alpha, beta):
    """VST: ``2/alpha * sqrt(max(alpha*I + 3/8*alpha^2 + beta, 0))``."""
    if not alpha > 0:
        raise ValueError(f"alpha should be positive, got {alpha} (VST is ill "
                         f"defined and kernels would be wrong)")
    vst = alpha * image + (3.0 / 8.0) * alpha * alpha + beta
    vst = torch.clamp(vst, min=0.0)
    # the square root is taken in float64 and rounded once, which is the
    # correctly rounded float32 root on every device (torch's vectorized CPU
    # sqrt is not): one ulp of the ~1e2-sized VST, amplified by the
    # gradients of kernel estimation, is ~5e-5 of the covariances
    return (2.0 / alpha) * torch.sqrt(vst.double()).to(vst.dtype)
