"""Steerable merge-kernel covariance estimation, Alg. 5 (twin of
:mod:`hmsr_tpu.models.kernels`): one launch of K12 a frame on the card, its
plain version (:func:`~..ops.cuda_estimate.estimate_kernels_plain`) on the
CPU."""

from ..ops.cuda_estimate import estimate_kernels_fused


def estimate_kernels(img, config):
    """Covariances Omega at every grey-grid pixel, (3, gh, gw) = (xx, xy, yy)."""
    return estimate_kernels_fused(img, config)
