"""The end-to-end burst pipeline, scan form (twin of the ``scan`` pipeline
of :mod:`hmsr_tpu.models.pipeline`).

Reference init once (grey, pyramid, tiles, gradients, Hessians, robustness
reference stats), then a Python loop over the compared frames — grey ->
align (K1, K2, K3) -> robustness (K4) -> kernel covariances -> merge (K5) into
``(num, den)`` in place — then the reference-frame merge and the
border-strip refill + divide. Everything runs on the one ``device`` given to
:func:`make_pipeline`; there is no fallback to another device or to another
implementation: whatever the slice lacks raises ``NotImplementedError``.
"""

import numpy as np
import torch

from ..ops.accumfix import REFILL_BORDER, normalize_accum
from ..ops.grey import compute_grey_image
from ..utils.types import DEFAULT_FLOAT, resolve_device
from .alignment import align, init_alignment
from .kernels import estimate_kernels
from .merge_tiled import check_merge_config, merge_ref_tiled, merge_tiled
from .robustness import compute_robustness, init_robustness


def check_supported(config):
    """Raise ``NotImplementedError`` for configurations outside the slice."""
    check_merge_config(config)
    if str(config.get("grey_method", "FFT")) != "FFT":
        raise NotImplementedError(
            f"grey_method={config.grey_method!r} is not ported (needs "
            f"flow_to_raw_grid)")
    if config.accumulated_robustness_denoiser.get("enabled", False):
        raise NotImplementedError(
            "accumulated_robustness_denoiser is not ported")
    mode = config.get("tpu", {}).get("pipeline", "auto")
    if mode not in ("auto", "scan"):
        raise NotImplementedError(f"tpu.pipeline={mode!r}: only the scan "
                                  f"pipeline is ported")


def _as_tensor(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=DEFAULT_FLOAT, device=device)


def run_pipeline(ref_img, comp_imgs, std_curve, diff_curve, config,
                 cfa_pattern, white_balance, device):
    """Returns ``(image (H*s, W*s, 3), debug)``; with ``config.debug`` the
    debug dict holds per-frame ``flow`` (n, ny, nx, 2) and ``robustness``
    (n, H, W) stacks."""
    check_supported(config)
    device = resolve_device(device)
    scale = int(config.scale)
    debug_mode = bool(config.debug)
    grey_method = str(config.get("grey_method", "FFT"))

    ref_img = _as_tensor(ref_img, device)
    comp_imgs = _as_tensor(comp_imgs, device)
    curves = (_as_tensor(std_curve, device), _as_tensor(diff_curve, device))

    align_state = init_alignment(compute_grey_image(ref_img, grey_method), config)
    ref_stats = init_robustness(ref_img, cfa_pattern, white_balance, curves,
                                config)

    h, w = ref_img.shape
    num = torch.zeros((3, h * scale, w * scale), dtype=DEFAULT_FLOAT, device=device)
    den = torch.zeros_like(num)
    flows, rmaps = [], []
    for frame in comp_imgs:
        flow = align(align_state, compute_grey_image(frame, grey_method), config)
        r = compute_robustness(frame, ref_stats, flow, cfa_pattern,
                               white_balance, config)
        covs = estimate_kernels(frame, config)
        merge_tiled(frame, flow, covs, r, num, den, cfa_pattern, config)
        if debug_mode:
            flows.append(flow)
            rmaps.append(r)

    ref_covs = estimate_kernels(ref_img, config)
    merge_ref_tiled(ref_img, ref_covs, num, den, cfa_pattern, config)
    image = normalize_accum(num, den, refill_border=REFILL_BORDER).permute(1, 2, 0)

    debug = {}
    if debug_mode and flows:
        debug["flow"] = torch.stack(flows)
        debug["robustness"] = torch.stack(rmaps)
    return image, debug


def make_pipeline(config, cfa_pattern, white_balance, device):
    """Pipeline closure over the static configuration, on ``device``.

    The returned callable takes ``(ref_img, comp_imgs, std_curve,
    diff_curve)`` (numpy arrays or tensors) and returns ``(image, debug)``.
    Raises at once if ``device`` is CUDA and this host has none, or if the
    configuration lies outside the ported slice.
    """
    device = resolve_device(device)
    check_supported(config)
    cfa = np.asarray(cfa_pattern)
    wb = [float(x) for x in white_balance]

    def pipeline(ref_img, comp_imgs, std_curve, diff_curve):
        return run_pipeline(ref_img, comp_imgs, std_curve, diff_curve, config,
                            cfa, wb, device)

    return pipeline
