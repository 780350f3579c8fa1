"""The end-to-end burst pipeline, ``scan`` and ``chunked`` forms (twin of
:mod:`hmsr_tpu.models.pipeline`).

Reference init once (grey, pyramid, tiles, gradients, Hessians, robustness
reference stats), then the compared frames, then the reference-frame merge
(with the accumulated-robustness denoiser when it is enabled) and the
border-strip refill + divide. In grey mode (``mode: grey``) a frame is its
own grey image and the accumulators have one plane.

- ``scan`` (``tpu.pipeline`` "auto" or "scan"): a Python loop over the
  frames — grey -> align (K1, K2, K3) -> robustness (K4) -> kernel
  covariances -> merge (K5) into ``(num, den)`` in place.
- ``chunked``: the same analysis for every frame first, its flows,
  robustness maps and covariances stacked; then one burst-fused merge (K5')
  per chunk of ``tpu.merge_chunk`` frames (default 5; the last chunk is
  shorter). The result is bit-identical to ``scan``.

Everything runs on the one ``device`` given to :func:`make_pipeline`; there
is no fallback to another device or to another implementation: whatever the
slice lacks raises ``NotImplementedError``.
"""

import numpy as np
import torch

from ..ops.accumfix import REFILL_BORDER, normalize_accum
from ..ops.cuda_merge import merge_burst_accumulate
from ..ops.grey import compute_grey_image
from ..utils.types import DEFAULT_FLOAT, resolve_device
from .alignment import align, init_alignment
from .kernels import estimate_kernels
from .merge_tiled import check_merge_config, merge_ref_tiled, merge_tiled, merge_variant
from .robustness import compute_robustness, init_robustness

PIPELINES = ("auto", "scan", "chunked")


def check_supported(config):
    """Raise ``NotImplementedError`` for configurations outside the slice."""
    check_merge_config(config)
    if str(config.get("grey_method", "FFT")) != "FFT":
        raise NotImplementedError(
            f"grey_method={config.grey_method!r} is not ported (needs "
            f"flow_to_raw_grid)")
    mode = config.get("tpu", {}).get("pipeline", "auto")
    if mode not in PIPELINES:
        raise NotImplementedError(f"tpu.pipeline={mode!r}: only the scan and "
                                  f"chunked pipelines are ported")


def to_grey(frame, config):
    """The image a frame is aligned on: its grey image in Bayer mode, the
    frame itself in grey mode (the JAX package's ``to_grey``)."""
    if config.mode != "bayer":
        return frame
    return compute_grey_image(frame, str(config.get("grey_method", "FFT")))


def _as_tensor(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=DEFAULT_FLOAT, device=device)


def _merge_burst_chunked(comp_imgs, flows, covs_stack, rmaps, num, den,
                         cfa_pattern, config):
    """Accumulate the stacked frames into (num, den) in place through K5',
    one launch per chunk of ``tpu.merge_chunk`` (default 5) frames; the last
    chunk is shorter (the JAX package pads it with zero-robustness frames,
    which add exact zeros). Returns the pair."""
    s = check_merge_config(config)
    grey, iso = merge_variant(config)
    ts = int(config.block_matching.tuning.tile_size)
    f0 = comp_imgs.shape[0]
    fc = max(1, min(int(config.get("tpu", {}).get("merge_chunk", 5)), f0))
    for c0 in range(0, f0, fc):
        c1 = min(c0 + fc, f0)
        merge_burst_accumulate(comp_imgs[c0:c1], flows[c0:c1], covs_stack[c0:c1],
                               rmaps[c0:c1], num, den, cfa_pattern, ts, s, grey, iso)
    return num, den


def run_pipeline(ref_img, comp_imgs, std_curve, diff_curve, config,
                 cfa_pattern, white_balance, device="cuda"):
    """Returns ``(image (H*s, W*s, c), debug)``, c = 3 in Bayer mode and 1
    in grey mode. With ``config.debug`` the debug dict holds per-frame
    ``flow`` (n, ny, nx, 2) and ``robustness`` (n, H, W) stacks; with
    ``robustness.save_mask`` (or the accumulated-robustness denoiser)
    ``accumulated_robustness`` (H, W), the sum of the frames' robustness
    maps, which the denoiser hands to the reference-frame merge."""
    check_supported(config)
    device = resolve_device(device)
    scale = int(config.scale)
    debug_mode = bool(config.debug)
    chunked = config.get("tpu", {}).get("pipeline", "auto") == "chunked"
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    accumulate_r = denoise or bool(config.robustness.save_mask)

    ref_img = _as_tensor(ref_img, device)
    comp_imgs = _as_tensor(comp_imgs, device)
    curves = (_as_tensor(std_curve, device), _as_tensor(diff_curve, device))

    align_state = init_alignment(to_grey(ref_img, config), config)
    ref_stats = init_robustness(ref_img, cfa_pattern, white_balance, curves,
                                config)

    h, w = ref_img.shape
    n_ch = 3 if config.mode == "bayer" else 1
    num = torch.zeros((n_ch, h * scale, w * scale), dtype=DEFAULT_FLOAT, device=device)
    den = torch.zeros_like(num)
    acc_r = torch.zeros((h, w), dtype=DEFAULT_FLOAT, device=device) \
        if accumulate_r else None
    flows, rmaps, covs_list = [], [], []
    for frame in comp_imgs:
        flow = align(align_state, to_grey(frame, config), config)
        r = compute_robustness(frame, ref_stats, flow, cfa_pattern,
                               white_balance, config)
        if acc_r is not None:
            acc_r = acc_r + r
        covs = estimate_kernels(frame, config)
        if chunked:
            covs_list.append(covs)
        else:
            merge_tiled(frame, flow, covs, r, num, den, cfa_pattern, config)
        if debug_mode or chunked:
            flows.append(flow)
            rmaps.append(r)
    # the stacks replace the per-frame lists, so that no frame's maps are
    # held twice (the chunked analysis peaks at the stacks)
    flow_stack = torch.stack(flows).to(DEFAULT_FLOAT) if flows else None
    r_stack = torch.stack(rmaps) if rmaps else None
    del flows, rmaps
    if chunked and flow_stack is not None:
        covs_stack = torch.stack(covs_list)
        del covs_list
        _merge_burst_chunked(comp_imgs.contiguous(), flow_stack, covs_stack, r_stack,
                             num, den, cfa_pattern, config)
        del covs_stack

    ref_covs = estimate_kernels(ref_img, config)
    merge_ref_tiled(ref_img, ref_covs, num, den, cfa_pattern, config,
                    acc_rob=acc_r if denoise else None)
    image = normalize_accum(num, den, refill_border=REFILL_BORDER).permute(1, 2, 0)

    debug = {}
    if debug_mode and flow_stack is not None:
        debug["flow"] = flow_stack
        debug["robustness"] = r_stack
    if acc_r is not None:
        debug["accumulated_robustness"] = acc_r
    return image, debug


def make_pipeline(config, cfa_pattern, white_balance, device="cuda"):
    """Pipeline closure over the static configuration, on ``device`` (the
    card unless the caller asks for the CPU).

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
