"""The end-to-end burst pipeline, ``scan`` and ``chunked`` forms (twin of
:mod:`hmsr_tpu.models.pipeline`).

Reference init once (grey, pyramid, tiles, gradients, Hessians, robustness
reference stats), then the compared frames, then the reference-frame merge
(with the accumulated-robustness denoiser when it is enabled) and the
border-strip refill + divide. In grey mode (``mode: grey``) a frame is its
own grey image and the accumulators have one plane. The accumulators are
``(c, round(s H), round(s W))`` at any scale s.

- ``scan`` (``tpu.pipeline`` "auto" or "scan"): a Python loop over the
  frames — grey -> align (K1, K2, K3) -> robustness (K4) -> kernel
  covariances -> merge into ``(num, den)`` in place: K5 at an integer
  scale, the gather merge (:func:`.merge.merge`, plain torch) at a
  fractional one.
- ``chunked``: the same analysis for every frame first, its flows,
  robustness maps and covariances stacked; then one burst-fused merge (K5')
  per chunk of ``tpu.merge_chunk`` frames (default 5; the last chunk is
  shorter). The result is bit-identical to ``scan``. Integer scales only:
  a fractional one raises ``ValueError``, as in the JAX package.

With ``grey_method: decimating`` (Bayer mode) the alignment runs on the
half-resolution grey image and each flow is moved to the raw tile grid
(:func:`flow_to_raw_grid`) before robustness and merge.

Everything runs on the one ``device`` given to :func:`make_pipeline`; there
is no fallback to another device or to another implementation: whatever the
slice lacks raises ``NotImplementedError``. The stages of the loop
(:func:`init_reference`, :func:`frame_step`, :func:`merge_reference`,
:func:`normalize_image`) are shared with the sharded pipeline
(:mod:`hmsr_tpu_torch.parallel.sharded`).
"""

import numpy as np
import torch

from ..ops.accumfix import REFILL_BORDER, normalize_accum
from ..ops.cuda_merge import merge_burst_accumulate
from ..ops.grey import compute_grey_image
from ..utils.types import DEFAULT_FLOAT, resolve_device
from .alignment import align, init_alignment
from .kernels import estimate_kernels
from .merge import merge
from .merge_tiled import (check_merge_config, integer_scale, merge_ref_tiled,
                          merge_tiled, merge_variant)
from .robustness import compute_robustness, init_robustness

PIPELINES = ("auto", "scan", "chunked")


def check_supported(config):
    """Raise ``NotImplementedError`` for a pipeline form outside the port,
    and ``ValueError`` for the chunked form at a fractional scale."""
    mode = config.get("tpu", {}).get("pipeline", "auto")
    if mode not in PIPELINES:
        raise NotImplementedError(f"tpu.pipeline={mode!r}: only the scan and "
                                  f"chunked pipelines are ported")
    if mode == "chunked" and not integer_scale(config):
        raise ValueError("tpu.pipeline=chunked requires an integer scale "
                         "(tiled merge geometry)")


def select_merge(config):
    """The merge of a compared frame: K5 (:func:`.merge_tiled.merge_tiled`)
    at an integer scale, the gather merge (:func:`.merge.merge`) at a
    fractional one."""
    return merge_tiled if integer_scale(config) else merge


def accum_shape(config, raw_shape):
    """``(c, round(s H), round(s W))``: c = 3 in Bayer mode, 1 in grey mode."""
    h, w = raw_shape
    scale = float(config.scale)
    return (3 if config.mode == "bayer" else 1, round(scale * h), round(scale * w))


def flow_to_raw_grid(flow, raw_shape, tile_size):
    """A decimating-grey flow (tiles of ``tile_size`` grey pixels, values in
    grey pixels) on the raw tile grid: values x2, each grey tile repeated
    2x2 so that raw tile (i, j) reads grey tile (i // 2, j // 2), edge-padded
    or cropped to the raw tile count (the JAX package's documented deviation
    from the reference, README "Parity notes")."""
    ny = -(-raw_shape[0] // tile_size)
    nx = -(-raw_shape[1] // tile_size)
    f = (flow * 2.0).repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    rows = torch.arange(ny, device=f.device).clamp(max=f.shape[0] - 1)
    cols = torch.arange(nx, device=f.device).clamp(max=f.shape[1] - 1)
    return f[rows[:, None], cols[None, :]]


def to_raw_flow(flow, raw_shape, config):
    """The flow of :func:`align` on the raw tile grid: converted by
    :func:`flow_to_raw_grid` with the decimating grey in Bayer mode, as it
    is otherwise."""
    if config.mode == "bayer" and str(config.get("grey_method", "FFT")) == "decimating":
        return flow_to_raw_grid(flow, raw_shape,
                                int(config.block_matching.tuning.tile_size))
    return flow


def to_grey(frame, config):
    """The image a frame is aligned on: its grey image in Bayer mode, the
    frame itself in grey mode (the JAX package's ``to_grey``)."""
    if config.mode != "bayer":
        return frame
    return compute_grey_image(frame, str(config.get("grey_method", "FFT")))


def _as_tensor(x, device):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=DEFAULT_FLOAT, device=device)


def init_reference(ref_img, curves, config, cfa_pattern, white_balance):
    """The reference init: ``(align_state, ref_stats)``, the alignment
    state of the reference's grey image and its robustness statistics."""
    align_state = init_alignment(to_grey(ref_img, config), config)
    ref_stats = init_robustness(ref_img, cfa_pattern, white_balance, curves,
                                config)
    return align_state, ref_stats


def frame_step(frame, align_state, ref_stats, config, cfa_pattern, white_balance,
               weight=None):
    """The analysis of one compared frame: ``(flow, r, covs)``, its flow on
    the raw tile grid (grey, align, the decimating grey's conversion), its
    robustness map (times ``weight`` where one is given: the sharded
    pipeline's zero-weight padding frames) and its kernel covariances."""
    flow = to_raw_flow(align(align_state, to_grey(frame, config), config),
                       frame.shape, config)
    r = compute_robustness(frame, ref_stats, flow, cfa_pattern, white_balance,
                           config)
    if weight is not None:
        r = r * weight
    return flow, r, estimate_kernels(frame, config)


def merge_reference(ref_img, num, den, cfa_pattern, config, acc_r=None,
                    row_offset=0):
    """The reference frame's merge into (num, den) in place, with the
    accumulated-robustness denoiser when it is enabled (``acc_r``)."""
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    return merge_ref_tiled(ref_img, estimate_kernels(ref_img, config), num, den,
                           cfa_pattern, config, acc_rob=acc_r if denoise else None,
                           row_offset=row_offset)


def normalize_image(num, den):
    """The border-strip refill and divide of the whole accumulators: the
    ``(round(s H), round(s W), c)`` image."""
    return normalize_accum(num, den, refill_border=REFILL_BORDER).permute(1, 2, 0)


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
    """Returns ``(image (round(s H), round(s W), c), debug)``, c = 3 in
    Bayer mode and 1 in grey mode. With ``config.debug`` the debug dict
    holds per-frame ``flow`` (n, ny, nx, 2) on the raw tile grid and
    ``robustness`` (n, H, W) stacks; with
    ``robustness.save_mask`` (or the accumulated-robustness denoiser)
    ``accumulated_robustness`` (H, W), the sum of the frames' robustness
    maps, which the denoiser hands to the reference-frame merge."""
    check_supported(config)
    device = resolve_device(device)
    debug_mode = bool(config.debug)
    chunked = config.get("tpu", {}).get("pipeline", "auto") == "chunked"
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    accumulate_r = denoise or bool(config.robustness.save_mask)

    ref_img = _as_tensor(ref_img, device)
    comp_imgs = _as_tensor(comp_imgs, device)
    curves = (_as_tensor(std_curve, device), _as_tensor(diff_curve, device))

    align_state, ref_stats = init_reference(ref_img, curves, config, cfa_pattern,
                                            white_balance)

    merge_frame = select_merge(config)
    num = torch.zeros(accum_shape(config, ref_img.shape), dtype=DEFAULT_FLOAT,
                      device=device)
    den = torch.zeros_like(num)
    acc_r = torch.zeros(ref_img.shape, dtype=DEFAULT_FLOAT, device=device) \
        if accumulate_r else None
    flows, rmaps, covs_list = [], [], []
    for frame in comp_imgs:
        flow, r, covs = frame_step(frame, align_state, ref_stats, config,
                                   cfa_pattern, white_balance)
        if acc_r is not None:
            acc_r = acc_r + r
        if chunked:
            covs_list.append(covs)
        else:
            merge_frame(frame, flow, covs, r, num, den, cfa_pattern, config)
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

    merge_reference(ref_img, num, den, cfa_pattern, config, acc_r)
    image = normalize_image(num, den)

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
