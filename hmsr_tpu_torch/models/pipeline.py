"""The end-to-end burst pipeline in the ``scan``, ``chunked``, ``fused`` and
``vmapped`` forms (twin of :mod:`hmsr_tpu.models.pipeline`).

Reference init once (grey, pyramid, tiles, gradients, Hessians, robustness
reference stats), then the compared frames, then the reference-frame merge
(with the accumulated-robustness denoiser when it is enabled) and the
refill + divide. In grey mode (``mode: grey``) a frame is its own grey
image and the accumulators have one plane. The accumulators are ``(c,
round(s H), round(s W))`` at any scale s.

- ``auto`` (the default): ``fused`` where the merge is tiled
  (:func:`_use_tiled`), ``scan`` otherwise. The JAX package picks ``scan``
  on a TPU and ``fused`` on any other device (``_on_tpu()``); the port
  never runs on a TPU, so its ``auto`` is the JAX package's off the TPU.
- ``scan``: a Python loop over the
  frames — grey -> align (K1, K2, K3) -> robustness (K4) -> kernel
  covariances -> merge into ``(num, den)`` in place: K5 where the merge is
  tiled, the gather merge (:func:`.merge.merge`, plain torch) otherwise;
  then the reference merge and the border-strip refill (one launch of K7,
  :func:`normalize_image`).
- ``chunked``: the same analysis for every frame first, its flows,
  robustness maps and covariances stacked; then one burst-fused merge (K5')
  per chunk of ``tpu.merge_chunk`` frames (default 5; the last chunk is
  shorter). The result is bit-identical to ``scan``. Tiled merges only:
  otherwise it raises ``ValueError``, as in the JAX package.
- ``fused``: the same stacked analysis, then the whole burst and the
  reference frame in one launch of K6 and the refill per group of the
  accumulators, interior included, in one launch of K7 (:mod:`.merge_fused`:
  per B-row slab with ``tpu.fused_impl: slab``, the default; per (B, B)
  tile with any other value). Where the merge is not tiled it runs the scan
  form, as the JAX package does (its fused merges need the tiled geometry).
- ``vmapped``: the stacked analysis, ``acc_r`` the sum of the stacked
  robustness maps, then the scan form's merges frame by frame, reference
  merge and border-strip refill: the scan image.

``tpu.merge_impl`` (``auto``, ``tiled``, ``gather``; ``pallas`` is the JAX
package's Pallas twin of ``tiled``) picks the merge as the JAX package does
(:func:`_use_tiled`): the gather merge with ``gather`` and, under ``auto``,
at a fractional scale; any other value at a fractional scale raises
``ValueError``; everything else is tiled (K5, K5', K6 by form).

With ``grey_method: decimating`` (Bayer mode) the alignment runs on the
half-resolution grey image and each flow is moved to the raw tile grid
(:func:`flow_to_raw_grid`) before robustness and merge.

Everything runs on the one ``device`` given to :func:`make_pipeline`; there
is no fallback to another device or to another implementation: an unknown
form raises ``NotImplementedError``. The stages of the loop
(:func:`init_reference`, :func:`frame_step`, :func:`merge_reference`,
:func:`normalize_image`) are shared with the sharded pipeline
(:mod:`hmsr_tpu_torch.parallel.sharded`).
"""

import numpy as np
import torch

from ..ops.accumfix import REFILL_BORDER
from ..ops.cuda_merge import merge_burst_accumulate, refill_image
from ..ops.grey import compute_grey_image
from ..utils.timing import span
from ..utils.types import DEFAULT_FLOAT, resolve_device
from .alignment import align, init_alignment
from .kernels import estimate_kernels
from .merge import merge
from .merge_fused import merge_burst_slab, merge_burst_tiled
from .merge_tiled import (check_merge_config, integer_scale, merge_ref_tiled,
                          merge_tiled, merge_variant)
from .robustness import compute_robustness, init_robustness

PIPELINES = ("auto", "scan", "chunked", "fused", "vmapped")


def _use_tiled(config):
    """Whether the merge is tiled (the JAX package's ``_use_tiled``):
    ``tpu.merge_impl`` "gather" is not, nor "auto" (the default) at a
    fractional scale; any other value at a fractional scale raises
    ``ValueError``; everything else is."""
    impl = config.get("tpu", {}).get("merge_impl", "auto")
    if impl == "gather" or (impl == "auto" and not integer_scale(config)):
        return False
    if not integer_scale(config):
        raise ValueError("tiled merge requires an integer scale")
    return True


def check_supported(config):
    """Raise ``NotImplementedError`` for an unknown pipeline form, and
    ``ValueError`` for a tiled ``tpu.merge_impl`` at a fractional scale and
    for the chunked form where the merge is not tiled."""
    mode = config.get("tpu", {}).get("pipeline", "auto")
    if mode not in PIPELINES:
        raise NotImplementedError(f"tpu.pipeline={mode!r}: the forms are "
                                  f"{', '.join(PIPELINES)}")
    if not _use_tiled(config) and mode == "chunked":
        raise ValueError("tpu.pipeline=chunked requires an integer scale "
                         "(tiled merge geometry)")


def pipeline_form(config):
    """The form :func:`run_pipeline` runs: ``tpu.pipeline``, with "auto"
    the fused form where the merge is tiled and the scan form otherwise (the
    JAX package's choice off the TPU), and "fused" the scan form where the
    merge is not tiled (``fused = pipe_mode == "fused" and
    _use_tiled(config)``)."""
    mode = config.get("tpu", {}).get("pipeline", "auto")
    if mode == "auto":
        mode = "fused"
    if mode == "fused" and not _use_tiled(config):
        return "scan"
    return mode


def select_merge(config):
    """The merge of a compared frame: K5 (:func:`.merge_tiled.merge_tiled`)
    where the merge is tiled (:func:`_use_tiled`; the JAX package's
    ``merge_tiled`` and ``merge_pallas``), the gather merge
    (:func:`.merge.merge`) otherwise."""
    return merge_tiled if _use_tiled(config) else merge


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
    with span("align"):
        align_state = init_alignment(to_grey(ref_img, config), config)
    with span("robustness"):
        ref_stats = init_robustness(ref_img, cfa_pattern, white_balance, curves,
                                    config)
    return align_state, ref_stats


def frame_step(frame, align_state, ref_stats, config, cfa_pattern, white_balance,
               weight=None):
    """The analysis of one compared frame: ``(flow, r, covs)``, its flow on
    the raw tile grid (grey, align, the decimating grey's conversion), its
    robustness map (times ``weight`` where one is given: the sharded
    pipeline's zero-weight padding frames) and its kernel covariances."""
    with span("align"):
        flow = to_raw_flow(align(align_state, to_grey(frame, config), config),
                           frame.shape, config)
    with span("robustness"):
        r = compute_robustness(frame, ref_stats, flow, cfa_pattern, white_balance,
                               config)
        if weight is not None:
            r = r * weight
    with span("kernels"):
        covs = estimate_kernels(frame, config)
    return flow, r, covs


def merge_reference(ref_img, num, den, cfa_pattern, config, acc_r=None,
                    row_offset=0):
    """The reference frame's merge into (num, den) in place, with the
    accumulated-robustness denoiser when it is enabled (``acc_r``)."""
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    with span("kernels"):
        covs = estimate_kernels(ref_img, config)
    with span("merge"):
        return merge_ref_tiled(ref_img, covs, num, den, cfa_pattern, config,
                               acc_rob=acc_r if denoise else None, row_offset=row_offset)


def normalize_image(num, den):
    """The border-strip refill and divide of the whole accumulators, one
    launch of K7 on the card (:func:`~..ops.cuda_merge.refill_image`): the
    ``(round(s H), round(s W), c)`` image."""
    with span("merge"):
        return refill_image(num, den, REFILL_BORDER).permute(1, 2, 0)


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
    with span("merge"):
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
    form = pipeline_form(config)
    stacked = form != "scan"            # every frame analysed before any merge
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    accumulate_r = denoise or bool(config.robustness.save_mask)

    ref_img = _as_tensor(ref_img, device)
    comp_imgs = _as_tensor(comp_imgs, device)
    curves = (_as_tensor(std_curve, device), _as_tensor(diff_curve, device))

    align_state, ref_stats = init_reference(ref_img, curves, config, cfa_pattern,
                                            white_balance)

    merge_frame = select_merge(config)
    acc_r = torch.zeros(ref_img.shape, dtype=DEFAULT_FLOAT, device=device) \
        if accumulate_r else None
    if form != "fused":
        num = torch.zeros(accum_shape(config, ref_img.shape), dtype=DEFAULT_FLOAT,
                          device=device)
        den = torch.zeros_like(num)
    flows, rmaps, covs_list = [], [], []
    for frame in comp_imgs:
        flow, r, covs = frame_step(frame, align_state, ref_stats, config,
                                   cfa_pattern, white_balance)
        if acc_r is not None and form != "vmapped":
            acc_r = acc_r + r
        if stacked:
            covs_list.append(covs)
        else:
            with span("merge"):
                merge_frame(frame, flow, covs, r, num, den, cfa_pattern, config)
        if debug_mode or stacked:
            flows.append(flow)
            rmaps.append(r)
    # the stacks replace the per-frame lists, so that no frame's maps are
    # held twice (the stacked analysis peaks at the stacks)
    flow_stack = torch.stack(flows).to(DEFAULT_FLOAT) if flows else None
    r_stack = torch.stack(rmaps) if rmaps else None
    del flows, rmaps
    covs_stack = torch.stack(covs_list) if covs_list else None
    del covs_list
    if form == "vmapped" and acc_r is not None and r_stack is not None:
        acc_r = r_stack.sum(0)          # a reduction, as JAX's jnp.sum
    if form == "chunked" and flow_stack is not None:
        _merge_burst_chunked(comp_imgs.contiguous(), flow_stack, covs_stack, r_stack,
                             num, den, cfa_pattern, config)
    elif form == "vmapped" and flow_stack is not None:
        for f in range(len(comp_imgs)):
            with span("merge"):
                merge_frame(comp_imgs[f], flow_stack[f], covs_stack[f], r_stack[f], num,
                            den, cfa_pattern, config)
    if form == "fused":
        with span("kernels"):
            ref_covs = estimate_kernels(ref_img, config)
        image = merge_burst_fused(ref_img, ref_covs, comp_imgs, flow_stack, covs_stack,
                                  r_stack, cfa_pattern, config, acc_r)
    else:
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


def merge_burst_fused(ref_img, ref_covs, comp_imgs, flow_stack, covs_stack, r_stack,
                      cfa_pattern, config, acc_r=None):
    """The fused form's merge: the stacked frames and the reference frame
    (with its covariances ``ref_covs``) through K6, then the refill per
    B-row slab (``tpu.fused_impl: slab``, the default) or per (B, B) tile
    (any other value); the ``(round(s H), round(s W), c)`` image. A burst
    of the reference alone (no stacks) merges no compared frame."""
    denoise = bool(config.accumulated_robustness_denoiser.get("enabled", False))
    if flow_stack is None:
        H, W = ref_img.shape
        ny, nx = (-(-n // int(config.block_matching.tuning.tile_size)) for n in (H, W))
        flow_stack = ref_img.new_zeros((0, ny, nx, 2))
        r_stack = ref_img.new_zeros((0, H, W))
    if covs_stack is None:
        covs_stack = ref_covs.new_zeros((0, *ref_covs.shape))
    slab = config.get("tpu", {}).get("fused_impl", "slab") == "slab"
    fused_impl = merge_burst_slab if slab else merge_burst_tiled
    with span("merge"):
        image = fused_impl(comp_imgs.contiguous(), flow_stack, covs_stack, r_stack, ref_img,
                           ref_covs, cfa_pattern, config,
                           acc_rob=acc_r if denoise else None)
        return image.permute(1, 2, 0)


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
