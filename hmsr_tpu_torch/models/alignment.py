"""Coarse-to-fine alignment (twin of :mod:`hmsr_tpu.models.alignment`).

Per frame: a Gaussian pyramid descent of {upscale flow -> integer block
matching -> ``n_iter`` ICA Gauss-Newton steps} on every level. The reference
grey image is wrap-padded to a tile-size multiple and its pyramid, tiles,
gradients and Hessians are computed once per burst; the moving pyramid is
built from the unpadded frame. The Gauss-Newton solve terms of every level
come with the reference state (:func:`hmsr_tpu_torch.models.ica.init_ica`).

A level with at least :data:`FUSED_GN_MAX_TILES` tiles runs K1 once and
then its ``n_iter`` Gauss-Newton steps in one K2 launch. A smaller level
runs its steps in one K3 launch, which also does the search when it is L1
with radius 1 (else K1 runs first), as the JAX package picks its fused
kernel.
"""

from typing import List, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.pyramid import build_gaussian_pyramid
from ..utils.types import DEFAULT_FLOAT
from .block_matching import match_l1, match_l2
from .ica import IcaRefState, init_ica, refine_ica_fused, refine_ica_tiled

#: below this many tiles a level runs K3 (``pallas_ica.FUSED_GN_MAX_TILES``;
#: the JAX package counts a level's tile rows padded to its TPU lane group,
#: which picks the same levels on the main path).
FUSED_GN_MAX_TILES = 2000


class AlignmentRefState(NamedTuple):
    """Per-burst reference-frame state (coarse-first lists)."""
    pyramid: List[torch.Tensor]     # level images
    tiles: List[torch.Tensor]       # (ny, nx, ts, ts) views of the levels
    ica: List[IcaRefState]


def _level_tile_sizes(config):
    """(factor, tile_size, radius, metric) per level, coarse-first."""
    t = config.block_matching.tuning
    n = len(t.factors)
    return [(t.factors[n - l - 1], t.tile_sizes[n - l - 1],
             t.search_radii[n - l - 1], t.metrics[n - l - 1]) for l in range(n)]


def _unfold_tiles(lvl, ts):
    h, w = lvl.shape
    ny, nx = h // ts, w // ts
    return lvl[:ny * ts, :nx * ts].reshape(ny, ts, nx, ts).permute(0, 2, 1, 3)


def _wrap_pad(img, pad_b, pad_r):
    h, w = img.shape
    rows = torch.arange(h + pad_b, device=img.device) % h
    cols = torch.arange(w + pad_r, device=img.device) % w
    return img[rows[:, None], cols[None, :]]


def init_alignment(ref_grey, config):
    """Precompute the alignment state of the reference image."""
    t = config.block_matching.tuning
    Ts = int(t.tile_size)
    h, w = ref_grey.shape
    padded = _wrap_pad(ref_grey, (Ts - h % Ts) % Ts, (Ts - w % Ts) % Ts)
    pyramid = [lvl.contiguous() for lvl in build_gaussian_pyramid(padded, t.factors)]
    tiles, ica_states = [], []
    for lvl, (_, ts, _, _) in zip(pyramid, _level_tile_sizes(config)):
        tiles.append(_unfold_tiles(lvl, ts))
        ica_states.append(init_ica(lvl, ts))
    return AlignmentRefState(pyramid=pyramid, tiles=tiles, ica=ica_states)


def upscale_flow(flow, npatches, list_id, config):
    """Re-tile + rescale the flow for the next (finer) pyramid level."""
    t = config.block_matching.tuning
    new_ts = t.tile_sizes[list_id]
    prev_ts = t.tile_sizes[list_id + 1]
    factor = t.factors[list_id + 1]
    repeat = factor // (new_ts // prev_ts)

    if repeat == 1:
        up = flow
    elif t.flow_upscale_mode == "nearest":
        up = flow.repeat_interleave(repeat, dim=0).repeat_interleave(repeat, dim=1)
    else:
        raise NotImplementedError(
            f"flow_upscale_mode={t.flow_upscale_mode!r} is not ported; "
            f"only 'nearest' is")
    up = up * float(factor)

    ny, nx = npatches
    if up.shape[0] < ny or up.shape[1] < nx:
        up = F.pad(up, (0, 0, 0, nx - up.shape[1], 0, ny - up.shape[0]))
    return up


def align(ref_state, moving_grey, config):
    """Per-tile optical flow of ``moving_grey`` against the reference:
    (ny, nx, 2) in (x, y) raw-pixel units at the finest level."""
    t = config.block_matching.tuning
    n_iter = config.ica.tuning.n_iter
    moving_pyramid = build_gaussian_pyramid(moving_grey, t.factors)
    levels = _level_tile_sizes(config)
    n_lvls = len(levels)

    flow = None
    for l, (_, ts, radius, metric) in enumerate(levels):
        list_id = n_lvls - l - 1
        npatches = ref_state.tiles[l].shape[:2]
        if flow is None:
            flow = torch.zeros((*npatches, 2), dtype=DEFAULT_FLOAT,
                               device=moving_grey.device)
        else:
            flow = upscale_flow(flow, npatches, list_id, config)

        moving_lvl = moving_pyramid[l].contiguous()
        fused = npatches[0] * npatches[1] < FUSED_GN_MAX_TILES
        if fused and metric == "L1" and radius == 1:
            flow = refine_ica_fused(ref_state.pyramid[l], ref_state.ica[l],
                                    moving_lvl, flow, ts, n_iter, bm=True)
            continue
        if metric == "L2":
            flow = match_l2(ref_state.tiles[l], moving_lvl, flow, ts, radius)
        elif metric == "L1":
            flow = match_l1(ref_state.pyramid[l], moving_lvl, flow, ts, radius)
        else:
            raise ValueError(f"Unknown block matching metric {metric}")
        refine = refine_ica_fused if fused else refine_ica_tiled
        flow = refine(ref_state.pyramid[l], ref_state.ica[l], moving_lvl, flow,
                      ts, n_iter)
    return flow
