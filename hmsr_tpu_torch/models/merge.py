"""Gather merge of a non-reference frame at any scale (twin of
:func:`hmsr_tpu.models.merge.merge`), the merge the pipeline takes where the
merge is not tiled (a fractional scale, or ``tpu.merge_impl: gather``:
:func:`.pipeline.route_of`);
tiled merges take K5 (:mod:`.merge_tiled`).

Conventions kept exactly (``hmsr_tpu/models/merge.py``, module docstring):
the LR position of HR pixel ``hr`` is ``(hr + 0.5) / s``; its flow tile is
``lr // tile_size``, clipped to the flow grid; robustness is read nearest at
``min(int(lr), size - 1)``; a warped centre outside the frame contributes
nothing; the covariance is interpolated at ``lr_mov / 2 - 0.5`` on the grey
grid (Bayer) or ``lr_mov - 0.5`` on the raw grid (grey mode), with
truncation and signed fractions, and inverted without a guard (``1 / det``);
the 3x3 gather is centred on ``int(lr_mov)``, distances are taken to
``lr_mov - 0.5``, and a tap outside the frame has zero weight.

On the card one launch of K11 a frame
(:func:`~..ops.cuda_merge.gather_merge_accumulate`, ``csrc/merge_gather.cu``);
on the CPU its plain version (:func:`~..ops.cuda_merge.gather_merge_plain`),
evaluated in bands of HR rows on the accumulators in place, so that no
full-size per-tap temporaries exist at 48 MP outputs.
"""

from ..ops.cuda_merge import gather_merge_accumulate, lr_positions  # noqa: F401
from ..utils.types import DEFAULT_FLOAT
from .merge_tiled import merge_variant


def merge(comp_img, flow, covs, r, num, den, cfa_pattern, config, band_rows=512,
          row_offset=0):
    """Accumulate a non-reference frame into ``num``/``den`` (c, round(s H),
    round(s W)) in place; returns the pair. ``flow``: (ny, nx, 2) per raw
    tile; ``covs``: (3, gh, gw); ``r``: (H, W) robustness. With
    ``row_offset`` the accumulators are a band of HR rows from that global
    row (the sharded pipeline's space axis). ``band_rows``: the plain
    version's bands (CPU tensors)."""
    grey, iso = merge_variant(config)
    return gather_merge_accumulate(
        comp_img.contiguous(), flow.to(DEFAULT_FLOAT).contiguous(), covs.contiguous(),
        r.contiguous(), num, den, cfa_pattern, config.block_matching.tuning.tile_size,
        config.scale, grey, iso, row_offset, band_rows)
