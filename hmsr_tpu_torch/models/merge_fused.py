"""The fused pipeline's burst merges (twins of
:mod:`hmsr_tpu.models.merge_slab` and :mod:`hmsr_tpu.models.merge_fused`).

Both merge the whole burst and the reference frame in one pass per HR tile
and return the finished image. The JAX package runs them as XLA; here the
accumulation is one launch of K6
(:func:`hmsr_tpu_torch.ops.cuda_merge.merge_fused_accumulate`: every frame,
then the reference frame, at the padded geometry ``(c, nty*B, ntx*B)``,
``B = Ts*s``), and the two differ only in how they normalize:

- :func:`merge_burst_slab` (``tpu.fused_impl: slab``, the default) refills
  and divides each B-row slab on its own;
- :func:`merge_burst_tiled` (any other ``fused_impl``) each (B, B) tile.

Either refill covers every starved pixel of its group, interior included,
with no context past the group's edges (the padded rows and columns take
part, as in the JAX package); the image is then cropped to
``(c, round(s H), round(s W))``. Integer scales only.
"""

from ..ops.accumfix import normalize_groups
from ..ops.cuda_merge import merge_fused_accumulate
from ..utils.types import DEFAULT_FLOAT
from .merge_tiled import check_merge_config, merge_variant


def _merge_fused(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                 cfa_pattern, config, acc_rob, tiles):
    s = check_merge_config(config)
    grey, iso = merge_variant(config)
    Ts = int(config.block_matching.tuning.tile_size)
    ard = config.accumulated_robustness_denoiser
    kw = {}
    if bool(ard.get("enabled", False)) and acc_rob is not None:
        kw = dict(acc_rob=acc_rob.contiguous(), rad_max=int(ard.merge.rad_max),
                  max_multiplier=float(ard.merge.max_multiplier),
                  max_frame_count=float(ard.merge.max_frame_count))
    num, den = merge_fused_accumulate(
        comp_stack.contiguous(), flows.to(DEFAULT_FLOAT).contiguous(),
        covs_stack.contiguous(), r_stack.contiguous(), ref_img.contiguous(),
        ref_covs.contiguous(), cfa_pattern, Ts, s, grey, iso, **kw)
    H, W = ref_img.shape
    image = normalize_groups(num, den, Ts * s, tiles)
    return image[:, :H * s, :W * s]


def merge_burst_slab(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                     cfa_pattern, config, acc_rob=None):
    """The fused merge of the whole burst, normalized per B-row slab;
    returns the ``(c, H*s, W*s)`` image. ``comp_stack``, ``r_stack``: (F, H,
    W); ``flows``: (F, ny, nx, 2); ``covs_stack``: (F, 3, gh, gw);
    ``ref_img``, ``ref_covs``: the reference frame and its covariances;
    ``acc_rob``: the accumulated robustness, read when the configuration's
    accumulated-robustness denoiser is enabled."""
    return _merge_fused(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                        cfa_pattern, config, acc_rob, tiles=False)


def merge_burst_tiled(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                      cfa_pattern, config, acc_rob=None):
    """:func:`merge_burst_slab` normalized per (B, B) tile."""
    return _merge_fused(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                        cfa_pattern, config, acc_rob, tiles=True)
