"""Merge accumulation (twin of :mod:`hmsr_tpu.models.merge_tiled`).

- :func:`merge_tiled` accumulates a non-reference frame (Alg. 4) through K5
  (:func:`hmsr_tpu_torch.ops.cuda_merge.merge_accumulate`), in place, at an
  integer scale (a fractional one takes :func:`.merge.merge`).
- :func:`merge_ref_tiled` accumulates the reference frame (Alg. 11) at any
  scale with torch ops (:func:`hmsr_tpu_torch.ops.cuda_merge.merge_ref_plain`,
  which is also K6's reference step): the JAX package runs it as XLA, not
  Pallas. It is written in the direct gather form of
  :func:`hmsr_tpu.models.merge.merge_ref` and evaluated in bands of HR rows
  so that no full-size tap temporaries exist (``merge_ref_banded`` of the
  JAX pipeline at a fractional scale, ``merge_ref_tiled`` at an integer
  one: the same function).

Both take every variant of the JAX package's merge: Bayer or grey mode
(``mode``), the steerable or the isotropic kernel (``merging.kernel``), and
for the reference frame the accumulated-robustness denoiser (``acc_rob``).
Both also take a band of the accumulators (``row_offset``: ``num``/``den``
hold global HR rows ``row_offset ..``), the sharded pipeline's space axis.
"""

from ..ops.cuda_merge import merge_accumulate, merge_ref_plain
from ..utils.types import DEFAULT_FLOAT


def integer_scale(config):
    """Whether the configuration's scale is an integer (K5 and K5' serve
    it; a fractional scale takes the gather merge)."""
    return float(config.scale) == int(config.scale)


def check_merge_config(config):
    """The merge geometry of K5 and K5': an integer scale of at least 1
    (returned). Raises ``ValueError`` otherwise."""
    s = int(config.scale)
    if not integer_scale(config) or s < 1:
        raise ValueError(f"the tiled merge needs an integer scale, got {config.scale}")
    return s


def merge_variant(config):
    """``(grey, iso)``: grey mode (one accumulator plane, covariances on the
    raw grid, no CFA pick) and the isotropic kernel, as the JAX package
    reads them (anything but ``bayer`` is grey, anything but ``iso`` is
    steerable)."""
    return config.mode != "bayer", config.merging.kernel == "iso"


def merge_tiled(comp_img, flow, covs, r, num, den, cfa_pattern, config,
                row_offset=0):
    """Accumulate a non-reference frame into (num, den) in place; returns
    the pair. With ``row_offset`` (a multiple of ``Ts*s``) they are a band
    of global HR rows from there (K5's banded branch)."""
    s = check_merge_config(config)
    grey, iso = merge_variant(config)
    return merge_accumulate(comp_img.contiguous(), flow.to(DEFAULT_FLOAT).contiguous(),
                            covs.contiguous(), r.contiguous(), num, den,
                            cfa_pattern, int(config.block_matching.tuning.tile_size), s,
                            grey, iso, row_offset)


def merge_ref_tiled(ref_img, covs, num, den, cfa_pattern, config, acc_rob=None,
                    band_rows=512, row_offset=0):
    """Accumulate the reference frame into (num, den) (c, round(s H),
    round(s W)) in place, at any scale s; returns the pair.

    The HR pixel R sits at ``R/s`` (no half-pixel shift); its taps are
    centred on ``round(R/s)``, and the covariance inverse is guarded. Bayer
    mode interpolates the covariance at ``(R/s - 0.5) / 2`` on the grey
    grid, grey mode at ``R/s`` on the raw grid (the JAX package's two kmaps,
    kept as they are). With ``accumulated_robustness_denoiser.enabled`` and
    ``acc_rob`` (H, W), the taps widen to ``merge.rad_max``: where the
    nearest-resampled ``acc_rob`` is at most ``merge.max_frame_count`` the
    pixel takes them all and divides ``z`` by ``merge.max_multiplier`` (else
    3x3 taps, ``z`` as it is), and where it is below the count the
    reference's sums replace num/den instead of adding to them.

    ``num``/``den`` hold global HR rows ``row_offset ..`` (the whole image
    by default); rows past the image are evaluated as any other, and
    cropped by the caller.
    """
    grey, iso = merge_variant(config)
    ard = config.accumulated_robustness_denoiser
    denoise = bool(ard.get("enabled", False)) and acc_rob is not None
    kw = dict(acc_rob=acc_rob, rad_max=int(ard.merge.rad_max),
              max_multiplier=float(ard.merge.max_multiplier),
              max_frame_count=float(ard.merge.max_frame_count)) if denoise else {}
    return merge_ref_plain(ref_img, covs, num, den, cfa_pattern, config.scale, grey,
                           iso, band_rows=band_rows, row_offset=row_offset, **kw)
