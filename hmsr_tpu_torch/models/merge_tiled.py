"""Merge accumulation (twin of :mod:`hmsr_tpu.models.merge_tiled`).

- :func:`merge_tiled` accumulates a non-reference frame (Alg. 4) through K5
  (:func:`hmsr_tpu_torch.ops.cuda_merge.merge_accumulate`), in place, at an
  integer scale (a fractional one takes :func:`.merge.merge`).
- :func:`merge_ref_tiled` accumulates the reference frame (Alg. 11) at any
  scale with torch ops: the JAX package runs it as XLA, not Pallas. It is
  written in the direct gather form of :func:`hmsr_tpu.models.merge.merge_ref`
  and evaluated in bands of HR rows so that no full-size tap temporaries
  exist (``merge_ref_banded`` of the JAX pipeline at a fractional scale,
  ``merge_ref_tiled`` at an integer one: the same function).

Both take every variant of the JAX package's merge: Bayer or grey mode
(``mode``), the steerable or the isotropic kernel (``merging.kernel``), and
for the reference frame the accumulated-robustness denoiser (``acc_rob``).
Both also take a band of the accumulators (``row_offset``: ``num``/``den``
hold global HR rows ``row_offset ..``), the sharded pipeline's space axis.
"""

import numpy as np
import torch

from ..ops.cuda_merge import accumulate_tap, merge_accumulate, quad_form, scale_divisor
from ..utils.types import DEFAULT_FLOAT, EPSILON_DIV


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


def _interp_cov(covs, kmap_i, kmap_j):
    """Bilinear covariance interpolation with signed (truncation) fractions
    and the lower index clamped at 0 (``hmsr_tpu.models.merge._interp_cov``);
    an index past the grid reads its last row or column, as JAX's gather
    clamps it."""
    gh, gw = covs.shape[1], covs.shape[2]
    iy, ix = torch.trunc(kmap_i), torch.trunc(kmap_j)
    frac_y, frac_x = kmap_i - iy, kmap_j - ix
    fy = torch.clamp(iy.long(), 0, gh - 1)
    fx = torch.clamp(ix.long(), 0, gw - 1)
    cy = torch.clamp(fy + 1, max=gh - 1)
    cx = torch.clamp(fx + 1, max=gw - 1)
    out = []
    for k in range(3):
        tr, tl = covs[k, fy, fx], covs[k, fy, cx]
        br, bl = covs[k, cy, fx], covs[k, cy, cx]
        top = tr + frac_x * (tl - tr)
        bot = br + frac_x * (bl - br)
        out.append(top + frac_y * (bot - top))
    return out


def _inverse(cc):
    """The guarded 2x2 inverse (ixx, ixy, iyy) of merge_ref: identity where
    |det| <= EPSILON_DIV."""
    cxx, cxy, cyy = cc
    det = cxx * cyy - cxy * cxy
    ok = torch.abs(det) > EPSILON_DIV
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one), one)
    return (torch.where(ok, inv_det * cyy, one),
            torch.where(ok, -inv_det * cxy, torch.zeros_like(det)),
            torch.where(ok, inv_det * cxx, one))


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
    cfa = None if grey else np.asarray(cfa_pattern, dtype=np.int64)
    ard = config.accumulated_robustness_denoiser
    denoise = bool(ard.get("enabled", False)) and acc_rob is not None
    rad_max = int(ard.merge.rad_max) if denoise else 1
    taps = range(-rad_max, rad_max + 1)
    H, W = ref_img.shape
    n_ch, out_h, out_w = num.shape
    dev = ref_img.device

    s_dev = scale_divisor(config.scale, dev)
    pos_x = torch.arange(out_w, dtype=DEFAULT_FLOAT, device=dev)[None, :] / s_dev
    center_x = torch.round(pos_x).long()
    kmap_x = pos_x if grey else (pos_x - 0.5) / 2.0
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        pos_y = torch.arange(row_offset + y0, row_offset + y1, dtype=DEFAULT_FLOAT,
                             device=dev)[:, None] / s_dev
        center_y = torch.round(pos_y).long()
        inv = None
        if not iso:
            kmap_y = pos_y if grey else (pos_y - 0.5) / 2.0
            inv = _inverse(_interp_cov(covs, kmap_y, kmap_x))
        if denoise:
            local_acc_r = acc_rob[center_y.clamp(0, H - 1), center_x.clamp(0, W - 1)]
            few = local_acc_r <= float(ard.merge.max_frame_count)
            power = torch.where(few, float(ard.merge.max_multiplier), 1.0)
            rad = torch.where(few, rad_max, 1)

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in taps:
            i = center_y + di
            inb_i = (i >= 0) & (i < H)
            dist_y = i.to(DEFAULT_FLOAT) - pos_y
            for dj in taps:
                j = center_x + dj
                inb = inb_i & (j >= 0) & (j < W)
                z = quad_form(inv, j.to(DEFAULT_FLOAT) - pos_x, dist_y)
                if denoise:
                    inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
                    z = z / power
                c = ref_img[i.clamp(0, H - 1), j.clamp(0, W - 1)]
                w = torch.exp(-0.5 * z) * inb
                accumulate_tap(vals, accs, w, c, i, j, cfa)
        val, acc = torch.stack(vals, 0), torch.stack(accs, 0)
        if denoise:
            overwrite = local_acc_r < float(ard.merge.max_frame_count)
            num[:, y0:y1] = torch.where(overwrite, val, num[:, y0:y1] + val)
            den[:, y0:y1] = torch.where(overwrite, acc, den[:, y0:y1] + acc)
        else:
            num[:, y0:y1] += val
            den[:, y0:y1] += acc
    return num, den
