"""Merge accumulation (twin of :mod:`hmsr_tpu.models.merge_tiled`).

- :func:`merge_tiled` accumulates a non-reference frame (Alg. 4) through K5
  (:func:`hmsr_tpu_torch.ops.cuda_merge.merge_accumulate`), in place.
- :func:`merge_ref_tiled` accumulates the reference frame (Alg. 11) with
  torch ops: the JAX package runs it as XLA, not Pallas. It is written in the
  direct gather form of :func:`hmsr_tpu.models.merge.merge_ref` and
  evaluated in bands of HR rows so that no full-size 3x3 temporaries exist.
"""

import numpy as np
import torch

from ..ops.cuda_merge import accumulate_tap, merge_accumulate, scale_divisor, tap_weight
from ..utils.types import DEFAULT_FLOAT, EPSILON_DIV


def check_merge_config(config):
    """The merge geometry the port supports: Bayer mode, the steerable
    kernel, an integer scale (returned). Raises ``NotImplementedError``
    otherwise."""
    s = int(config.scale)
    if s != config.scale or s < 1:
        raise NotImplementedError(f"non-integer scale {config.scale} is not ported")
    if config.mode != "bayer":
        raise NotImplementedError(f"mode={config.mode!r} is not ported")
    if config.merging.kernel != "steerable":
        raise NotImplementedError(
            f"merging.kernel={config.merging.kernel!r} is not ported")
    return s


def merge_tiled(comp_img, flow, covs, r, num, den, cfa_pattern, config):
    """Accumulate a non-reference frame into (num, den) in place; returns
    the pair."""
    s = check_merge_config(config)
    return merge_accumulate(comp_img.contiguous(), flow.to(DEFAULT_FLOAT).contiguous(),
                            covs.contiguous(), r.contiguous(), num, den,
                            cfa_pattern, int(config.block_matching.tuning.tile_size), s)


def _interp_cov(covs, kmap_i, kmap_j):
    """Bilinear covariance interpolation with signed (truncation) fractions
    and the lower index clamped at 0 (``hmsr_tpu.models.merge._interp_cov``)."""
    gh, gw = covs.shape[1], covs.shape[2]
    iy, ix = torch.trunc(kmap_i), torch.trunc(kmap_j)
    frac_y, frac_x = kmap_i - iy, kmap_j - ix
    fy = torch.clamp(iy.long(), min=0)
    fx = torch.clamp(ix.long(), min=0)
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


def merge_ref_tiled(ref_img, covs, num, den, cfa_pattern, config, acc_rob=None,
                    band_rows=512):
    """Accumulate the reference frame into (num, den) in place; returns the
    pair. The accumulated-robustness denoiser branch is not ported."""
    if acc_rob is not None:
        raise NotImplementedError("the accumulated-robustness merge is not ported")
    s = check_merge_config(config)
    cfa = np.asarray(cfa_pattern, dtype=np.int64)
    H, W = ref_img.shape
    n_ch, out_h, out_w = num.shape
    dev = ref_img.device

    s_dev = scale_divisor(s, dev)
    pos_x = torch.arange(out_w, dtype=DEFAULT_FLOAT, device=dev)[None, :] / s_dev
    center_x = torch.round(pos_x).long()
    grey_x = (pos_x - 0.5) / 2.0
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        pos_y = torch.arange(y0, y1, dtype=DEFAULT_FLOAT, device=dev)[:, None] / s_dev
        center_y = torch.round(pos_y).long()
        cxx, cxy, cyy = _interp_cov(covs, (pos_y - 0.5) / 2.0, grey_x)
        det = cxx * cyy - cxy * cxy
        ok = torch.abs(det) > EPSILON_DIV
        one = torch.ones_like(det)
        inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one), one)
        ixx = torch.where(ok, inv_det * cyy, one)
        ixy = torch.where(ok, -inv_det * cxy, torch.zeros_like(det))
        iyy = torch.where(ok, inv_det * cxx, one)

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in (-1, 0, 1):
            i = center_y + di
            inb_i = (i >= 0) & (i < H)
            dist_y = i.to(DEFAULT_FLOAT) - pos_y
            for dj in (-1, 0, 1):
                j = center_x + dj
                inb = inb_i & (j >= 0) & (j < W)
                c = ref_img[i.clamp(0, H - 1), j.clamp(0, W - 1)]
                dist_x = j.to(DEFAULT_FLOAT) - pos_x
                w = tap_weight(ixx, ixy, iyy, dist_x, dist_y) * inb
                accumulate_tap(vals, accs, w, c, i, j, cfa)
        num[:, y0:y1] += torch.stack(vals, 0)
        den[:, y0:y1] += torch.stack(accs, 0)
    return num, den
