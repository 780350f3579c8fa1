"""Gather merge of a non-reference frame at any scale (twin of
:func:`hmsr_tpu.models.merge.merge`), the merge the pipeline takes for a
fractional scale; integer scales take K5 (:mod:`.merge_tiled`).

Conventions kept exactly (``hmsr_tpu/models/merge.py``, module docstring):
the LR position of HR pixel ``hr`` is ``(hr + 0.5) / s``; its flow tile is
``lr // tile_size``, clipped to the flow grid; robustness is read nearest at
``min(int(lr), size - 1)``; a warped centre outside the frame contributes
nothing; the covariance is interpolated at ``lr_mov / 2 - 0.5`` on the grey
grid (Bayer) or ``lr_mov - 0.5`` on the raw grid (grey mode), with
truncation and signed fractions, and inverted without a guard (``1 / det``);
the 3x3 gather is centred on ``int(lr_mov)``, distances are taken to
``lr_mov - 0.5``, and a tap outside the frame has zero weight.

Plain torch: the JAX package runs this merge as XLA, not Pallas. It is
evaluated in bands of HR rows on the accumulators in place, so that no
full-size per-tap temporaries exist at 48 MP outputs. Bands of 512 rows
(12 MB temporaries at 6000 columns) took 6 % less device time per x1.5
burst than bands of 8 M pixels, at twice the launches and the same wall
(PERF.md, section 6).
"""

import numpy as np
import torch

from ..ops.cuda_merge import accumulate_tap, interp_cov, quad_form, scale_divisor
from ..utils.types import DEFAULT_FLOAT
from .merge_tiled import merge_variant


def lr_positions(hr, scale, tile_size):
    """For integer HR coordinates ``hr``: the LR coordinate ``(hr + 0.5) /
    scale``, its flow tile ``lr // tile_size`` and its robustness index
    ``int(lr)`` (int64, not yet clipped). Both divisors are device tensors:
    a Python number would divide through its rounded reciprocal on the card
    (:func:`scale_divisor`)."""
    dev = hr.device
    lr = (hr.to(DEFAULT_FLOAT) + 0.5) / scale_divisor(scale, dev)
    tile = torch.div(lr, scale_divisor(tile_size, dev), rounding_mode="floor")
    return lr, tile.to(torch.int64), lr.to(torch.int64)


def merge(comp_img, flow, covs, r, num, den, cfa_pattern, config, band_rows=512,
          row_offset=0):
    """Accumulate a non-reference frame into ``num``/``den`` (c, round(s H),
    round(s W)) in place; returns the pair. ``flow``: (ny, nx, 2) per raw
    tile; ``covs``: (3, gh, gw); ``r``: (H, W) robustness. With
    ``row_offset`` the accumulators are a band of HR rows from that global
    row (the sharded pipeline's space axis)."""
    grey, iso = merge_variant(config)
    cfa = None if grey else np.asarray(cfa_pattern, dtype=np.int64)
    lr_h, lr_w = comp_img.shape
    n_ch, out_h, out_w = num.shape
    dev = comp_img.device
    flow = flow.to(DEFAULT_FLOAT)
    fh, fw = flow.shape[:2]
    zero = torch.zeros((), dtype=DEFAULT_FLOAT, device=dev)
    scale, ts = config.scale, config.block_matching.tuning.tile_size
    lr_x, px, rj = lr_positions(torch.arange(out_w, device=dev)[None, :], scale, ts)
    px = px.clamp(0, fw - 1)
    rj = rj.clamp(max=lr_w - 1)
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        lr_y, py, ri = lr_positions(
            torch.arange(row_offset + y0, row_offset + y1, device=dev)[:, None], scale, ts)
        py = py.clamp(0, fh - 1)
        ri = ri.clamp(max=lr_h - 1)
        lr_mov_x = lr_x + flow[py, px, 0]
        lr_mov_y = lr_y + flow[py, px, 1]
        inbound = (lr_mov_x >= 0) & (lr_mov_x < lr_w) & (lr_mov_y >= 0) & \
            (lr_mov_y < lr_h)
        inv = None
        if not iso:
            if grey:
                kmap_x, kmap_y = lr_mov_x - 0.5, lr_mov_y - 0.5
            else:
                kmap_x, kmap_y = lr_mov_x / 2.0 - 0.5, lr_mov_y / 2.0 - 0.5
            cxx, cxy, cyy = interp_cov(covs, kmap_y, kmap_x)
            inv_det = 1.0 / (cxx * cyy - cxy * cxy)     # unguarded, as in JAX
            inv = (inv_det * cyy, -inv_det * cxy, inv_det * cxx)
        center_i, center_j = lr_mov_y.to(torch.int64), lr_mov_x.to(torch.int64)
        dist_ref_x, dist_ref_y = lr_mov_x - 0.5, lr_mov_y - 0.5
        wr = torch.where(inbound, r[ri, rj], zero)

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in (-1, 0, 1):
            i = center_i + di
            inb_i = (i >= 0) & (i < lr_h)
            dist_y = i.to(DEFAULT_FLOAT) - dist_ref_y
            for dj in (-1, 0, 1):
                j = center_j + dj
                inb = inb_i & (j >= 0) & (j < lr_w)
                c = comp_img[i.clamp(0, lr_h - 1), j.clamp(0, lr_w - 1)]
                z = quad_form(inv, j.to(DEFAULT_FLOAT) - dist_ref_x, dist_y)
                w = torch.exp(-0.5 * z) * wr * inb
                accumulate_tap(vals, accs, w, c, i, j, cfa)
        num[:, y0:y1] += torch.stack(vals, 0)
        den[:, y0:y1] += torch.stack(accs, 0)
    return num, den
