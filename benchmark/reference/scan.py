"""The plain reference of the scan form at any scale s, fractional ones
included: a raw Bayer burst to the finished image, in plain torch, float32;
imports nothing of the program.

The stages before the merge, the reference frame's merge and the finishing
are those of :mod:`.pipeline` and :mod:`.merge`. What differs from the fused
form is the merge of each compared frame, the accumulators and the refill:

- each compared frame is gathered onto the HR grid (the gather merge,
  Wronski et al. 2019, Alg. 4, as the JAX package's ``models/merge.py``
  states it): the HR pixel ``hr`` sits at the LR position ``lr = (hr +
  0.5) / s``; its flow is that of tile ``lr // Ts``, clipped to the flow
  grid, and moves it to ``lr_mov = lr + flow``; its robustness is read
  nearest at ``min(int(lr), size - 1)``; its covariance is interpolated at
  ``lr_mov / 2 - 0.5`` on the grey grid (truncation, signed fractions) and
  inverted with no guard; the 3x3 taps are centred on ``int(lr_mov)`` and
  their distances taken to ``lr_mov - 0.5``; a warped centre outside the
  frame, or a tap outside it, adds nothing;
- the reference frame's merge is :func:`.merge.merge_reference` at the
  same scale (the pixel at ``R / s``, taps centred on ``round(R / s)``, the
  inverse guarded);
- the accumulators are ``(3, round(s H), round(s W))``, with no padding to
  whole tiles;
- starved pixels (weight under 1e-4) are refilled only within
  :data:`REFILL_BORDER` px of an edge, from two passes of zero-padded 5x5
  sums over the whole image; every other pixel is divided as it is.

Supports the trees that run the scan form with the gather merge: Bayer
mode, the steerable kernel, ``tpu.merge_impl`` "gather" (or "auto" at a
fractional scale), and ``tpu.pipeline`` "scan" (or "auto"/"fused" where the
merge is not tiled, which the program runs as the scan form).
"""

import torch

from .merge import (EPS_DIV, _accumulate, _div, _interp_cov, _quad, _refill_divide,
                    merge_reference)
from .pipeline import _keep, analysis, check_tree, denoiser_of, finish

F32 = torch.float32
#: the width of the border strips in which starved pixels are refilled
REFILL_BORDER = 32


def check_supported(cfg):
    """Refuse, with a ``ValueError`` that names the key, a tree that this
    reference does not implement."""
    check_tree(cfg)
    tpu = cfg.get("tpu", {})
    fractional = float(cfg["scale"]) != int(cfg["scale"])
    impl = tpu.get("merge_impl", "auto")
    gather = impl == "gather" or (impl == "auto" and fractional)
    mode = tpu.get("pipeline", "auto")
    if not (mode == "scan" or (mode in ("auto", "fused") and gather)):
        raise ValueError(f"the scan reference does not implement tpu.pipeline={mode!r} "
                         f"at scale {cfg['scale']} with tpu.merge_impl={impl!r}")
    if not gather:
        raise ValueError(f"the scan reference does not implement tpu.merge_impl={impl!r} "
                         f"at scale {cfg['scale']} (a tiled merge)")


def _lr(hr, s, Ts):
    """The LR position ``(hr + 0.5) / s`` of integer HR coordinates, its
    flow tile ``lr // Ts`` and its robustness index ``int(lr)``, unclipped."""
    lr = _div(hr.to(F32) + 0.5, s)
    tile = torch.div(lr, torch.full((), float(Ts), dtype=F32, device=lr.device),
                     rounding_mode="floor")
    return lr, tile.long(), lr.long()


def merge_gather(comp, flow, covs, r, num, den, cfa, Ts, s, band_rows=512):
    """Add one compared frame to ``num``/``den`` (3, round(sH), round(sW))
    in place, in bands of HR rows."""
    H, W = comp.shape
    fh, fw = flow.shape[:2]
    _, out_h, out_w = num.shape
    dev = comp.device
    zero = torch.zeros((), dtype=F32, device=dev)
    lr_x, tx, rj = _lr(torch.arange(out_w, device=dev)[None, :], s, Ts)
    tx, rj = tx.clamp(0, fw - 1), rj.clamp(max=W - 1)
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        lr_y, ty, ri = _lr(torch.arange(y0, y1, device=dev)[:, None], s, Ts)
        ty, ri = ty.clamp(0, fh - 1), ri.clamp(max=H - 1)
        mx = lr_x + flow[ty, tx, 0].to(F32)
        my = lr_y + flow[ty, tx, 1].to(F32)
        inside = (mx >= 0) & (mx < W) & (my >= 0) & (my < H)
        cc = _interp_cov(covs, _div(my, 2) - 0.5, _div(mx, 2) - 0.5)
        inv_det = 1.0 / (cc[0] * cc[2] - cc[1] * cc[1])
        inv = (inv_det * cc[2], -inv_det * cc[1], inv_det * cc[0])
        wr = torch.where(inside, r[ri, rj], zero)
        ci, cj = my.long(), mx.long()
        vals, accs = [0.0] * 3, [0.0] * 3
        for di in (-1, 0, 1):
            i = ci + di
            inb_i = (i >= 0) & (i < H)
            dy = i.to(F32) - (my - 0.5)
            for dj in (-1, 0, 1):
                j = cj + dj
                inb = inb_i & (j >= 0) & (j < W)
                c = comp[i.clamp(0, H - 1), j.clamp(0, W - 1)]
                w = torch.exp(-0.5 * _quad(inv, j.to(F32) - (mx - 0.5), dy)) * wr * inb
                _accumulate(vals, accs, w, c, i, j, cfa)
        num[:, y0:y1] += torch.stack(vals, 0)
        den[:, y0:y1] += torch.stack(accs, 0)


def refill_border(num, den, border=REFILL_BORDER):
    """The (3, h, w) image: the refill and divide within ``border`` px of an
    edge, the plain divide elsewhere."""
    h, w = num.shape[-2:]
    ys, xs = torch.arange(h, device=num.device), torch.arange(w, device=num.device)
    edge = ((ys < border) | (ys >= h - border))[:, None] \
        | ((xs < border) | (xs >= w - border))[None, :]
    return torch.where(edge, _refill_divide(num, den), num / torch.clamp(den, min=EPS_DIV))


def reference_burst(frames, cfg, cfa, wb, stage=None):
    """``(image (round(sH), round(sW), 3), accumulated robustness (H, W))``
    of the burst ``frames`` (N, H, W) float32 on one device (frame 0 the
    reference) under the configuration tree ``cfg``; ``stage`` as in
    :func:`.pipeline.reference_burst`."""
    check_supported(cfg)
    s = float(cfg["scale"])
    q = stage or _keep
    an = analysis(frames, cfg, cfa, wb, q)
    ref, Ts = an.frames[0], an.tile_size
    dev = ref.device
    H, W = ref.shape
    acc_r = torch.zeros((H, W), dtype=F32, device=dev)
    num = torch.zeros((3, round(s * H), round(s * W)), dtype=F32, device=dev)
    den = torch.zeros_like(num)
    for frame in an.frames[1:]:
        flow, r, covs = an.frame(frame)
        acc_r = acc_r + r
        merge_gather(frame, flow, covs, r, num, den, cfa, Ts, s)
    merge_reference(ref, an.covs(ref), num, den, cfa, s, denoiser_of(cfg, acc_r))
    image = q(refill_border(q(num), q(den)).permute(1, 2, 0))
    if cfg["postprocessing"]["enabled"]:
        image = q(finish(image.to(F32), cfg["postprocessing"]))
    return image, acc_r
