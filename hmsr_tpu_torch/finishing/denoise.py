"""Frame-count-aware post denoisers, Gauss and median (twin of
:mod:`hmsr_tpu.finishing.denoise`): where few frames merged (a low
accumulated robustness), more smoothing.

As in the JAX package: an HR pixel reads the raw-resolution accumulated
robustness at ``round(y / scale)`` (the JAX package's documented deviation
from the reference, which indexes the mask as if it were half-resolution);
the loop runs to the largest radius with per-pixel masks. Both run on the
image's device in bands of rows, so that neither the Gauss sums nor the
median's tap stack exist at the full 48 MP size. Every division by a
number that is not a power of two divides by a device tensor
(:func:`hmsr_tpu_torch.ops.cuda_merge.scale_divisor`): on the card a
division by a Python float multiplies by its rounded reciprocal.
"""

import torch
import torch.nn.functional as F

from ..ops.cuda_merge import scale_divisor
from ..utils.types import DEFAULT_FLOAT

#: bytes of the median's float32 tap stack per band of rows (its sort
#: adds the sorted values and int64 indices: four times this at the peak)
MEDIAN_STACK_BYTES = 2**30


def _acc_r_lookup(acc_r, out_shape, scale):
    """``acc_r`` (H, W) nearest-resampled to ``out_shape`` at
    ``min(round(y / scale), H - 1)``."""
    hh, hw = out_shape
    dev = acc_r.device
    s = scale_divisor(scale, dev)

    def index(n, size):
        pos = torch.arange(n, dtype=DEFAULT_FLOAT, device=dev) / s
        return torch.round(pos).to(torch.int64).clamp(max=size - 1)

    return acc_r[index(hh, acc_r.shape[0])[:, None], index(hw, acc_r.shape[1])[None, :]]


def _frame_count_map(acc_r, out_shape, config):
    """The accumulated robustness resampled to ``out_shape`` and clipped at
    ``max_frame_count``; returns ``(r, max_frame_count)``."""
    max_fc = float(config["max_frame_count"])
    r = _acc_r_lookup(acc_r, out_shape, config.get("scale", 1))
    return torch.clamp(r, max=max_fc), max_fc


def frame_count_denoising_gauss(image, acc_r, config, band_rows=512):
    """Gaussian blur of ``image`` (H', W', c) with sigma ``sigma_max (max_fc
    - r) / max_fc`` per pixel: taps to ``int(3 sigma_max)``, a pixel's taps
    within ``int(3 sigma)``, a delta where sigma is 0. Returns a new
    image."""
    sigma_max = float(config["sigma_max"])
    rad = int(3 * sigma_max)
    hh, hw, nc = image.shape
    dev = image.device
    r, max_fc = _frame_count_map(acc_r, (hh, hw), config)
    sigma = sigma_max * (max_fc - r) / scale_divisor(max_fc, dev)
    t_int = (3.0 * sigma).to(torch.int32)
    zero_sigma = sigma == 0
    sigma_sq2 = torch.where(zero_sigma, 1.0, 2.0 * sigma * sigma)
    pad = F.pad(image.to(DEFAULT_FLOAT).permute(2, 0, 1),
                (rad, rad, rad, rad)).permute(1, 2, 0)
    xx = torch.arange(hw, device=dev)[None, :]
    out = torch.empty_like(image, dtype=DEFAULT_FLOAT)
    for y0 in range(0, hh, band_rows):
        y1 = min(y0 + band_rows, hh)
        yy = torch.arange(y0, y1, device=dev)[:, None]
        t_b, zero_b, sq2_b = t_int[y0:y1], zero_sigma[y0:y1], sigma_sq2[y0:y1]
        num = torch.zeros((y1 - y0, hw, nc), dtype=DEFAULT_FLOAT, device=dev)
        den = torch.zeros((y1 - y0, hw, 1), dtype=DEFAULT_FLOAT, device=dev)
        for i in range(-rad, rad + 1):
            for j in range(-rad, rad + 1):
                inb = (yy + i >= 0) & (yy + i < hh) & (xx + j >= 0) & (xx + j < hw)
                within = (abs(i) <= t_b) & (abs(j) <= t_b)
                # -(i^2 + j^2) / (2 sigma^2), a division of two tensors
                e = torch.exp(torch.full((), -(i * i + j * j), dtype=DEFAULT_FLOAT,
                                         device=dev) / sq2_b)
                w = torch.where(zero_b, float(i == 0 and j == 0), e)
                w = torch.where(inb & within, w, 0.0)[..., None]
                num = num + w * pad[rad + i + y0:rad + i + y1, rad + j:rad + j + hw]
                den = den + w
        out[y0:y1] = num / den
    return out


def frame_count_denoising_median(image, acc_r, config):
    """Median filter of ``image`` (H', W', c) with the radius ``round(
    radius_max (max_fc - r) / max_fc)`` per pixel (``radius_max`` at most
    14): the taps of the pixel's window that lie in the image, sorted with
    the others at ``inf``, read at ``k // 2`` for k valid taps (the upper
    median where k is even). Returns a new image."""
    radius_max = int(min(14, config["radius_max"]))
    rad = radius_max
    hh, hw, nc = image.shape
    dev = image.device
    r, max_fc = _frame_count_map(acc_r, (hh, hw), config)
    radius = torch.round(radius_max * (max_fc - r) / scale_divisor(max_fc, dev)).to(
        torch.int32)
    pad = F.pad(image.to(DEFAULT_FLOAT).permute(2, 0, 1),
                (rad, rad, rad, rad)).permute(1, 2, 0)
    n_taps = (2 * rad + 1) ** 2
    band_rows = max(1, MEDIAN_STACK_BYTES // (n_taps * hw * nc * 4))
    xx = torch.arange(hw, device=dev)[None, :]
    inf = torch.full((), float("inf"), dtype=DEFAULT_FLOAT, device=dev)
    out = torch.empty_like(image, dtype=DEFAULT_FLOAT)
    for y0 in range(0, hh, band_rows):
        y1 = min(y0 + band_rows, hh)
        yy = torch.arange(y0, y1, device=dev)[:, None]
        rad_b = radius[y0:y1]
        stack = torch.empty((n_taps, y1 - y0, hw, nc), dtype=DEFAULT_FLOAT, device=dev)
        count = torch.zeros((y1 - y0, hw), dtype=torch.int32, device=dev)
        t = 0
        for i in range(-rad, rad + 1):
            for j in range(-rad, rad + 1):
                ok = (yy + i >= 0) & (yy + i < hh) & (xx + j >= 0) & (xx + j < hw) & \
                    (abs(i) <= rad_b) & (abs(j) <= rad_b)
                stack[t] = torch.where(ok[..., None], pad[rad + i + y0:rad + i + y1,
                                                          rad + j:rad + j + hw], inf)
                count += ok
                t += 1
        srt = torch.sort(stack, dim=0).values
        del stack
        idx = (count // 2).to(torch.int64)[None, :, :, None].expand(1, -1, -1, nc)
        out[y0:y1] = torch.take_along_dim(srt, idx, dim=0)[0]
        del srt
    return out
