"""The ``bench.py`` headline workload, made on the device from a seed: a
synthetic Bayer burst, its analytic noise curves and its configuration.

Used by ``chip_smoke.py`` and :mod:`hmsr_tpu_torch.profile_burst`.
"""

import math

import numpy as np
import torch

from .configs import default_config, sanitize_config, update_snr_config

ALPHA, BETA = 1.8e-4, 3.0e-6         # affine noise: std^2 = alpha * I + beta
CFA_RGGB = np.array([[0, 1], [1, 2]])
WB = [1.0, 1.0, 1.0]


def affine_curves(alpha=ALPHA, beta=BETA):
    """Noise curves of the affine model on 1001 brightness levels, numpy
    float32 (``__graft_entry__._curves``): the std of a pixel, and the
    expected |difference| of two 3x3 means."""
    b = np.arange(1001) / 1000.0
    std = np.sqrt(np.maximum(alpha * b + beta, 0)).astype(np.float32)
    diff = np.sqrt(2 / np.pi * 2 * (alpha * b + beta) / 9).astype(np.float32)
    return std, diff


def burst_snr(frame, std_curve):
    """SNR of a frame: its mean brightness over the noise std there."""
    mean_b = float(frame.mean())
    return mean_b / float(std_curve[int(round(1000 * mean_b))])


def burst_config(shape, snr, scale=2, debug=False, alpha=ALPHA, beta=BETA):
    """The ``bench.py`` headline configuration (``bench.py:98-114``): scale
    2, the accumulated-robustness denoiser off, SNR-picked tile size."""
    c = default_config()
    c.scale = scale
    c.verbose = 0
    c.debug = debug
    c.noise_model.alpha = alpha
    c.noise_model.beta = beta
    c.accumulated_robustness_denoiser.enabled = False
    update_snr_config(c, snr)
    sanitize_config(c, shape)
    return c


def _grey(c):
    c.mode = "grey"


def _x3(c):
    c.scale = 3
    c.accumulated_robustness_denoiser.enabled = True


def _x1(c):
    c.scale = 1
    c.robustness.enabled = False
    c.robustness.save_mask = False


#: ``bench.py``'s mutations of its headline configuration for the cells
#: grey, x3 and x1 (``bench.py:312-322``)
BENCH_CELLS = {"grey": _grey, "x3": _x3, "x1": _x1}


def make_burst(h, w, n_frames, seed, device, alpha=ALPHA, beta=BETA,
               brightness=None):
    """(n_frames, h, w) float32 raw frames on ``device``: a blocky random
    scene Gaussian-blurred (sigma 4, spectral) and scaled to [0.1, 0.9], or
    to [0.2, 1.8] x ``brightness`` for the dark cells (``bench.py``'s
    ``make_burst``: 0.07 gives Ts=32, 0.02 Ts=64); exact sub-pixel shifts
    in [-3, 3] px by spectral phase ramps (frame 0 unshifted), affine noise
    ``std^2 = alpha * I + beta``, clipped to [0, 1]."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = torch.float64
    base = torch.rand((h // 16 + 1, w // 16 + 1), generator=g, device=device, dtype=f64)
    img = base.repeat_interleave(16, 0).repeat_interleave(16, 1)[:h, :w]
    fy = torch.fft.fftfreq(h, device=device, dtype=f64)[:, None]
    fx = torch.fft.fftfreq(w, device=device, dtype=f64)[None, :]
    img = torch.fft.ifft2(torch.fft.fft2(img) * torch.exp(
        -2.0 * math.pi ** 2 * 16.0 * (fy * fy + fx * fx))).real
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    lo, span = (0.1, 0.8) if brightness is None else (0.2 * brightness, 1.6 * brightness)
    spec = torch.fft.fft2(lo + span * img)
    shifts = torch.rand((n_frames, 2), generator=g, device=device, dtype=f64) * 6 - 3
    shifts[0] = 0
    frames = torch.empty((n_frames, h, w), dtype=torch.float32, device=device)
    for k in range(n_frames):
        dy, dx = shifts[k, 0], shifts[k, 1]
        phase = torch.exp(-2j * math.pi * (fy * dy + fx * dx))
        shifted = torch.fft.ifft2(spec * phase).real.float()
        noise = torch.sqrt(torch.clamp(alpha * shifted + beta, min=0)) * torch.randn(
            (h, w), generator=g, device=device)
        frames[k] = torch.clamp(shifted + noise, 0, 1)
    return frames
