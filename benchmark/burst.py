"""The benchmark's traffic generator: synthetic raw Bayer bursts made on the
device from a seed, and the seeds of a run's pool of bursts.

A frame is a blocky random scene (16-px blocks), Gaussian-blurred (sigma 4,
spectrally) and scaled to [0.1, 0.9], or to [0.2, 1.8] x ``brightness`` for
low light; frame k is the scene shifted by an exact sub-pixel amount in
[-3, 3] px (spectral phase ramp; frame 0 unshifted), with affine noise
``std^2 = alpha * I + beta``, clipped to [0, 1]. Every seed gives a burst of
the same size and the same kind; only the scene, the shifts and the noise
differ. Frozen here so that a change to the program cannot move it.
"""

import math

import numpy as np
import torch


def pool_seeds(seed, n):
    """``n`` distinct 63-bit burst seeds drawn from the run's ``seed``."""
    ss = np.random.SeedSequence(int(seed) & (2**128 - 1))
    return [int(s) for s in ss.generate_state(n, dtype=np.uint64) >> np.uint64(1)]


def make_burst(h, w, n_frames, seed, device, alpha, beta, brightness=None):
    """(n_frames, h, w) float32 raw frames on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
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
        phase = torch.exp(-2j * math.pi * (fy * shifts[k, 0] + fx * shifts[k, 1]))
        shifted = torch.fft.ifft2(spec * phase).real.float()
        noise = torch.sqrt(torch.clamp(alpha * shifted + beta, min=0)) * torch.randn(
            (h, w), generator=g, device=device)
        frames[k] = torch.clamp(shifted + noise, 0, 1)
    return frames
