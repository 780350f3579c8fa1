"""Noise curves and the SNR-adaptive settings of the plain reference.

The Monte-Carlo curves of the affine model ``std^2 = alpha * I + beta`` on
1001 brightness levels: the per-3x3-patch std of clipped noisy samples
(two draws averaged) and the mean absolute difference of two clipped 3x3
patch means, drawn only outside the analytic linearity bounds and
interpolated in the squared domain in between (Wronski et al. 2019, the
reference implementation's ``fast_monte_carlo.py``). The draws come from a
``torch.Generator`` on the burst's device seeded with 0, in the order the
port draws them, so that both sides merge with the same curves.
"""

import numpy as np
import torch

N_PATCHES = 100_000
N_LEVELS = 1000
TOL = 3
LEVELS_PER_DRAW = 16


def _linearity_bounds(alpha, beta, tol=TOL):
    tol_sq = tol * tol
    xmin = tol_sq / 2 * (alpha + np.sqrt(tol_sq * alpha * alpha + 4 * beta))
    xmax = (2 + tol_sq * alpha
            - np.sqrt((2 + tol_sq * alpha) ** 2 - 4 * (1 + tol_sq * beta))) / 2
    return xmin, xmax


def _draw(levels, alpha, beta, device, seed=0):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    b_all = torch.as_tensor(np.asarray(levels), dtype=torch.float32, device=device)
    sigmas, diffs = [], []
    for i0 in range(0, b_all.shape[0], LEVELS_PER_DRAW):
        b = b_all[i0:i0 + LEVELS_PER_DRAW, None, None]
        std = torch.sqrt(torch.clamp(b * float(alpha) + float(beta), min=0.0))
        shape = (b.shape[0], N_PATCHES, 9)
        p1 = torch.clamp(b + std * torch.randn(shape, generator=gen, device=device), 0.0, 1.0)
        p2 = torch.clamp(b + std * torch.randn(shape, generator=gen, device=device), 0.0, 1.0)
        sigmas.append(0.5 * torch.mean(torch.std(p1, dim=2, correction=0)
                                       + torch.std(p2, dim=2, correction=0), dim=1))
        diffs.append(torch.mean(torch.abs(p1.mean(dim=2) - p2.mean(dim=2)), dim=1))
    return (torch.cat(sigmas).cpu().numpy().astype(np.float64),
            torch.cat(diffs).cpu().numpy().astype(np.float64))


def _interp_squared(b, lo, hi):
    t = (b - b[0]) / (b[-1] - b[0])
    return np.sqrt(t * (hi ** 2 - lo ** 2) + lo ** 2)[1:-1]


def noise_curves(alpha, beta, device):
    """(std_curve, diff_curve), numpy float64, 1001 entries each."""
    n = N_LEVELS
    xmin, xmax = _linearity_bounds(alpha, beta)
    imin, imax = int(np.ceil(xmin * n)) + 1, int(np.floor(xmax * n)) - 1
    b = np.arange(n + 1) / n
    if imin > n or imin >= imax:
        return _draw(b, alpha, beta, device)
    sig, dif = np.empty(n + 1), np.empty(n + 1)
    s_nl, d_nl = _draw(np.concatenate((b[:imin + 1], b[imax:])), alpha, beta, device)
    sig[:imin + 1], dif[:imin + 1] = s_nl[:imin + 1], d_nl[:imin + 1]
    sig[imax:], dif[imax:] = s_nl[imin + 1:], d_nl[imin + 1:]
    mid = b[imin - 1:imax + 2]
    sig[imin:imax + 1] = _interp_squared(mid, sig[imin], sig[imax])
    dif[imin:imax + 1] = _interp_squared(mid, dif[imin], dif[imax])
    return sig, dif


def snr_of(ref, std_curve):
    """The burst's SNR: the reference frame's mean over the noise std there."""
    brightness = float(torch.mean(ref, dtype=torch.float64))
    idx = int(np.clip(int(round(1000 * brightness)), 0, len(std_curve) - 1))
    return brightness / std_curve[idx]


def _lerp(x, x_range, y_range):
    (x0, x1), (y0, y1) = x_range, y_range
    t = max(0.0, min(1.0, (x - x0) / (x1 - x0)))
    return y0 + (y1 - y0) * t


def snr_settings(snr):
    """Tile size (64 / 32 / 16 for SNR <= 14 / <= 22 / above) and the merge
    constants interpolated over SNR in [6, 30]."""
    snr = float(np.clip(snr, 6, 30))
    out = {"tile_size": 64 if snr <= 14 else (32 if snr <= 22 else 16)}
    for key, ends in (("k_detail", (0.33, 0.25)), ("k_denoise", (5.0, 3.0)),
                      ("D_th", (0.81, 0.71)), ("D_tr", (1.24, 1))):
        out[key] = _lerp(snr, (6, 30), ends)
    return out
