"""Fast Monte-Carlo noise-curve calibration on the device (twin of
:mod:`hmsr_tpu.noise.fast_monte_carlo`).

For the affine noise model ``std^2 = alpha*I + beta`` and each brightness
level b (1001 levels on [0, 1]):

- sigma(b): mean over patches of the per-3x3-patch std (ddof 0) of clipped
  noisy samples, two draws averaged;
- d(b): mean absolute difference of two independent clipped 3x3 patch means.

The clipping to [0, 1] makes the curves nonlinear near 0 and 1; as in the
reference, the MC runs only outside the analytic linearity bounds and the
middle is interpolated linearly in the squared domain. The draws come from a
``torch.Generator`` on the device seeded from ``seed``: other numbers than
``jax.random``'s, the same estimator, so the two agree statistically.

Curves are cached per (alpha, beta, seed, patches, device type), in memory
and as ``.npz`` files under ``build/noise_cache/`` at the root of the
checkout (:data:`DISK_CACHE_DIR`).
"""

import os

import numpy as np
import torch

from ..utils.types import resolve_device

N_PATCHES = int(1e5)
N_BRIGHTNESS_LEVELS = 1000
TOL = 3
#: brightness levels drawn at once: bounds the draws to
#: 2 x LEVELS_PER_DRAW x N_PATCHES x 9 floats (115 MB).
LEVELS_PER_DRAW = 16
#: E[s] / sigma of the 9-sample ddof-0 std, sqrt(2/9) Gamma(4.5) / Gamma(4)
#: (the value scipy.special.gamma gives, which the JAX package uses). A numpy
#: float64, as there: a float32 curve divided by it is promoted to float64.
C9 = np.float64(0.9138748917925524)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DISK_CACHE_DIR = os.path.join(os.path.dirname(_PKG), "build", "noise_cache")


def get_non_linearity_bound(alpha, beta, tol=TOL):
    """Brightness range [xmin, xmax] where clipping is negligible (+-tol sigma)."""
    tol_sq = tol * tol
    xmin = tol_sq / 2 * (alpha + np.sqrt(tol_sq * alpha * alpha + 4 * beta))
    xmax = (2 + tol_sq * alpha
            - np.sqrt((2 + tol_sq * alpha) ** 2 - 4 * (1 + tol_sq * beta))) / 2
    return xmin, xmax


def _regular_mc(b_array, alpha, beta, seed, device, n_patches=N_PATCHES):
    """(sigmas, diffs), numpy float64, for each brightness in ``b_array``;
    float32 draws and statistics on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    b_all = torch.as_tensor(np.asarray(b_array), dtype=torch.float32, device=device)
    sigmas, diffs = [], []
    for i0 in range(0, b_all.shape[0], LEVELS_PER_DRAW):
        b = b_all[i0:i0 + LEVELS_PER_DRAW, None, None]
        std = torch.sqrt(torch.clamp(b * float(alpha) + float(beta), min=0.0))
        shape = (b.shape[0], n_patches, 9)
        p1 = torch.clamp(b + std * torch.randn(shape, generator=gen, device=device),
                         0.0, 1.0)
        p2 = torch.clamp(b + std * torch.randn(shape, generator=gen, device=device),
                         0.0, 1.0)
        sigmas.append(0.5 * torch.mean(torch.std(p1, dim=2, correction=0)
                                       + torch.std(p2, dim=2, correction=0), dim=1))
        diffs.append(torch.mean(torch.abs(p1.mean(dim=2) - p2.mean(dim=2)), dim=1))
    return (torch.cat(sigmas).cpu().numpy().astype(np.float64),
            torch.cat(diffs).cpu().numpy().astype(np.float64))


def _interp_squared(b_array, lo, hi):
    """Linear interpolation in the squared domain between endpoint values."""
    t = (b_array - b_array[0]) / (b_array[-1] - b_array[0])
    return np.sqrt(t * (hi ** 2 - lo ** 2) + lo ** 2)[1:-1]


_CACHE = {}


def _disk_cache_path(cache_key):
    tag = "_".join(f"{v:.12g}" if isinstance(v, float) else str(v)
                   for v in cache_key)
    return os.path.join(DISK_CACHE_DIR, f"curves_{tag}.npz")


def _store(cache_key, sigmas, diffs):
    _CACHE[cache_key] = (sigmas, diffs)
    path = _disk_cache_path(cache_key)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        os.makedirs(DISK_CACHE_DIR, exist_ok=True)
        np.savez(tmp, std=sigmas, diff=diffs)
        os.replace(tmp, path)
    except OSError:
        pass        # the in-memory cache still holds the curves


def run_fast_MC(alpha, beta, seed=0, device="cuda"):
    """(std_curve, diff_curve), numpy float64, each 1001 entries over
    brightness in [0, 1], drawn on ``device`` (the card unless the caller
    asks for the CPU). Cached in memory and on disk."""
    device = resolve_device(device)
    cache_key = (round(float(alpha), 12), round(float(beta), 12), seed, N_PATCHES,
                 device.type)
    if cache_key in _CACHE:
        return _CACHE[cache_key]
    path = _disk_cache_path(cache_key)
    if os.path.exists(path):
        with np.load(path) as data:
            out = (data["std"], data["diff"])
        _CACHE[cache_key] = out
        return out

    xmin, xmax = get_non_linearity_bound(alpha, beta, TOL)
    n = N_BRIGHTNESS_LEVELS
    imin = int(np.ceil(xmin * n)) + 1
    imax = int(np.floor(xmax * n)) - 1

    brightness = np.arange(n + 1) / n
    if imin > n or imin >= imax:
        sigmas, diffs = _regular_mc(brightness, alpha, beta, seed, device)
        _store(cache_key, sigmas, diffs)
        return sigmas, diffs

    sigmas = np.empty(n + 1)
    diffs = np.empty(n + 1)
    nl_brightness = np.concatenate((brightness[:imin + 1], brightness[imax:]))
    s_nl, d_nl = _regular_mc(nl_brightness, alpha, beta, seed, device)
    sigmas[:imin + 1], diffs[:imin + 1] = s_nl[:imin + 1], d_nl[:imin + 1]
    sigmas[imax:], diffs[imax:] = s_nl[imin + 1:], d_nl[imin + 1:]

    b_mid = brightness[imin - 1:imax + 2]
    sigmas[imin:imax + 1] = _interp_squared(b_mid, sigmas[imin], sigmas[imax])
    diffs[imin:imax + 1] = _interp_squared(b_mid, diffs[imin], diffs[imax])

    _store(cache_key, sigmas, diffs)
    return sigmas, diffs


def round_iso(iso):
    """Round a non-standard ISO to the nearest power-of-two standard ISO
    (100, 200, 400, ...)."""
    import math
    n = round(math.log2(iso / 100))
    return int(100 * (2 ** n))


def load_noise_curves(iso, data_dir):
    """Load precomputed curves ``noise_model_{std,diff}_ISO_{iso}.npy``."""
    iso = round_iso(iso)
    std = np.load(os.path.join(data_dir, f"noise_model_std_ISO_{iso}.npy"))
    diff = np.load(os.path.join(data_dir, f"noise_model_diff_ISO_{iso}.npy"))
    return std, diff


def fit_alpha_beta(std_curve):
    """Recover an affine noise model ``std^2 = alpha*b + beta`` from a std
    curve: least squares over the mid-range brightness (clipping distorts the
    ends), after undoing the bias of the stored 9-sample std (:data:`C9`)."""
    n = len(std_curve)
    b = np.arange(n) / (n - 1)
    mid = slice(n // 10, (9 * n) // 10)
    sigma2 = (np.asarray(std_curve[mid]) / C9) ** 2
    A = np.stack([b[mid], np.ones_like(b[mid])], axis=-1)
    coef, *_ = np.linalg.lstsq(A, sigma2, rcond=None)
    return float(coef[0]), float(max(coef[1], 0.0))


def monte_carlo_curves(alpha, beta, seed=0, device="cuda"):
    """Brute-force MC over every brightness level (the reference's offline
    ``monte_carlo_simulation.py``), for generating noise_model_*.npy files."""
    brightness = np.arange(N_BRIGHTNESS_LEVELS + 1) / N_BRIGHTNESS_LEVELS
    return _regular_mc(brightness, alpha, beta, seed, resolve_device(device))
