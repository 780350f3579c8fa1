"""Synthetic raw burst generation with known ground truth (NumPy; the twin
of :mod:`hmsr_tpu.io.synthetic`, which makes the same bursts bit for bit).

Inverse-ISP-style burst simulator (in the spirit of the reference's
``unprocess_isp``, raw2rgb.py:179-202, and its Monte-Carlo noise model): take
a band-limited ground-truth linear RGB image, apply known sub-pixel shifts,
area-downsample to the sensor grid, mosaic through the CFA, and add
signal-dependent Gaussian noise ``std^2 = alpha*I + beta``.

This provides end-to-end accuracy tests and benchmarks with zero DNG
dependencies: ground truth is exact, shifts are known, and the noise model
matches the pipeline's calibration assumptions.
"""

import numpy as np

DEFAULT_CFA = np.array([[0, 1], [1, 2]])      # RGGB


def smooth_rgb(h, w, seed=0, detail=8, bandwidth=0.1):
    """Band-limited random linear-RGB image in [0.1, 0.9], shape (h, w, 3).

    ``bandwidth`` is the spectral cutoff in cycles/pixel on THIS grid; keep it
    below 0.5/sr_factor so the downsampled burst can represent the scene and
    reconstruction error measures the pipeline, not irrecoverable aliasing.

    Scene statistics are natural-image-like: a 1/f amplitude spectrum (knee at
    ``1/(4*detail)`` cycles/pixel) with a raised-cosine taper to exactly zero
    at ``bandwidth`` (no brick-wall ringing), a shared-luminance structure, and
    lower-bandwidth chroma — so demo outputs look like smooth colored terrain
    with fine detail rather than i.i.d. confetti, while alignment/merge still
    see energy at every representable scale.
    """
    rng = np.random.RandomState(seed)
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    r = np.hypot(fy, fx)

    def field(cutoff):
        amp = 1.0 / (r + 1.0 / (4.0 * detail))
        t = np.clip(r / cutoff, 0.0, 1.0)
        amp = amp * 0.5 * (1.0 + np.cos(np.pi * t))
        amp[r >= cutoff] = 0.0
        x = np.real(np.fft.ifft2(amp * np.exp(2j * np.pi * rng.rand(h, w))))
        return x / (x.std() + 1e-9)

    luma = field(bandwidth)
    c1 = field(bandwidth / 4)
    c2 = field(bandwidth / 4)
    up = np.stack([luma + 0.5 * c1,
                   luma - 0.25 * c1 + 0.35 * c2,
                   luma - 0.45 * c2], -1)
    up = (up - up.min()) / (up.max() - up.min() + 1e-9)
    return (0.1 + 0.8 * up).astype(np.float32)


def spectral_shift(img, dx, dy):
    """img shifted so that out[y, x] = img[y - dy, x - dx] (periodic)."""
    h, w = img.shape[:2]
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    phase = np.exp(-2j * np.pi * (fy * dy + fx * dx))
    if img.ndim == 2:
        return np.real(np.fft.ifft2(np.fft.fft2(img) * phase))
    return np.stack([np.real(np.fft.ifft2(np.fft.fft2(img[..., c]) * phase))
                     for c in range(img.shape[-1])], -1)


def mosaic(rgb, cfa=DEFAULT_CFA):
    """Sample one CFA channel per pixel -> (H, W) raw."""
    h, w, _ = rgb.shape
    raw = np.zeros((h, w), np.float32)
    for i in range(2):
        for j in range(2):
            raw[i::2, j::2] = rgb[i::2, j::2, int(cfa[i, j])]
    return raw


def area_downsample(img, factor):
    h, w = img.shape[:2]
    h2, w2 = h // factor, w // factor
    if img.ndim == 2:
        return img[:h2 * factor, :w2 * factor].reshape(
            h2, factor, w2, factor).mean(axis=(1, 3))
    return img[:h2 * factor, :w2 * factor].reshape(
        h2, factor, w2, factor, -1).mean(axis=(1, 3))


def _disc_alpha(h, w, cy, cx, radius, feather=1.5):
    """Soft-edged disc mask in [0, 1]: 1 inside, cosine rolloff over
    ``feather`` pixels (band-limited-ish so area_downsample stays honest)."""
    yy = np.arange(h)[:, None] - cy
    xx = np.arange(w)[None, :] - cx
    d = np.hypot(yy, xx) - radius
    t = np.clip(d / feather + 0.5, 0.0, 1.0)
    return (0.5 * (1.0 + np.cos(np.pi * t))).astype(np.float32)


def make_occlusion_burst(h, w, n_frames, alpha=1.8e-4, beta=3.0e-6, seed=0,
                         max_shift=2.0, cfa=DEFAULT_CFA, sr_factor=2,
                         object_radius=None, velocity=None):
    """Burst with LOCAL MOTION: a textured disc moves across the scene
    (several raw px/frame) on top of the global handheld shifts.

    Exercises the robustness model's actual purpose (reference Algs. 6-9,
    robustness.py:79-170 — reject comp-frame content that disagrees with
    the reference frame): aligned comp frames show the disc elsewhere, so a
    merge WITHOUT robustness ghosts the disc along its trajectory. The
    reference validates this only via the IPOL demo on real bursts; this
    scene provides a measurable stand-in with exact ground truth.

    Returns (ref_raw, comp_raws, truth, ghost_mask):
      truth      — the frame-0 scene on the (h*sr, w*sr) grid (no noise);
      ghost_mask — HR bool, True where ANY frame's disc footprint lands
                   (the region a robustness-less merge can corrupt).
    """
    rng = np.random.RandomState(seed)
    hr_h, hr_w = h * sr_factor, w * sr_factor
    bg = smooth_rgb(hr_h, hr_w, seed=seed)
    obj = smooth_rgb(hr_h, hr_w, seed=seed + 1)[..., ::-1] * 0.9 + 0.05
    radius = (min(h, w) / 8.0 if object_radius is None else object_radius)
    radius *= sr_factor
    if velocity is None:
        velocity = (3.0, 5.0)                        # raw px / frame
    vy, vx = velocity[0] * sr_factor, velocity[1] * sr_factor
    cy0, cx0 = hr_h * 0.35, hr_w * 0.3

    shifts = np.zeros((n_frames, 2), np.float32)
    shifts[1:] = rng.uniform(-max_shift, max_shift, size=(n_frames - 1, 2))

    frames, ghost = [], np.zeros((hr_h, hr_w), bool)
    truth = None
    for n in range(n_frames):
        dx, dy = shifts[n]
        a = _disc_alpha(hr_h, hr_w, cy0 + n * vy, cx0 + n * vx, radius)
        scene = bg * (1 - a[..., None]) + obj * a[..., None]
        if n == 0:
            truth = scene.astype(np.float32)
        # the disc's frame-n footprint, seen in REF-frame coordinates after
        # perfect global alignment, is its un-shifted position
        ghost |= a > 1e-3
        hr_shifted = spectral_shift(scene, dx * sr_factor, dy * sr_factor)
        lr = area_downsample(hr_shifted, sr_factor)
        raw = mosaic(lr.astype(np.float32), cfa)
        noise = np.sqrt(np.maximum(alpha * raw + beta, 0)) * \
            rng.randn(*raw.shape)
        frames.append(np.clip(raw + noise, 0.0, 1.0).astype(np.float32))

    return frames[0], np.stack(frames[1:]), truth, ghost


def make_synthetic_burst(h, w, n_frames, alpha=1.8e-4, beta=3.0e-6, seed=0,
                         max_shift=2.0, cfa=DEFAULT_CFA, grey=False, sr_factor=2):
    """Build (ref_raw, comp_raws, ground_truth, shifts).

    The ground truth lives on an ``sr_factor``-times finer grid than the raw
    frames (shape (h*sr, w*sr, 3) — or (h*sr, w*sr) in grey mode), so x2 SR
    outputs can be scored directly against it. Frame 0 (the reference) has
    zero shift; shifts are expressed in raw-pixel units.
    """
    rng = np.random.RandomState(seed)
    hr_h, hr_w = h * sr_factor, w * sr_factor
    truth = smooth_rgb(hr_h, hr_w, seed=seed)
    if grey:
        truth = truth.mean(-1)

    shifts = np.zeros((n_frames, 2), np.float32)
    shifts[1:] = rng.uniform(-max_shift, max_shift, size=(n_frames - 1, 2))

    frames = []
    for n in range(n_frames):
        dx, dy = shifts[n]
        hr_shifted = spectral_shift(truth, dx * sr_factor, dy * sr_factor)
        lr = area_downsample(hr_shifted, sr_factor)
        raw = lr if grey else mosaic(lr.astype(np.float32), cfa)
        noise = np.sqrt(np.maximum(alpha * raw + beta, 0)) * \
            rng.randn(*raw.shape)
        frames.append(np.clip(raw + noise, 0.0, 1.0).astype(np.float32))

    return frames[0], np.stack(frames[1:]), truth, shifts
