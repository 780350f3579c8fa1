"""The plain reference of the benchmark's timed entry: a raw Bayer burst to
the finished image, in plain torch, imports nothing of the program.

Steps: the noise curves of the configuration's noise model and the burst's
SNR, which pick the tile size and the merge constants; the reference
frame's alignment and robustness state; per compared frame its flow, its
robustness map and its kernel covariances; the accumulated robustness (the
sum of the maps); the merge of the burst and of the reference frame, the
refill and the divide per slab (:mod:`.merge`); the finishing on the
device (unsharp mask with scipy's ``gaussian_filter`` taps and nearest
boundary, clip, gamma 1/2.2, clip). Supports what the benchmark's
configurations use: Bayer mode, FFT grey, nearest flow upscaling, the
steerable kernel with the linear law, an integer scale, robustness on, the
merge's accumulated-robustness denoiser on or off, orientation 1, no
colour correction, tonemapping or devignetting.

``stage`` (optional) is applied to every tensor handed from one stage to
the next (frames, grey images, flows, robustness maps, covariances,
accumulators, image): the control passes a rounding to bfloat16 there.
"""

from typing import Callable, NamedTuple

import numpy as np
import torch

from .align import Aligner, grey_fft
from .merge import merge_frame, merge_reference, normalize_slabs
from .noise import noise_curves, snr_of, snr_settings
from .robust import covariances, ref_stats, robustness

F32 = torch.float32

#: what the reference implements of the configuration tree; anything else
#: in a benchmark configuration is refused
SUPPORTED = {"mode": "bayer", "grey_method": "FFT",
             "block_matching.tuning.flow_upscale_mode": "nearest",
             "merging.kernel": "steerable", "merging.selection_law": "linear",
             "robustness.enabled": True, "postprocessing.do_color_correction": False,
             "postprocessing.do_tonemapping": False, "postprocessing.do_devignetting": False,
             "accumulated_robustness_denoiser.median.enabled": False,
             "accumulated_robustness_denoiser.gauss.enabled": False}


def _get(tree, dotted):
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def check_tree(cfg):
    """Refuse, naming the key, a configuration tree outside
    :data:`SUPPORTED` (both forms' references share the stages it names)."""
    for key, want in SUPPORTED.items():
        if _get(cfg, key) != want:
            raise ValueError(f"the reference does not implement {key}={_get(cfg, key)!r}")


def check_supported(cfg):
    check_tree(cfg)
    if float(cfg["scale"]) != int(cfg["scale"]):
        raise ValueError("the reference merges at an integer scale only")


def _blur_nearest(img, sigma):
    """scipy.ndimage.gaussian_filter(x, sigma, mode="nearest") per channel of
    (H, W, C): radius int(4 sigma + 0.5), rows first, as weighted slices."""
    lw = int(4.0 * float(sigma) + 0.5)
    x = np.arange(-lw, lw + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / float(sigma)) ** 2)
    taps = [float(t) for t in (k / k.sum()).astype(np.float32)]
    h, w, _ = img.shape
    p = torch.cat([img[:1].expand(lw, -1, -1), img, img[-1:].expand(lw, -1, -1)], 0)
    rows = sum(t * p[i:i + h] for i, t in enumerate(taps))
    p = torch.cat([rows[:, :1].expand(-1, lw, -1), rows, rows[:, -1:].expand(-1, lw, -1)], 1)
    return sum(t * p[:, i:i + w] for i, t in enumerate(taps))


def finish(img, pp):
    """The device finishing chain of the configuration (sharpening, gamma)."""
    sh = pp["sharpening"]
    if sh["enabled"]:
        img = img + sh["amount"] * (img - _blur_nearest(img, sh["radius"]))
    img = torch.clamp(img, 0.0, 1.0)
    if pp["do_gamma_correction"]:
        img = img ** (1.0 / 2.2)
    return torch.clamp(img, 0.0, 1.0)


def _keep(x):
    return x


class Analysis(NamedTuple):
    """What the merges take from a burst: the frames (rounded by the stage),
    the tile size, ``frame(f)`` (a compared frame's flow, robustness map
    and kernel covariances) and ``covs(f)`` (a frame's covariances)."""
    frames: torch.Tensor
    tile_size: int
    frame: Callable
    covs: Callable


def analysis(frames, cfg, cfa, wb, q=_keep):
    """The noise curves and the burst's SNR, which pick the tile size and
    the merge constants; the reference frame's alignment and robustness
    state; and the per-frame stages, every tensor they hand on passed
    through ``q``."""
    dev = frames.device
    frames = q(frames.to(F32))
    ref = frames[0]
    alpha, beta = float(cfg["noise_model"]["alpha"]), float(cfg["noise_model"]["beta"])
    std_c, diff_c = noise_curves(alpha, beta, dev)
    snr_set = snr_settings(snr_of(ref, std_c))
    bm = dict(cfg["block_matching"]["tuning"])
    Ts = snr_set["tile_size"]
    bm["tile_size"] = Ts
    bm["tile_sizes"] = [int(Ts * f) for f in bm["tile_size_factors"]]
    mt = dict(cfg["merging"]["tuning"], **{k: v for k, v in snr_set.items() if k != "tile_size"})
    tun = cfg["robustness"]["tuning"]
    curves = (torch.as_tensor(std_c, dtype=F32, device=dev),
              torch.as_tensor(diff_c, dtype=F32, device=dev))
    aligner = Aligner(q(grey_fft(ref)), bm, int(cfg["ica"]["tuning"]["n_iter"]))
    stats = ref_stats(ref, cfa, wb, curves, Ts)

    def covs(f):
        return q(covariances(f, alpha, beta, mt).contiguous())

    def frame(f):
        flow = q(aligner.flow(q(grey_fft(f))))
        return flow, q(robustness(f, stats, flow, cfa, wb, Ts, tun)), covs(f)

    return Analysis(frames, Ts, frame, covs)


def denoiser_of(cfg, acc_r):
    """The reference merge's accumulated-robustness denoiser (acc_rob,
    rad_max, max_multiplier, max_frame_count), or None where it is off."""
    m = cfg["accumulated_robustness_denoiser"]["merge"]
    return (acc_r, int(m["rad_max"]), float(m["max_multiplier"]),
            float(m["max_frame_count"])) if m["enabled"] else None


def reference_burst(frames, cfg, cfa, wb, stage=None):
    """``(image (sH, sW, 3), accumulated robustness (H, W))`` of the burst
    ``frames`` (N, H, W) float32 on one device (frame 0 the reference) under
    the configuration tree ``cfg`` (the configuration file's, as plain
    dicts)."""
    check_supported(cfg)
    q = stage or _keep
    an = analysis(frames, cfg, cfa, wb, q)
    ref, Ts, s = an.frames[0], an.tile_size, int(cfg["scale"])
    dev = ref.device
    H, W = ref.shape
    acc_r = torch.zeros((H, W), dtype=F32, device=dev)
    B = Ts * s
    shape = (3, -(-H * s // B) * B, -(-W * s // B) * B)
    num = torch.zeros(shape, dtype=F32, device=dev)
    den = torch.zeros_like(num)
    # each frame is merged as soon as it is analysed: the fused form's sums
    # run over the frames in the same order, so holding every frame's maps
    # first would change nothing but the memory
    for frame in an.frames[1:]:
        flow, r, covs = an.frame(frame)
        acc_r = acc_r + r
        merge_frame(frame, flow, covs, r, num, den, cfa, Ts, s)
    merge_reference(ref, an.covs(ref), num, den, cfa, s, denoiser_of(cfg, acc_r))
    num, den = q(num), q(den)
    image = q(normalize_slabs(num, den, B, H * s, W * s).permute(1, 2, 0))
    if cfg["postprocessing"]["enabled"]:
        image = q(finish(image.to(F32), cfg["postprocessing"]))
    return image, acc_r
