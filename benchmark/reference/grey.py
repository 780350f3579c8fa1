"""The plain reference of a monochrome burst (``mode: grey``): raw grey
frames to the finished image through the fused form at an integer scale s,
in plain torch, float32; imports nothing of the program.

A grey frame has no colour filter array, so every step that reads one in
Bayer mode is written anew here; the rest is :mod:`.pipeline`'s:

- the noise curves, the burst's SNR, the tile size and the merge constants
  (:mod:`.noise`), and the coarse-to-fine alignment (:class:`.align.Aligner`),
  which runs on the frames themselves: a grey frame is its own grey image,
  so no FFT low-pass runs;
- robustness (Wronski et al. 2019, Algs. 6-9): the guide is the frame itself,
  one channel at full resolution; its 3x3 statistics are warped along each
  tile's flow to the same grid at the upscale u = 1; then the channel
  distance, the noise-model correction, the flow-discontinuity term, the
  threshold and the 5x5 minimum of :func:`.robust.robustness`;
- the kernel covariances (Alg. 5): the generalised Anscombe transform, then
  half-pixel gradients, the structure tensor over 2x2 windows, its
  eigen-decomposition and the steerable kernel's linear law, all on the
  full-resolution frame, with no 2x2 decimation: ``(3, H, W)`` on the raw
  grid;
- the merge (Algs. 4 and 11) into one plane that takes every tap: each
  compared frame through the fused form's tile windows (HR pixel ``R`` at
  ``lr = (R + 0.5) / s + flow``, taps around ``int(lr)``, distances to
  ``lr - 0.5``, the covariance read on the raw grid at ``lr - 0.5`` with
  signed fractions and an unguarded inverse), then the reference frame
  (``R / s``, taps around ``round(R / s)``, the covariance read on the raw
  grid at ``R / s``, the inverse guarded), into accumulators of whole HR
  tiles (``B = Ts * s``) whose padded rows take their share as well;
- the refill and divide of each B-row slab (:func:`.merge.normalize_slabs`),
  the crop to ``(sH, sW)``, the plane repeated to three channels, and the
  device finishing (:func:`.pipeline.finish`).

Departures from the published reference implementation, each the port's
documented one (README, "Parity notes"):

- the robustness statistics are warped at the true upscale, 1, where the
  reference's ``cuda_uspcale_dogson`` hard-codes 2 in grey mode too;
- warped statistics that fall off the guide's grid are marked invalid and
  give R = 0, where the reference poisons them with inf/NaN;
- noise-curve look-ups are clamped to the curve's domain;
- a zero structure tensor gives the isotropic kernel, where the reference
  gives NaN;
- starved accumulator pixels (weight under 1e-4) are refilled from the 5x5
  sums of their well-fed neighbours, per B-row slab, where the reference
  divides bare;
- the Monte-Carlo noise curves are drawn from a ``torch.Generator`` seeded
  with 0, in the port's order (:mod:`.noise`).

Supports the grey trees that the fused form runs at an integer scale: FFT
grey (the only one grey mode admits), nearest flow upscaling, the steerable
kernel with the linear law, robustness on, no denoiser, no colour
correction, tonemapping or devignetting, ``tpu.pipeline`` "auto" or
"fused", a tiled ``tpu.merge_impl`` and the slab refill. Anything else is
refused with a ``ValueError`` that names the key.

``stage`` (optional) is applied to every tensor handed from one stage to
the next (frames, flows, robustness maps, covariances, accumulators,
image), as in :func:`.pipeline.reference_burst`.
"""

import torch
import torch.nn.functional as F

from .align import Aligner
from .merge import _cov_at, _div, _guarded_inverse, _interp_cov, _quad, normalize_slabs
from .noise import noise_curves, snr_of, snr_settings
from .pipeline import SUPPORTED, _get, _keep, finish
from .robust import (RefStats, _eigen_2x2, _flow_range_s, _local_min_5x5, _local_stats_3x3,
                     _lut, warp_stats)

F32 = torch.float32

#: what this reference implements of the configuration tree (keys that a
#: grey tree must hold as given); :func:`check_supported` adds the scale and
#: the form
GREY = dict(SUPPORTED, mode="grey", **{"accumulated_robustness_denoiser.merge.enabled": False})


def check_supported(cfg):
    """Refuse, with a ``ValueError`` that names the key, a tree that this
    reference does not implement."""
    for key, want in GREY.items():
        if _get(cfg, key) != want:
            raise ValueError(f"the grey reference does not implement {key}={_get(cfg, key)!r}")
    if float(cfg["scale"]) != int(cfg["scale"]):
        raise ValueError(f"the grey reference does not implement scale={cfg['scale']!r} "
                         "(it merges at an integer scale only)")
    tpu = cfg.get("tpu", {})
    for key, allowed in (("pipeline", ("auto", "fused")),
                         ("merge_impl", ("auto", "tiled", "pallas")),
                         ("fused_impl", ("slab",))):
        value = tpu.get(key, allowed[0])
        if value not in allowed:
            raise ValueError(f"the grey reference does not implement tpu.{key}={value!r} "
                             "(it implements the fused form with the slab refill)")


def ref_stats(ref, curves, Ts):
    """The reference frame's 3x3 statistics at full resolution, warped with
    zero flow at u = 1, and the noise curves' terms there."""
    means, stds = _local_stats_3x3(ref[None])
    H, W = ref.shape
    zero = torch.zeros((-(-H // Ts), -(-W // Ts), 2), dtype=F32, device=ref.device)
    hr_means, valid = warp_stats(means.contiguous(), 1, Ts, zero, (H, W))
    hr_stds, _ = warp_stats(stds.contiguous(), 1, Ts, zero, (H, W))
    sigma_t, d_t = _lut(list(curves), hr_means)
    sigma_sq = torch.sum(torch.maximum(hr_stds, sigma_t * sigma_t), dim=0)
    return RefStats(hr_means, d_t, sigma_sq, valid)


def robustness(frame, stats, flow, Ts, tun):
    """The compared frame's robustness map (H, W) (Alg. 6), its own guide."""
    means, _ = _local_stats_3x3(frame[None])
    means, valid = warp_stats(means.contiguous(), 1, Ts, flow.to(F32).contiguous(),
                              frame.shape)
    d_p = torch.abs(stats.means - means)
    d_p_sq = d_p * d_p
    shrink = d_p_sq / (d_p_sq + stats.d_t * stats.d_t)
    d_sq = torch.sum(d_p_sq * shrink * shrink, dim=0)
    S = _flow_range_s(flow, tun["Mt"], tun["s1"], tun["s2"])
    h, w = d_sq.shape
    s_map = S.repeat_interleave(Ts, 0).repeat_interleave(Ts, 1)[:h, :w]
    R = torch.clamp(s_map * torch.exp(-d_sq / stats.sigma_sq) - tun["t"], 0.0, 1.0)
    R = torch.where(stats.valid & valid, R, torch.zeros((), device=R.device))
    return _local_min_5x5(R)


def covariances(img, alpha, beta, mt):
    """Steerable kernel covariances (3, H, W) = (xx, xy, yy) on the raw grid
    of a grey frame (Alg. 5, linear selection law, no decimation)."""
    vst = torch.clamp(alpha * img + (3.0 / 8.0) * alpha * alpha + beta, min=0.0)
    grey = (2.0 / alpha) * torch.sqrt(vst.double()).to(vst.dtype)
    dx = 0.5 * (grey[:, 1:] - grey[:, :-1])
    gx = 0.5 * (dx[:-1, :] + dx[1:, :])
    ax = 0.5 * (grey[:, 1:] + grey[:, :-1])
    gy = 0.5 * (ax[1:, :] - ax[:-1, :])

    def window_sum(a):
        p = F.pad(a, (1, 1, 1, 1))
        return p[:-1, :-1] + p[:-1, 1:] + p[1:, :-1] + p[1:, 1:]

    st00, st01, st11 = window_sum(gx * gx), window_sum(gx * gy), window_sum(gy * gy)
    (l1, l2), (e10, e11), (e20, e21) = _eigen_2x2(st00, st01, st01, st11)
    tr = l1 + l2
    one = torch.ones_like(tr)
    A = torch.where(tr > 0, 1.0 + torch.sqrt(torch.clamp(l1 - l2, min=0.0)
                                             / torch.where(tr > 0, tr, one)), one)
    D = torch.clamp(1.0 - torch.sqrt(torch.clamp(l1, min=0.0)) / mt["D_tr"] + mt["D_th"],
                    0.0, 1.0)
    k1 = 1.0 + A / 2.0 * (1.0 / mt["k_shrink"] - 1.0)
    k2 = 1.0 + A / 2.0 * (mt["k_stretch"] - 1.0)
    kk1 = mt["k_detail"] * ((1.0 - D) * k1 + D * mt["k_denoise"])
    kk2 = mt["k_detail"] * ((1.0 - D) * k2 + D * mt["k_denoise"])
    k1s, k2s = kk1 * kk1, kk2 * kk2
    return torch.stack([k1s * e10 * e10 + k2s * e20 * e20, k1s * e10 * e11 + k2s * e20 * e21,
                        k1s * e11 * e11 + k2s * e21 * e21]).to(F32)


def merge_frame(comp, flow, covs, r, num, den, Ts, s):
    """Add one compared frame to the one plane of ``num``/``den`` (1, rows,
    cols) in place, in bands of 8 tile rows."""
    H, W = comp.shape
    _, acc_h, out_w = num.shape
    B = Ts * s
    dev = comp.device
    WIN = Ts + 4                # the frame's and the covariances' window
    PAD = WIN + 1
    zero = torch.zeros((), device=dev)
    C = torch.arange(out_w, device=dev)[None, :]
    tx = C // B
    fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
    for y0 in range(0, acc_h, 8 * B):
        y1 = min(y0 + 8 * B, acc_h)
        R = torch.arange(y0, y1, device=dev)[:, None]
        ty = R // B
        rl_y, rl_x = R - ty * B, C - tx * B
        fx, fy = flow[ty, tx, 0].to(F32), flow[ty, tx, 1].to(F32)

        def window(f, t, rl, n, shift):
            base = t * B + torch.floor(0.5 + s * f - shift).long()
            S = fdiv(base, s) - 1
            ph = base - s * (S + 1)
            return S, torch.clamp(S, -PAD, n + PAD - WIN), fdiv(rl + ph, s)

        Sy, Syc, q_y = window(fy, ty, rl_y, H, 0.0)
        Sx, Sxc, q_x = window(fx, tx, rl_x, W, 0.0)
        ok_tile = (Syc == Sy) & (Sxc == Sx)
        center_i, center_j = Sy + 1 + q_y, Sx + 1 + q_x
        lr_y = _div(R.to(F32) + 0.5, s) + fy
        lr_x = _div(C.to(F32) + 0.5, s) + fx
        inb_center = (lr_y >= 0) & (lr_y < H) & (lr_x >= 0) & (lr_x < W) & ok_tile
        local_r = r[torch.clamp(R // s, max=H - 1), torch.clamp(C // s, max=W - 1)]

        S2y, S2yc, q2_y = window(fy, ty, rl_y, H, 0.5 * s)
        S2x, S2xc, q2_x = window(fx, tx, rl_x, W, 0.5 * s)
        frac_y = (lr_y - 0.5) - (S2y + 1 + q2_y).to(F32)
        frac_x = (lr_x - 0.5) - (S2x + 1 + q2_x).to(F32)
        ci, cj = S2yc + 1 + q2_y, S2xc + 1 + q2_x
        cc = []
        for k in range(3):
            c00, c01 = _cov_at(covs[k], ci, cj), _cov_at(covs[k], ci, cj + 1)
            c10, c11 = _cov_at(covs[k], ci + 1, cj), _cov_at(covs[k], ci + 1, cj + 1)
            top = c00 + frac_x * (c01 - c00)
            bot = c10 + frac_x * (c11 - c10)
            cc.append(top + frac_y * (bot - top))
        inv_det = 1.0 / (cc[0] * cc[2] - cc[1] * cc[1])
        inv = (inv_det * cc[2], -inv_det * cc[1], inv_det * cc[0])

        wr = torch.where(inb_center, local_r, zero)
        val = acc = 0.0
        for di in (-1, 0, 1):
            i_g = center_i + di
            inb_i = (i_g >= 0) & (i_g < H)
            dist_y = i_g.to(F32) - (lr_y - 0.5)
            vy = Syc + 1 + di + q_y
            for dj in (-1, 0, 1):
                j_g = center_j + dj
                inb = inb_i & (j_g >= 0) & (j_g < W)
                dist_x = j_g.to(F32) - (lr_x - 0.5)
                vx = Sxc + 1 + dj + q_x
                in_frame = (vy >= 0) & (vy < H) & (vx >= 0) & (vx < W)
                c = torch.where(in_frame, comp[vy.clamp(0, H - 1), vx.clamp(0, W - 1)], zero)
                w = torch.exp(-0.5 * _quad(inv, dist_x, dist_y)) * wr * inb
                val = val + w * c
                acc = acc + w
        num[0, y0:y1] += val
        den[0, y0:y1] += acc


def merge_reference(ref, covs, num, den, s, band_rows=512):
    """Add the reference frame to the one plane of ``num``/``den`` in place:
    HR pixel R at ``R / s``, taps centred on ``round(R / s)``, the
    covariance interpolated at ``R / s`` on the raw grid, the inverse
    guarded."""
    H, W = ref.shape
    _, out_h, out_w = num.shape
    dev = ref.device
    pos_x = _div(torch.arange(out_w, dtype=F32, device=dev)[None, :], s)
    center_x = torch.round(pos_x).long()
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        pos_y = _div(torch.arange(y0, y1, dtype=F32, device=dev)[:, None], s)
        center_y = torch.round(pos_y).long()
        inv = _guarded_inverse(_interp_cov(covs, pos_y, pos_x))
        val = acc = 0.0
        for di in (-1, 0, 1):
            i = center_y + di
            inb_i = (i >= 0) & (i < H)
            dist_y = i.to(F32) - pos_y
            for dj in (-1, 0, 1):
                j = center_x + dj
                inb = inb_i & (j >= 0) & (j < W)
                w = torch.exp(-0.5 * _quad(inv, j.to(F32) - pos_x, dist_y)) * inb
                val = val + w * ref[i.clamp(0, H - 1), j.clamp(0, W - 1)]
                acc = acc + w
        num[0, y0:y1] += val
        den[0, y0:y1] += acc


def reference_burst(frames, cfg, cfa, wb, stage=None):
    """``(image (sH, sW, 3), accumulated robustness (H, W))`` of the grey
    burst ``frames`` (N, H, W) float32 on one device (frame 0 the reference)
    under the configuration tree ``cfg`` (the image has the one plane
    without the finishing, as the program's); ``cfa`` and ``wb`` are not
    read (grey mode has neither)."""
    check_supported(cfg)
    q = stage or _keep
    dev = frames.device
    frames = q(frames.to(F32))
    ref = frames[0]
    alpha, beta = float(cfg["noise_model"]["alpha"]), float(cfg["noise_model"]["beta"])
    std_c, diff_c = noise_curves(alpha, beta, dev)
    snr_set = snr_settings(snr_of(ref, std_c))
    Ts, s = snr_set["tile_size"], int(cfg["scale"])
    bm = dict(cfg["block_matching"]["tuning"], tile_size=Ts)
    bm["tile_sizes"] = [int(Ts * f) for f in bm["tile_size_factors"]]
    mt = dict(cfg["merging"]["tuning"], **{k: v for k, v in snr_set.items() if k != "tile_size"})
    tun = cfg["robustness"]["tuning"]
    curves = (torch.as_tensor(std_c, dtype=F32, device=dev),
              torch.as_tensor(diff_c, dtype=F32, device=dev))
    aligner = Aligner(ref, bm, int(cfg["ica"]["tuning"]["n_iter"]))
    stats = ref_stats(ref, curves, Ts)

    H, W = ref.shape
    B = Ts * s
    acc_r = torch.zeros((H, W), dtype=F32, device=dev)
    num = torch.zeros((1, -(-H * s // B) * B, -(-W * s // B) * B), dtype=F32, device=dev)
    den = torch.zeros_like(num)
    # each frame is merged as soon as it is analysed: the fused form sums the
    # frames in the same order
    for frame in frames[1:]:
        flow = q(aligner.flow(frame))
        r = q(robustness(frame, stats, flow, Ts, tun))
        acc_r = acc_r + r
        merge_frame(frame, flow, q(covariances(frame, alpha, beta, mt).contiguous()), r, num,
                    den, Ts, s)
    merge_reference(ref, q(covariances(ref, alpha, beta, mt).contiguous()), num, den, s)
    num, den = q(num), q(den)
    image = q(normalize_slabs(num, den, B, H * s, W * s).permute(1, 2, 0))
    if cfg["postprocessing"]["enabled"]:
        image = q(finish(image.expand(-1, -1, 3), cfg["postprocessing"]))
    return image, acc_r
