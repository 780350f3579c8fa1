"""Robustness and merge-kernel covariances of the plain reference
(Wronski et al. 2019, Algs. 5-9; the reference implementation's
``robustness.py`` and ``kernels.py``), in plain torch.

Robustness: the half-resolution guide image with white balance undone, its
3x3 local statistics, a Dodgson quadratic upscale-warp of them to the raw
grid along the tile's flow (out-of-grid statistics marked invalid, R = 0
there), the noise-corrected channel distance, the flow-discontinuity term,
the threshold and a 5x5 local minimum. Covariances: the generalised
Anscombe transform, the 2x2-mean grey image, half-pixel gradients, the
structure tensor over 2x2 windows, its eigen-decomposition and the
steerable kernel's stretch and shrink.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

F32 = torch.float32


def _div(x, s):
    """``x / s`` by a tensor on x's device (a true division on every device)."""
    return x / torch.full((), float(s), dtype=F32, device=x.device)


def _edge_pad(img, r, dim):
    n = img.shape[dim]
    return img.index_select(dim, torch.clamp(torch.arange(-r, n + r, device=img.device), 0, n - 1))


def _local_stats_3x3(img):
    h, w = img.shape[-2:]

    def box3(x):
        p = _edge_pad(x, 1, -2)
        r = p[..., 0:h, :] + p[..., 1:1 + h, :] + p[..., 2:2 + h, :]
        p = _edge_pad(r, 1, -1)
        return p[..., :, 0:w] + p[..., :, 1:1 + w] + p[..., :, 2:2 + w]

    mean = box3(img) / 9.0
    return mean, box3(img * img) / 9.0 - mean * mean


def _local_min_5x5(img):
    h, w = img.shape[-2:]
    p = _edge_pad(img, 2, -2)
    rows = p[..., 0:h, :]
    for i in range(1, 5):
        rows = torch.minimum(rows, p[..., i:i + h, :])
    p = _edge_pad(rows, 2, -1)
    out = p[..., :, 0:w]
    for j in range(1, 5):
        out = torch.minimum(out, p[..., :, j:j + w])
    return out


def _dodgson(x):
    ax = torch.abs(x)
    return torch.where(ax <= 0.5, -2.0 * ax * ax + 1.0,
                       torch.where(ax <= 1.5, ax * ax - 2.5 * ax + 1.5, torch.zeros_like(ax)))


def _guide(raw, cfa, wb):
    h, w = raw.shape
    quads = raw[: (h // 2) * 2, : (w // 2) * 2].reshape(h // 2, 2, w // 2, 2)
    chans, green = [None, None, None], 0.0
    for i in range(2):
        for j in range(2):
            c = int(cfa[i][j])
            x = quads[:, i, :, j] / wb[c]
            if c == 1:
                green = green + x
            else:
                chans[c] = x
    chans[1] = green / 2.0
    return torch.stack(chans, dim=0).to(F32)


def warp_stats(stats, u, Ts, flow, out_shape):
    """Guide-grid statistics (c, lh, lw) warped to the raw grid (c, H, W) along
    each Ts-tile's flow, and their validity (H, W). Within a tile the 3x3
    Dodgson centre follows ``(Sy + 1) + (y_loc + ph_y) // u``; values come
    from the window at the clipped origin (edge-clamped), weights from the
    true centre, and a tile whose origin was clipped is invalid."""
    c, lh, lw = stats.shape
    H, W = out_shape
    WIN = Ts // u + 4
    PAD = WIN + 1
    dev = stats.device
    Y = torch.arange(H, device=dev)[:, None]
    X = torch.arange(W, device=dev)[None, :]
    ty, tx = Y // Ts, X // Ts
    fx, fy = flow[ty, tx, 0].to(F32), flow[ty, tx, 1].to(F32)

    def axis(f, t, loc, n):
        base = t * Ts + torch.floor(f + 0.5).long()
        S = torch.div(base, u, rounding_mode="floor") - 1
        ph = base - u * (S + 1)
        Sc = torch.clamp(S, -PAD, n + PAD - WIN)
        return S, Sc, torch.div(loc + ph, u, rounding_mode="floor")

    Sy, Syc, q_y = axis(fy, ty, Y - ty * Ts, lh)
    Sx, Sxc, q_x = axis(fx, tx, X - tx * Ts, lw)
    lr_y = _div(Y.to(F32) + fy + 0.5, u) - 0.5
    lr_x = _div(X.to(F32) + fx + 0.5, u) - 0.5
    valid = (lr_y >= 0) & (lr_y < lh) & (lr_x >= 0) & (lr_x < lw) & (Syc == Sy) & (Sxc == Sx)
    acc = torch.zeros((c, H, W), dtype=F32, device=dev)
    w_acc = torch.zeros((H, W), dtype=F32, device=dev)
    for i in (-1, 0, 1):
        yc = torch.clamp(Sy + 1 + q_y + i, 0, lh - 1).to(F32)
        wy = _dodgson(yc - lr_y)
        vy = torch.clamp(Syc + 1 + q_y + i, 0, lh - 1)
        for j in (-1, 0, 1):
            xc = torch.clamp(Sx + 1 + q_x + j, 0, lw - 1).to(F32)
            wgt = wy * _dodgson(xc - lr_x)
            vx = torch.clamp(Sxc + 1 + q_x + j, 0, lw - 1)
            acc = acc + stats[:, vy, vx] * wgt[None]
            w_acc = w_acc + wgt
    return acc / w_acc[None], valid


class RefStats(NamedTuple):
    means: torch.Tensor
    d_t: torch.Tensor
    sigma_sq: torch.Tensor
    valid: torch.Tensor


def _lut(tables, x, scale=1000.0):
    idx = torch.clamp(torch.round(scale * x), 0, int(tables[0].shape[0]) - 1).long()
    return [t.to(x.dtype)[idx] for t in tables]


def ref_stats(ref, cfa, wb, curves, Ts):
    guide = _guide(ref, cfa, wb)
    means, stds = _local_stats_3x3(guide)
    out_shape = (guide.shape[1] * 2, guide.shape[2] * 2)
    zero = torch.zeros((-(-out_shape[0] // Ts), -(-out_shape[1] // Ts), 2), dtype=F32,
                       device=ref.device)
    hr_means, valid = warp_stats(means.contiguous(), 2, Ts, zero, out_shape)
    hr_stds, _ = warp_stats(stds.contiguous(), 2, Ts, zero, out_shape)
    sigma_t, d_t = _lut(list(curves), hr_means)
    sigma_sq = torch.sum(torch.maximum(hr_stds, sigma_t * sigma_t), dim=0)
    return RefStats(hr_means, d_t, sigma_sq, valid)


def _flow_range_s(flow, m_th, s1, s2):
    def rng3(a):
        h, w = a.shape
        p = _edge_pad(_edge_pad(a, 1, 0), 1, 1)
        hi = lo = p[0:h, 0:w]
        for i in range(3):
            for j in range(3):
                v = p[i:i + h, j:j + w]
                hi, lo = torch.maximum(hi, v), torch.minimum(lo, v)
        return hi - lo

    d0, d1 = rng3(flow[..., 0]), rng3(flow[..., 1])
    return torch.where(d0 * d0 + d1 * d1 > m_th * m_th, torch.full_like(d0, float(s1)),
                       torch.full_like(d0, float(s2)))


def robustness(frame, stats, flow, cfa, wb, Ts, tun):
    """The compared frame's robustness map (H, W) (Alg. 6)."""
    guide = _guide(frame, cfa, wb)
    means, _ = _local_stats_3x3(guide)
    out_shape = (guide.shape[1] * 2, guide.shape[2] * 2)
    means, valid = warp_stats(means.contiguous(), 2, Ts, flow.to(F32).contiguous(), out_shape)
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


def _eigen_2x2(m00, m01, m10, m11):
    b, c = -(m00 + m11), m00 * m11 - m01 * m10
    sq = torch.sqrt(torch.clamp(b * b - 4.0 * c, min=0.0))
    r1, r2 = (-b + sq) / 2.0, (-b - sq) / 2.0
    big = torch.abs(r1) >= torch.abs(r2)
    l1, l2 = torch.where(big, r1, r2), torch.where(big, r2, r1)
    v0, v1 = m00 + m01 - l2, m10 + m11 - l2
    norm = torch.sqrt(v0 * v0 + v1 * v1)
    safe = torch.where(norm > 0, norm, torch.ones_like(norm))
    n0, n1 = v0 / safe, v1 / safe
    sign = torch.sign(n0) + (n0 == 0).to(n0.dtype)
    e10, e11, e20, e21 = n0, n1, -n1 * sign, torch.abs(n0)
    one, zero = torch.ones_like(n0), torch.zeros_like(n0)
    z0 = v0 == 0
    z1 = ~z0 & (v1 == 0)
    e10 = torch.where(z0, zero, torch.where(z1, one, e10))
    e11 = torch.where(z0, one, torch.where(z1, zero, e11))
    e20 = torch.where(z0, one, torch.where(z1, zero, e20))
    e21 = torch.where(z0, zero, torch.where(z1, one, e21))
    ident = (m01 == 0) & (m00 == m11)
    e10, e11 = torch.where(ident, one, e10), torch.where(ident, zero, e11)
    e20, e21 = torch.where(ident, zero, e20), torch.where(ident, one, e21)
    return (l1, l2), (e10, e11), (e20, e21)


def covariances(img, alpha, beta, mt):
    """Steerable kernel covariances (3, gh, gw) = (xx, xy, yy) on the grey
    grid of a Bayer frame (Alg. 5, linear selection law)."""
    vst = torch.clamp(alpha * img + (3.0 / 8.0) * alpha * alpha + beta, min=0.0)
    vst = (2.0 / alpha) * torch.sqrt(vst.double()).to(vst.dtype)
    h, w = vst.shape
    q = vst[: (h // 2) * 2, : (w // 2) * 2].to(F32)
    grey = (((q[0::2, 0::2] + q[0::2, 1::2]) + q[1::2, 0::2]) + q[1::2, 1::2]) / 4.0
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
