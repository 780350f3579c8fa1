"""Merge, refill and divide of the plain reference (Wronski et al. 2019,
Algs. 4 and 11; the reference implementation's ``merge.py``), in plain torch,
Bayer mode with the steerable kernel at an integer scale s.

The burst is merged as the fused form of the JAX package merges it
(``models/merge_slab.py``): every compared frame, then the reference frame,
into accumulators of whole HR tiles (``B = Ts * s``), every padded row
taking its share; then each B-row slab is refilled and divided on its own
(starved pixels, weight under 1e-4, re-normalized twice from the 5x5 sums
of their well-fed neighbours, with no context past the slab), and the image
is cropped to (3, sH, sW). Evaluated in bands of HR rows, so that no
full-size tap temporaries exist.
"""

import torch
import torch.nn.functional as F

F32 = torch.float32
EPS_DIV = 1e-10
STARVED_DEN = 1e-4


def _div(x, s):
    return x / torch.full((), float(s), dtype=F32, device=x.device)


def _cov_at(cv, i, j):
    """``cv[i, j]``, index -1 the linear extrapolation ``2 c[0] - c[1]`` (rows
    first, then columns), indices past it the edge values."""
    gh, gw = cv.shape

    def row(ii, jj):
        jc = jj.clamp(0, gw - 1)
        ext = 2.0 * cv[0, jc] - cv[min(1, gh - 1), jc]
        return torch.where(ii == -1, ext, cv[ii.clamp(0, gh - 1), jc])

    zero = torch.zeros_like(j)
    col_ext = 2.0 * row(i, zero) - row(i, zero + min(1, gw - 1))
    return torch.where(j == -1, col_ext, row(i, j))


def _quad(inv, dx, dy):
    ixx, ixy, iyy = inv
    return torch.clamp(ixx * dx * dx + 2.0 * ixy * dx * dy + iyy * dy * dy, min=0.0)


def _accumulate(vals, accs, w, c, i, j, cfa):
    pi, pj = torch.remainder(i, 2), torch.remainder(j, 2)
    ch = torch.where(pi == 0, torch.where(pj == 0, int(cfa[0][0]), int(cfa[0][1])),
                     torch.where(pj == 0, int(cfa[1][0]), int(cfa[1][1])))
    for k in range(len(vals)):
        mask = (ch == k).to(F32)
        vals[k] = vals[k] + w * c * mask
        accs[k] = accs[k] + w * mask


def merge_frame(comp, flow, covs, r, num, den, cfa, Ts, s):
    """Add one compared frame to ``num``/``den`` (3, rows, cols) in place."""
    H, W = comp.shape
    gh, gw = covs.shape[1:]
    _, acc_h, out_w = num.shape
    B = Ts * s
    dev = comp.device
    WIN, CWIN = Ts + 4, Ts // 2 + 4
    PAD, CPAD = WIN + 1, CWIN + 1
    sg = 2 * s
    C = torch.arange(out_w, device=dev)[None, :]
    tx = C // B
    fdiv = lambda a, b: torch.div(a, b, rounding_mode="floor")  # noqa: E731
    for y0 in range(0, acc_h, 8 * B):
        y1 = min(y0 + 8 * B, acc_h)
        R = torch.arange(y0, y1, device=dev)[:, None]
        ty = R // B
        rl_y, rl_x = R - ty * B, C - tx * B
        fx, fy = flow[ty, tx, 0].to(F32), flow[ty, tx, 1].to(F32)

        def window(f, t, rl, period, shift, n, win, pad):
            base = t * B + torch.floor(0.5 + s * f - shift).long()
            S = fdiv(base, period) - 1
            ph = base - period * (S + 1)
            return S, torch.clamp(S, -pad, n + pad - win), fdiv(rl + ph, period)

        Sy, Syc, q_y = window(fy, ty, rl_y, s, 0.0, H, WIN, PAD)
        Sx, Sxc, q_x = window(fx, tx, rl_x, s, 0.0, W, WIN, PAD)
        ok_tile = (Syc == Sy) & (Sxc == Sx)
        center_i, center_j = Sy + 1 + q_y, Sx + 1 + q_x
        lr_y = _div(R.to(F32) + 0.5, s) + fy
        lr_x = _div(C.to(F32) + 0.5, s) + fx
        inb_center = (lr_y >= 0) & (lr_y < H) & (lr_x >= 0) & (lr_x < W) & ok_tile
        local_r = r[torch.clamp(R // s, max=H - 1), torch.clamp(C // s, max=W - 1)]

        S2y, S2yc, q2_y = window(fy, ty, rl_y, sg, 0.5 * sg, gh, CWIN, CPAD)
        S2x, S2xc, q2_x = window(fx, tx, rl_x, sg, 0.5 * sg, gw, CWIN, CPAD)
        frac_y = (lr_y / 2 - 0.5) - (S2y + 1 + q2_y).to(F32)
        frac_x = (lr_x / 2 - 0.5) - (S2x + 1 + q2_x).to(F32)
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

        wr = torch.where(inb_center, local_r, torch.zeros((), device=dev))
        vals, accs = [0.0] * 3, [0.0] * 3
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
                c = torch.where(in_frame, comp[vy.clamp(0, H - 1), vx.clamp(0, W - 1)],
                                torch.zeros((), device=dev))
                w = torch.exp(-0.5 * _quad(inv, dist_x, dist_y)) * wr * inb
                _accumulate(vals, accs, w, c, i_g, j_g, cfa)
        num[:, y0:y1] += torch.stack(vals, 0)
        den[:, y0:y1] += torch.stack(accs, 0)


def _interp_cov(covs, ki, kj):
    gh, gw = covs.shape[1], covs.shape[2]
    iy, ix = torch.trunc(ki), torch.trunc(kj)
    fr_y, fr_x = ki - iy, kj - ix
    fy, fx = torch.clamp(iy.long(), 0, gh - 1), torch.clamp(ix.long(), 0, gw - 1)
    cy, cx = torch.clamp(fy + 1, max=gh - 1), torch.clamp(fx + 1, max=gw - 1)
    out = []
    for k in range(3):
        tr, tl = covs[k, fy, fx], covs[k, fy, cx]
        br, bl = covs[k, cy, fx], covs[k, cy, cx]
        top = tr + fr_x * (tl - tr)
        bot = br + fr_x * (bl - br)
        out.append(top + fr_y * (bot - top))
    return out


def _guarded_inverse(cc):
    cxx, cxy, cyy = cc
    det = cxx * cyy - cxy * cxy
    ok = torch.abs(det) > EPS_DIV
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one), one)
    return (torch.where(ok, inv_det * cyy, one), torch.where(ok, -inv_det * cxy, torch.zeros_like(det)),
            torch.where(ok, inv_det * cxx, one))


def merge_reference(ref, covs, num, den, cfa, s, denoiser=None, band_rows=512):
    """Add the reference frame to ``num``/``den`` in place. HR pixel R sits
    at ``R / s``, taps centred on ``round(R / s)``, the covariance taken at
    ``(R / s - 0.5) / 2`` on the grey grid. ``denoiser`` (acc_rob, rad_max,
    max_multiplier, max_frame_count): the accumulated-robustness denoiser,
    whose pixels seen by at most ``max_frame_count`` frames take taps to
    ``rad_max`` with ``z / max_multiplier``, and whose pixels seen by fewer
    replace the sums instead of adding to them."""
    rr = int(denoiser[1]) if denoiser is not None else 1
    H, W = ref.shape
    _, out_h, out_w = num.shape
    dev = ref.device
    pos_x = _div(torch.arange(out_w, dtype=F32, device=dev)[None, :], s)
    center_x = torch.round(pos_x).long()
    kmap_x = (pos_x - 0.5) / 2.0
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        pos_y = _div(torch.arange(y0, y1, dtype=F32, device=dev)[:, None], s)
        center_y = torch.round(pos_y).long()
        inv = _guarded_inverse(_interp_cov(covs, (pos_y - 0.5) / 2.0, kmap_x))
        if denoiser is not None:
            acc_rob, _, mult, count = denoiser
            local_acc = acc_rob[center_y.clamp(0, H - 1), center_x.clamp(0, W - 1)]
            few = local_acc <= float(count)
            power = torch.where(few, float(mult), 1.0)
            rad = torch.where(few, rr, 1)
        vals, accs = [0.0] * 3, [0.0] * 3
        for di in range(-rr, rr + 1):
            i = center_y + di
            inb_i = (i >= 0) & (i < H)
            dist_y = i.to(F32) - pos_y
            for dj in range(-rr, rr + 1):
                j = center_x + dj
                inb = inb_i & (j >= 0) & (j < W)
                z = _quad(inv, j.to(F32) - pos_x, dist_y)
                if denoiser is not None:
                    inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
                    z = z / power
                c = ref[i.clamp(0, H - 1), j.clamp(0, W - 1)]
                _accumulate(vals, accs, torch.exp(-0.5 * z) * inb, c, i, j, cfa)
        val, acc = torch.stack(vals, 0), torch.stack(accs, 0)
        if denoiser is not None:
            overwrite = local_acc < float(denoiser[3])
            num[:, y0:y1] = torch.where(overwrite, val, num[:, y0:y1] + val)
            den[:, y0:y1] = torch.where(overwrite, acc, den[:, y0:y1] + acc)
        else:
            num[:, y0:y1] += val
            den[:, y0:y1] += acc


def _box5(x):
    h, w = x.shape[-2:]
    p = F.pad(x, (0, 0, 2, 2))
    r = p[..., 0:h, :] + p[..., 1:1 + h, :] + p[..., 2:2 + h, :] + p[..., 3:3 + h, :] \
        + p[..., 4:4 + h, :]
    p = F.pad(r, (2, 2))
    return p[..., 0:w] + p[..., 1:1 + w] + p[..., 2:2 + w] + p[..., 3:3 + w] + p[..., 4:4 + w]


def _refill_divide(num, den):
    good = den > STARVED_DEN
    zero = torch.zeros((), dtype=num.dtype, device=num.device)
    n, d = torch.where(good, num, zero), torch.where(good, den, zero)
    for _ in range(2):
        bn, bd = _box5(n), _box5(d)
        n, d = torch.where(good, n, bn), torch.where(good, d, bd)
        good = d > STARVED_DEN
    return n / torch.clamp(d, min=EPS_DIV)


def normalize_slabs(num, den, B, out_h, out_w, slab_group=16):
    """Each B-row slab refilled and divided on its own; the (3, out_h, out_w)
    crop."""
    c, h, w = num.shape
    out = torch.empty_like(num)
    for y0 in range(0, h, B * slab_group):
        y1 = min(y0 + B * slab_group, h)
        nt = (y1 - y0) // B

        def split(x):
            return x[:, y0:y1].reshape(c, nt, B, w).permute(1, 0, 2, 3)

        out[:, y0:y1] = _refill_divide(split(num), split(den)).permute(1, 0, 2, 3).reshape(
            c, y1 - y0, w)
    return out[:, :out_h, :out_w]
