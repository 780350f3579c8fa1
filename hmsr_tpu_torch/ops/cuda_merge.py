"""K5 (merge accumulation of one frame), K5' (the same over a chunk of
frames, accumulators read and written once), K6 (the whole burst and the
reference frame, accumulators written once), K7 (the refill and divide:
per group of K6's accumulators in the fused form, on the border strips of
the whole accumulators in the others) and K11 (the gather merge of one
frame at any scale): CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of :mod:`hmsr_tpu.ops.pallas_merge`: ``merge_pallas`` (per
frame) and ``merge_burst_pallas`` (frames grid); and of the JAX package's
XLA-only fused merges ``models/merge_slab.py:merge_burst_slab`` and
``models/merge_fused.py:merge_burst_tiled`` up to their normalization (K6)
and of that normalization and the border-strip one,
``ops/accumfix.py:normalize_accum`` (K7). The kernels are ``csrc/merge.cu`` and
``csrc/merge_burst.cu`` (both replace ``pallas_merge.py:_merge_group_kernel``),
``csrc/merge_fused.cu`` and ``csrc/refill.cu``; their
headers say what bounds them on the H100 and how the design answers it: one
block per HR tile (or band of one), tile windows staged in shared memory;
``csrc/common.cuh`` decides the launch layout (:func:`merge_layout` reads it
back). All carry the four variants of the Pallas kernel: Bayer or grey mode
(``grey``: one accumulator plane, covariances on the raw grid, no CFA pick)
times the steerable or the isotropic kernel (``iso``: no covariance is
read). K5 and K5' keep the plain ``(c, H*s, W*s)`` accumulators, c = 3
(Bayer) or 1 (grey) (the TPU's ``padded_accum_shape`` is a tiling
artefact), and update them in place. K5 also takes a band of them
(``row_offset``, the banded branch of ``merge_pallas`` that the sharded
pipeline's space axis runs): ``(c, rows, W*s)`` holding global HR rows from
``row_offset``, a multiple of ``Ts*s``. K6 returns new accumulators at the
fused merges' padded geometry (:func:`fused_accum_shape`). The reference
frame's merge, plain, is :func:`merge_ref_plain`. A wrapper launches its
kernel for CUDA tensors and runs the plain version only for CPU tensors;
``merge_accumulate.launches``, ``merge_burst_accumulate.launches``,
``merge_fused_accumulate.launches`` and ``refill_groups.launches`` (every
K7 launch, :func:`refill_image`'s too) count kernel launches,
``merge_accumulate.band_launches`` those of K5 into a band.

K11 (``csrc/merge_gather.cu``, :func:`gather_merge_accumulate`) replaces no
Pallas kernel: it is the JAX package's XLA gather merge
``hmsr_tpu/models/merge.py:merge``, whose conventions (the LR position
``(hr + 0.5) / s``, the flow tile ``lr // Ts``, no tiles) it keeps at any
scale; its plain version is :func:`gather_merge_plain`, and
``gather_merge_accumulate.launches`` counts its launches.
"""

import ctypes

import numpy as np
import torch

from . import _build
from .accumfix import STARVED_DEN, normalize_accum, normalize_groups, strip_width
from ..utils.types import DEFAULT_FLOAT, EPSILON_DIV


def _cov_at(cv, i, j):
    """``cv[i, j]`` with merge_tiled's covariance padding: index -1 holds the
    linear extrapolation ``2 c[0] - c[1]`` (rows first, then columns),
    indices beyond it the edge values."""
    gh, gw = cv.shape

    def row(ii, jj):
        jc = jj.clamp(0, gw - 1)
        ext = 2.0 * cv[0, jc] - cv[min(1, gh - 1), jc]
        return torch.where(ii == -1, ext, cv[ii.clamp(0, gh - 1), jc])

    zero = torch.zeros_like(j)
    col_ext = 2.0 * row(i, zero) - row(i, zero + min(1, gw - 1))
    return torch.where(j == -1, col_ext, row(i, j))


def scale_divisor(s, device):
    """The scale ``s`` as a 0-dim float tensor on ``device``, to divide by.
    PyTorch's CUDA division by a Python number multiplies by its rounded
    reciprocal, which differs from the division in the last bit for a third
    of the values at s=3; dividing by a tensor on the same device divides on
    the card as on the CPU (and as the kernels do). ``torch.full`` makes it
    on the device, without a copy from the host."""
    return torch.full((), float(s), dtype=DEFAULT_FLOAT, device=device)


def quad_form(inv, dist_x, dist_y):
    """The kernel's exponent ``z = max(0, d^T Omega^-1 d)`` of a tap at
    distance (dist_x, dist_y): ``inv`` is the inverse covariance (ixx, ixy,
    iyy), or None for the isotropic kernel, ``z = max(0, 2 (dx^2 + dy^2))``."""
    if inv is None:
        z = 2.0 * (dist_x * dist_x + dist_y * dist_y)
    else:
        ixx, ixy, iyy = inv
        z = ixx * dist_x * dist_x + 2.0 * ixy * dist_x * dist_y + iyy * dist_y * dist_y
    return torch.clamp(z, min=0.0)


def accumulate_tap(vals, accs, w, c, i, j, cfa):
    """Add ``w * c`` to ``vals`` and ``w`` to ``accs`` (per-channel lists):
    in the CFA channel of raw pixel (i, j) for a (2, 2) int array ``cfa``
    (Bayer), to the one channel for ``cfa=None`` (grey mode)."""
    if cfa is None:
        vals[0] = vals[0] + w * c
        accs[0] = accs[0] + w
        return
    pi, pj = torch.remainder(i, 2), torch.remainder(j, 2)
    ch = torch.where(pi == 0,
                     torch.where(pj == 0, int(cfa[0, 0]), int(cfa[0, 1])),
                     torch.where(pj == 0, int(cfa[1, 0]), int(cfa[1, 1])))
    for k in range(len(vals)):
        mask = (ch == k).to(DEFAULT_FLOAT)
        vals[k] = vals[k] + w * c * mask
        accs[k] = accs[k] + w * mask


def merge_plain(comp_img, flow, covs, r, num, den, cfa_pattern, tile_size,
                scale, grey=False, iso=False, row_offset=0, all_rows=False):
    """Plain version of K5: the semantics of
    :func:`hmsr_tpu.models.merge_tiled.merge_tiled` (integer scale; Bayer or
    ``grey`` mode, steerable or ``iso`` kernel) written per HR pixel,
    evaluated in bands of HR rows and accumulated into ``num``/``den`` in
    place. Returns ``(num, den)``. ``num``/``den`` hold global HR rows
    ``row_offset ..`` of the image; rows past the image take nothing, unless
    ``all_rows``: then every row of the accumulators takes its share as the
    fused merges compute it (K6, at their padded geometry).
    """
    s, Ts = int(scale), int(tile_size)
    g = 1 if grey else 2
    cfa = None if grey else np.asarray(cfa_pattern, dtype=np.int64)
    H, W = comp_img.shape
    gh, gw = covs.shape[1:]
    n_ch, acc_h, out_w = num.shape
    B = Ts * s
    band_rows = 8 * B           # bounds the per-band temporaries
    dev = comp_img.device
    WIN, CWIN = Ts + 4, Ts // g + 4
    PAD, CPAD = WIN + 1, CWIN + 1
    sg = s * g
    C = torch.arange(out_w, device=dev)[None, :]
    tx = C // B
    s_dev = scale_divisor(s, dev)

    def floordiv(a, b):
        return torch.div(a, b, rounding_mode="floor")

    # the band's rows in the image, or all of them
    n_rows = acc_h if all_rows else min(acc_h, H * s - row_offset)
    for y0 in range(0, n_rows, band_rows):
        y1 = min(y0 + band_rows, n_rows)
        R = torch.arange(row_offset + y0, row_offset + y1, device=dev)[:, None]
        ty = R // B
        rl_y, rl_x = R - ty * B, C - tx * B
        fx = flow[ty, tx, 0].to(DEFAULT_FLOAT)
        fy = flow[ty, tx, 1].to(DEFAULT_FLOAT)

        def window(f, t, rl, period, shift, n, win, pad):
            base = t * B + torch.floor(0.5 + s * f - shift).long()
            S = floordiv(base, period) - 1
            ph = base - period * (S + 1)
            Sc = torch.clamp(S, -pad, n + pad - win)
            return S, Sc, floordiv(rl + ph, period)

        Sy, Syc, q_y = window(fy, ty, rl_y, s, 0.0, H, WIN, PAD)
        Sx, Sxc, q_x = window(fx, tx, rl_x, s, 0.0, W, WIN, PAD)
        ok_tile = (Syc == Sy) & (Sxc == Sx)
        center_i, center_j = Sy + 1 + q_y, Sx + 1 + q_x

        lr_mov_y = (R.to(DEFAULT_FLOAT) + 0.5) / s_dev + fy
        lr_mov_x = (C.to(DEFAULT_FLOAT) + 0.5) / s_dev + fx
        inb_center = (lr_mov_y >= 0) & (lr_mov_y < H) & (lr_mov_x >= 0) & \
            (lr_mov_x < W) & ok_tile
        local_r = r[torch.clamp(R // s, max=H - 1), torch.clamp(C // s, max=W - 1)]

        inv = None
        if not iso:
            S2y, S2yc, q2_y = window(fy, ty, rl_y, sg, 0.5 * sg, gh, CWIN, CPAD)
            S2x, S2xc, q2_x = window(fx, tx, rl_x, sg, 0.5 * sg, gw, CWIN, CPAD)
            frac_y = (lr_mov_y / g - 0.5) - (S2y + 1 + q2_y).to(DEFAULT_FLOAT)
            frac_x = (lr_mov_x / g - 0.5) - (S2x + 1 + q2_x).to(DEFAULT_FLOAT)
            ci, cj = S2yc + 1 + q2_y, S2xc + 1 + q2_x
            cc = []
            for k in range(3):
                c00 = _cov_at(covs[k], ci, cj)
                c01 = _cov_at(covs[k], ci, cj + 1)
                c10 = _cov_at(covs[k], ci + 1, cj)
                c11 = _cov_at(covs[k], ci + 1, cj + 1)
                top = c00 + frac_x * (c01 - c00)
                bot = c10 + frac_x * (c11 - c10)
                cc.append(top + frac_y * (bot - top))
            det = cc[0] * cc[2] - cc[1] * cc[1]
            inv_det = 1.0 / det
            inv = (inv_det * cc[2], -inv_det * cc[1], inv_det * cc[0])

        dist_ref_y = lr_mov_y - 0.5
        dist_ref_x = lr_mov_x - 0.5
        wr = torch.where(inb_center, local_r, torch.zeros((), device=dev))
        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in (-1, 0, 1):
            i_g = center_i + di
            inb_i = (i_g >= 0) & (i_g < H)
            dist_y = i_g.to(DEFAULT_FLOAT) - dist_ref_y
            vy = Syc + 1 + di + q_y
            for dj in (-1, 0, 1):
                j_g = center_j + dj
                inb = inb_i & (j_g >= 0) & (j_g < W)
                dist_x = j_g.to(DEFAULT_FLOAT) - dist_ref_x
                vx = Sxc + 1 + dj + q_x
                in_frame = (vy >= 0) & (vy < H) & (vx >= 0) & (vx < W)
                c = torch.where(in_frame,
                                comp_img[vy.clamp(0, H - 1), vx.clamp(0, W - 1)],
                                torch.zeros((), device=dev))
                w = torch.exp(-0.5 * quad_form(inv, dist_x, dist_y)) * wr * inb
                accumulate_tap(vals, accs, w, c, i_g, j_g, cfa)
        num[:, y0:y1] += torch.stack(vals, 0)
        den[:, y0:y1] += torch.stack(accs, 0)
    return num, den


def merge_burst_plain(comp_stack, flows, covs_stack, r_stack, num, den,
                      cfa_pattern, tile_size, scale, grey=False, iso=False,
                      all_rows=False):
    """Plain version of K5': :func:`merge_plain` over the frames of the
    stacks, in order. Returns ``(num, den)``."""
    for comp, flow, covs, r in zip(comp_stack, flows, covs_stack, r_stack):
        merge_plain(comp, flow, covs, r, num, den, cfa_pattern, tile_size, scale,
                    grey, iso, all_rows=all_rows)
    return num, den


def interp_cov(covs, kmap_i, kmap_j):
    """Bilinear covariance interpolation with signed (truncation) fractions
    and the lower index clamped at 0 (``hmsr_tpu.models.merge._interp_cov``);
    an index past the grid reads its last row or column, as JAX's gather
    clamps it."""
    gh, gw = covs.shape[1], covs.shape[2]
    iy, ix = torch.trunc(kmap_i), torch.trunc(kmap_j)
    frac_y, frac_x = kmap_i - iy, kmap_j - ix
    fy = torch.clamp(iy.long(), 0, gh - 1)
    fx = torch.clamp(ix.long(), 0, gw - 1)
    cy = torch.clamp(fy + 1, max=gh - 1)
    cx = torch.clamp(fx + 1, max=gw - 1)
    out = []
    for k in range(3):
        tr, tl = covs[k, fy, fx], covs[k, fy, cx]
        br, bl = covs[k, cy, fx], covs[k, cy, cx]
        top = tr + frac_x * (tl - tr)
        bot = br + frac_x * (bl - br)
        out.append(top + frac_y * (bot - top))
    return out


def lr_positions(hr, scale, tile_size):
    """For integer HR coordinates ``hr``: the LR coordinate ``(hr + 0.5) /
    scale``, its flow tile ``lr // tile_size`` and its robustness index
    ``int(lr)`` (int64, not yet clipped). Both divisors are device tensors:
    a Python number would divide through its rounded reciprocal on the card
    (:func:`scale_divisor`)."""
    dev = hr.device
    lr = (hr.to(DEFAULT_FLOAT) + 0.5) / scale_divisor(scale, dev)
    tile = torch.div(lr, scale_divisor(tile_size, dev), rounding_mode="floor")
    return lr, tile.to(torch.int64), lr.to(torch.int64)


def gather_merge_plain(comp_img, flow, covs, r, num, den, cfa_pattern, tile_size,
                       scale, grey=False, iso=False, row_offset=0, band_rows=512):
    """Plain version of K11: the semantics of
    :func:`hmsr_tpu.models.merge.merge` at any ``scale`` (Bayer or ``grey``
    mode, steerable or ``iso`` kernel), evaluated in bands of ``band_rows``
    HR rows on ``num``/``den`` in place, so that no full-size per-tap
    temporaries exist at 48 MP outputs; returns the pair. Every row of the
    accumulators is evaluated, as global HR row ``row_offset + y``."""
    cfa = None if grey else np.asarray(cfa_pattern, dtype=np.int64)
    lr_h, lr_w = comp_img.shape
    n_ch, out_h, out_w = num.shape
    dev = comp_img.device
    flow = flow.to(DEFAULT_FLOAT)
    fh, fw = flow.shape[:2]
    zero = torch.zeros((), dtype=DEFAULT_FLOAT, device=dev)
    ts = tile_size
    lr_x, px, rj = lr_positions(torch.arange(out_w, device=dev)[None, :], scale, ts)
    px = px.clamp(0, fw - 1)
    rj = rj.clamp(max=lr_w - 1)
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        lr_y, py, ri = lr_positions(
            torch.arange(row_offset + y0, row_offset + y1, device=dev)[:, None], scale, ts)
        py = py.clamp(0, fh - 1)
        ri = ri.clamp(max=lr_h - 1)
        lr_mov_x = lr_x + flow[py, px, 0]
        lr_mov_y = lr_y + flow[py, px, 1]
        inbound = (lr_mov_x >= 0) & (lr_mov_x < lr_w) & (lr_mov_y >= 0) & \
            (lr_mov_y < lr_h)
        inv = None
        if not iso:
            if grey:
                kmap_x, kmap_y = lr_mov_x - 0.5, lr_mov_y - 0.5
            else:
                kmap_x, kmap_y = lr_mov_x / 2.0 - 0.5, lr_mov_y / 2.0 - 0.5
            cxx, cxy, cyy = interp_cov(covs, kmap_y, kmap_x)
            inv_det = 1.0 / (cxx * cyy - cxy * cxy)     # unguarded, as in JAX
            inv = (inv_det * cyy, -inv_det * cxy, inv_det * cxx)
        center_i, center_j = lr_mov_y.to(torch.int64), lr_mov_x.to(torch.int64)
        dist_ref_x, dist_ref_y = lr_mov_x - 0.5, lr_mov_y - 0.5
        wr = torch.where(inbound, r[ri, rj], zero)

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in (-1, 0, 1):
            i = center_i + di
            inb_i = (i >= 0) & (i < lr_h)
            dist_y = i.to(DEFAULT_FLOAT) - dist_ref_y
            for dj in (-1, 0, 1):
                j = center_j + dj
                inb = inb_i & (j >= 0) & (j < lr_w)
                c = comp_img[i.clamp(0, lr_h - 1), j.clamp(0, lr_w - 1)]
                z = quad_form(inv, j.to(DEFAULT_FLOAT) - dist_ref_x, dist_y)
                w = torch.exp(-0.5 * z) * wr * inb
                accumulate_tap(vals, accs, w, c, i, j, cfa)
        num[:, y0:y1] += torch.stack(vals, 0)
        den[:, y0:y1] += torch.stack(accs, 0)
    return num, den


def guarded_inverse(cc):
    """The guarded 2x2 inverse (ixx, ixy, iyy) of the reference merge:
    identity where |det| <= EPSILON_DIV."""
    cxx, cxy, cyy = cc
    det = cxx * cyy - cxy * cxy
    ok = torch.abs(det) > EPSILON_DIV
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one), one)
    return (torch.where(ok, inv_det * cyy, one),
            torch.where(ok, -inv_det * cxy, torch.zeros_like(det)),
            torch.where(ok, inv_det * cxx, one))


def merge_ref_plain(ref_img, covs, num, den, cfa_pattern, scale, grey=False,
                    iso=False, acc_rob=None, rad_max=1, max_multiplier=1.0,
                    max_frame_count=0.0, band_rows=512, row_offset=0):
    """Accumulate the reference frame into ``num``/``den`` (c, rows, cols)
    in place, at any scale s; returns the pair. The semantics of the JAX
    package's ``merge_ref_tiled``; the reference step of K6
    (``merge_ref_pixel`` in ``csrc/common.cuh``).

    The HR pixel R sits at ``R/s`` (no half-pixel shift); its taps are
    centred on ``round(R/s)``, and the covariance inverse is guarded. Bayer
    mode interpolates the covariance at ``(R/s - 0.5) / 2`` on the grey
    grid, grey mode at ``R/s`` on the raw grid (the JAX package's two kmaps,
    kept as they are). With ``acc_rob`` (H, W) (the accumulated-robustness
    denoiser), the taps widen to ``rad_max``: where the
    nearest-resampled ``acc_rob`` is at most ``max_frame_count`` the pixel
    takes them all and divides ``z`` by ``max_multiplier`` (else 3x3 taps,
    ``z`` as it is), and where it is below the count the reference's sums
    replace num/den instead of adding to them.

    ``num``/``den`` hold global HR rows ``row_offset ..`` (the whole image
    by default); rows and columns past the image are evaluated as any other.
    """
    cfa = None if grey else np.asarray(cfa_pattern, dtype=np.int64)
    denoise = acc_rob is not None
    rr = int(rad_max) if denoise else 1
    taps = range(-rr, rr + 1)
    H, W = ref_img.shape
    n_ch, out_h, out_w = num.shape
    dev = ref_img.device

    s_dev = scale_divisor(scale, dev)
    pos_x = torch.arange(out_w, dtype=DEFAULT_FLOAT, device=dev)[None, :] / s_dev
    center_x = torch.round(pos_x).long()
    kmap_x = pos_x if grey else (pos_x - 0.5) / 2.0
    for y0 in range(0, out_h, band_rows):
        y1 = min(y0 + band_rows, out_h)
        pos_y = torch.arange(row_offset + y0, row_offset + y1, dtype=DEFAULT_FLOAT,
                             device=dev)[:, None] / s_dev
        center_y = torch.round(pos_y).long()
        inv = None
        if not iso:
            kmap_y = pos_y if grey else (pos_y - 0.5) / 2.0
            inv = guarded_inverse(interp_cov(covs, kmap_y, kmap_x))
        if denoise:
            local_acc_r = acc_rob[center_y.clamp(0, H - 1), center_x.clamp(0, W - 1)]
            few = local_acc_r <= float(max_frame_count)
            power = torch.where(few, float(max_multiplier), 1.0)
            rad = torch.where(few, rr, 1)

        vals = [0.0] * n_ch
        accs = [0.0] * n_ch
        for di in taps:
            i = center_y + di
            inb_i = (i >= 0) & (i < H)
            dist_y = i.to(DEFAULT_FLOAT) - pos_y
            for dj in taps:
                j = center_x + dj
                inb = inb_i & (j >= 0) & (j < W)
                z = quad_form(inv, j.to(DEFAULT_FLOAT) - pos_x, dist_y)
                if denoise:
                    inb = inb & (abs(di) <= rad) & (abs(dj) <= rad)
                    z = z / power
                c = ref_img[i.clamp(0, H - 1), j.clamp(0, W - 1)]
                w = torch.exp(-0.5 * z) * inb
                accumulate_tap(vals, accs, w, c, i, j, cfa)
        val, acc = torch.stack(vals, 0), torch.stack(accs, 0)
        if denoise:
            overwrite = local_acc_r < float(max_frame_count)
            num[:, y0:y1] = torch.where(overwrite, val, num[:, y0:y1] + val)
            den[:, y0:y1] = torch.where(overwrite, acc, den[:, y0:y1] + acc)
        else:
            num[:, y0:y1] += val
            den[:, y0:y1] += acc
    return num, den


def _check_frame_args(comp, flow, covs, r, num, den, lead=()):
    """The checks every merge wrapper shares: float32 tensors of the right
    ranks on one device, stacks of one length (``lead``: their frame axis,
    empty for one frame), ``r`` the frame's shape, three covariance planes,
    a flow of (x, y) pairs. ``num``/``den`` None skips the accumulators.
    Returns ``(H, W)``."""
    dev = comp.device
    nl = len(lead)
    for name, t, nd in (("comp", comp, 2 + nl), ("flow", flow, 3 + nl),
                        ("covs", covs, 3 + nl), ("r", r, 2 + nl), ("num", num, 3),
                        ("den", den, 3)):
        if t is not None:
            _build.check_f32(name, t, nd, dev)
    H, W = comp.shape[nl:]
    _build.check_arg(all(tuple(t.shape[:nl]) == lead for t in (comp, flow, covs, r)),
                     f"stacks of different lengths: comp {tuple(comp.shape)}, flow "
                     f"{tuple(flow.shape)}, covs {tuple(covs.shape)}, r {tuple(r.shape)}")
    _build.check_arg(tuple(r.shape[nl:]) == (H, W) and covs.shape[nl] == 3,
                     f"r {tuple(r.shape)}, covs {tuple(covs.shape)}")
    _build.check_arg(flow.shape[-1] == 2, f"flow {tuple(flow.shape)}: (x, y) pairs")
    return H, W


def _check_merge_args(comp, flow, covs, r, num, den, tile_size, scale, grey,
                      lead=(), row_offset=0):
    """Checks shared by the K5, K5' and K6 wrappers (:func:`_check_frame_args`
    and the tiled geometry); ``row_offset`` is the global HR row of a
    band's first (K5 only; any number of rows from a multiple of ``Ts*s``).
    Returns ``(H, W)``."""
    Ts, s = int(tile_size), int(scale)
    nl = len(lead)
    H, W = _check_frame_args(comp, flow, covs, r, num, den, lead)
    n_ch = 1 if grey else 3
    _build.check_arg(s == scale and s >= 1, f"integer scale required, got {scale}")
    if num is not None:
        rows = H * s if nl else num.shape[1]
        _build.check_arg(tuple(num.shape) == (n_ch, rows, W * s) == tuple(den.shape)
                         and rows >= 1,
                         f"accumulators {tuple(num.shape)}, {tuple(den.shape)} for a "
                         f"{(H, W)} {'grey' if grey else 'Bayer'} frame at scale {s}")
    _build.check_arg(not nl or row_offset == 0, "K5' takes the whole accumulator")
    _build.check_arg(row_offset >= 0 and row_offset % (Ts * s) == 0,
                     f"row_offset {row_offset} is no non-negative multiple of "
                     f"Ts*s = {Ts * s}")
    fy, fx = flow.shape[nl:nl + 2]
    _build.check_arg(fy >= -(-H // Ts) and fx >= -(-W // Ts),
                     f"flow {tuple(flow.shape)} does not cover {(H, W)} at Ts={Ts}")
    _build.check_arg(Ts % 2 == 0, f"tile size {Ts} must be even")
    return H, W


def merge_layout(tile_size, scale, frames, grey=False, iso=False):
    """The launch layout of K5 (``frames=1``) and of K5' over ``frames``
    frames in the variant (``grey``, ``iso``), as the built library computes
    it: ``rows`` HR rows per block, ``bands`` blocks per HR tile,
    ``smem_bytes`` of dynamic shared memory per block. Needs the CUDA
    toolchain (it builds the library), not a card."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.library().hmsr_merge_layout(int(tile_size), int(scale),
                                                     int(frames), int(grey), int(iso),
                                                     out),
                 "hmsr_merge_layout")
    return dict(rows=out[0], bands=out[1], smem_bytes=out[2])


def _launch_args(cfa_pattern, grey, tensors):
    """CUDA-side checks of both wrappers; returns the CFA packed as
    ``cfa00 | cfa01 << 2 | cfa10 << 4 | cfa11 << 6`` (0 in grey mode, which
    reads no CFA)."""
    _build.require_cuda(tensors[0].device)
    _build.check_arg(all(t.is_contiguous() for t in tensors),
                     "merge inputs must be contiguous")
    if grey:
        return 0
    cfa = [int(v) for v in np.asarray(cfa_pattern).reshape(-1)]
    _build.check_arg(len(cfa) == 4 and all(0 <= v < 3 for v in cfa),
                     f"bad CFA pattern {cfa}")
    return sum(v << (2 * i) for i, v in enumerate(cfa))


def merge_accumulate(comp_img, flow, covs, r, num, den, cfa_pattern,
                     tile_size, scale, grey=False, iso=False, row_offset=0):
    """K5: accumulate one frame into ``num``/``den`` (c, H*s, W*s) in place;
    returns ``(num, den)``.

    ``comp_img``: (H, W); ``flow``: (ny, nx, 2) per raw Ts-tile;
    ``covs``: (3, gh, gw) on the covariance grid (the grey grid in Bayer
    mode, the raw grid in ``grey`` mode; not read with ``iso``); ``r``:
    (H, W) robustness; all contiguous float32 on one device. c is 3 in
    Bayer mode and 1 in ``grey`` mode. Integer ``scale`` only.

    With ``row_offset`` (a multiple of ``Ts*s``), ``num``/``den`` are a band
    (c, rows, W*s) holding global HR rows ``row_offset ..``: the sharded
    pipeline's space axis. Rows past the image take nothing, and a band
    wholly past it launches nothing.
    """
    Ts, s = int(tile_size), int(scale)
    H, W = _check_merge_args(comp_img, flow, covs, r, num, den, Ts, scale, grey,
                             row_offset=row_offset)
    if comp_img.device.type == "cpu":
        return merge_plain(comp_img, flow, covs, r, num, den, cfa_pattern, Ts, s,
                           grey, iso, row_offset)
    cfa = _launch_args(cfa_pattern, grey, (comp_img, flow, covs, r, num, den))
    if row_offset >= H * s:
        return num, den
    code = _build.library().hmsr_merge(
        _build.ptr(comp_img), H, W, _build.ptr(flow), flow.shape[1],
        _build.ptr(covs), covs.shape[1], covs.shape[2], _build.ptr(r),
        _build.ptr(num), _build.ptr(den), H * s, num.shape[2],
        row_offset // (Ts * s), num.shape[1], Ts, s, cfa, int(grey), int(iso),
        _build.stream_of(comp_img))
    _build.check(code, "hmsr_merge")
    merge_accumulate.launches += 1
    if row_offset or num.shape[1] != H * s:
        merge_accumulate.band_launches += 1
    return num, den


merge_accumulate.launches = 0
#: the launches of ``launches`` into a band of the accumulators
merge_accumulate.band_launches = 0


def merge_burst_accumulate(comp_stack, flows, covs_stack, r_stack, num, den,
                           cfa_pattern, tile_size, scale, grey=False, iso=False):
    """K5': accumulate the F frames of the stacks into ``num``/``den``
    (c, H*s, W*s) in place, in frame order, in one launch; returns ``(num,
    den)``, bit-identical to F :func:`merge_accumulate` calls of the same
    variant.

    ``comp_stack``: (F, H, W); ``flows``: (F, ny, nx, 2); ``covs_stack``:
    (F, 3, gh, gw); ``r_stack``: (F, H, W); all contiguous float32 on one
    device; ``grey`` and ``iso`` as for :func:`merge_accumulate`. Integer
    ``scale`` only.
    """
    Ts, s = int(tile_size), int(scale)
    F = comp_stack.shape[0] if comp_stack.dim() == 3 else -1
    H, W = _check_merge_args(comp_stack, flows, covs_stack, r_stack, num, den, Ts,
                             scale, grey, lead=(F,))
    if comp_stack.device.type == "cpu":
        return merge_burst_plain(comp_stack, flows, covs_stack, r_stack, num, den,
                                 cfa_pattern, Ts, s, grey, iso)
    cfa = _launch_args(cfa_pattern, grey,
                       (comp_stack, flows, covs_stack, r_stack, num, den))
    code = _build.library().hmsr_merge_burst(
        _build.ptr(comp_stack), F, H, W, _build.ptr(flows), flows.shape[1],
        flows.shape[2], _build.ptr(covs_stack), covs_stack.shape[2],
        covs_stack.shape[3], _build.ptr(r_stack), _build.ptr(num), _build.ptr(den),
        num.shape[1], num.shape[2], Ts, s, cfa, int(grey), int(iso),
        _build.stream_of(comp_stack))
    _build.check(code, "hmsr_merge_burst")
    merge_burst_accumulate.launches += 1
    return num, den


merge_burst_accumulate.launches = 0


def gather_merge_accumulate(comp_img, flow, covs, r, num, den, cfa_pattern, tile_size,
                            scale, grey=False, iso=False, row_offset=0, band_rows=512):
    """K11: accumulate one frame into ``num``/``den`` (c, rows, cols) in
    place at any ``scale``, the gather merge; returns ``(num, den)``.

    ``comp_img``: (H, W); ``flow``: (ny, nx, 2) per raw tile of
    ``tile_size`` pixels (tiles past the grid read its last row or column);
    ``covs``: (3, gh, gw) on the grey grid (Bayer) or the raw grid
    (``grey``; not read with ``iso``); ``r``: (H, W) robustness; all
    contiguous float32 on one device. ``num``/``den`` hold global HR rows
    ``row_offset ..`` of the image (the sharded pipeline's bands), every one
    evaluated. On CPU tensors it runs :func:`gather_merge_plain` in bands of
    ``band_rows`` rows; on the card one launch, whatever the bands.
    """
    Ts = int(tile_size)
    H, W = _check_frame_args(comp_img, flow, covs, r, num, den)
    _build.check_arg(float(scale) > 0 and Ts >= 1 and row_offset >= 0,
                     f"scale {scale}, tile size {Ts}, row_offset {row_offset}")
    _build.check_arg(tuple(num.shape) == tuple(den.shape) and num.shape[0] == (
        1 if grey else 3) and min(num.shape) >= 1,
        f"accumulators {tuple(num.shape)}, {tuple(den.shape)} in "
        f"{'grey' if grey else 'Bayer'} mode")
    _build.check_arg(min(flow.shape[:2]) >= 1 and min(covs.shape[1:]) >= 1,
                     f"flow {tuple(flow.shape)}, covs {tuple(covs.shape)}")
    if comp_img.device.type == "cpu":
        return gather_merge_plain(comp_img, flow, covs, r, num, den, cfa_pattern, Ts,
                                  scale, grey, iso, row_offset, band_rows)
    cfa = _launch_args(cfa_pattern, grey, (comp_img, flow, covs, r, num, den))
    _build.check_arg(flow.data_ptr() % 8 == 0, "flow must be 8-byte aligned")
    code = _build.library().hmsr_gather_merge(
        _build.ptr(comp_img), H, W, _build.ptr(flow), flow.shape[0], flow.shape[1],
        _build.ptr(covs), covs.shape[1], covs.shape[2], _build.ptr(r), _build.ptr(num),
        _build.ptr(den), num.shape[1], num.shape[2], int(row_offset), float(scale),
        float(Ts), cfa, int(grey), int(iso), _build.stream_of(comp_img))
    _build.check(code, "hmsr_gather_merge")
    gather_merge_accumulate.launches += 1
    return num, den


gather_merge_accumulate.launches = 0


def gather_positions(hr, scale, tile_size, n_tiles, size):
    """K11's terms of the integer HR coordinates ``hr`` (int32, 1-D): the LR
    coordinate, the flow tile clipped to ``[0, n_tiles - 1]`` and the
    robustness index clipped to ``size - 1`` (int64), as the kernel
    computes them (a launch of ``gather_positions_kernel`` on the card;
    :func:`lr_positions`, clipped, on the CPU)."""
    _build.check_arg(hr.dtype == torch.int32 and hr.dim() == 1 and hr.is_contiguous(),
                     f"hr: expected contiguous 1-D int32, got {hr.dtype} {tuple(hr.shape)}")
    if hr.device.type == "cpu":
        lr, tile, idx = lr_positions(hr.to(torch.int64), scale, tile_size)
        return lr, tile.clamp(0, n_tiles - 1), idx.clamp(max=size - 1)
    _build.require_cuda(hr.device)
    lr = torch.empty(hr.shape, dtype=DEFAULT_FLOAT, device=hr.device)
    tile, idx = torch.empty_like(hr), torch.empty_like(hr)
    code = _build.library().hmsr_gather_positions(
        _build.ptr(hr), hr.numel(), float(scale), float(tile_size), int(n_tiles),
        int(size), _build.ptr(lr), _build.ptr(tile), _build.ptr(idx),
        _build.stream_of(hr))
    _build.check(code, "hmsr_gather_positions")
    return lr, tile.long(), idx.long()


def fused_accum_shape(raw_shape, tile_size, scale, grey=False):
    """``(c, nty*B, ntx*B)``: the accumulators of K6 and of the fused
    merges, whole HR tiles of ``B = Ts*s`` (c = 3 Bayer, 1 grey)."""
    H, W = raw_shape
    B = int(tile_size) * int(scale)
    return (1 if grey else 3, -(-H * int(scale) // B) * B, -(-W * int(scale) // B) * B)


def merge_fused_plain(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                      cfa_pattern, tile_size, scale, grey=False, iso=False,
                      acc_rob=None, rad_max=1, max_multiplier=1.0, max_frame_count=0.0):
    """Plain version of K6: zeroed accumulators at :func:`fused_accum_shape`,
    :func:`merge_burst_plain` over the F frames (every padded row taking its
    share), then :func:`merge_ref_plain` over every padded row and column.
    Returns ``(num, den)``."""
    shape = fused_accum_shape(ref_img.shape, tile_size, scale, grey)
    num = torch.zeros(shape, dtype=DEFAULT_FLOAT, device=ref_img.device)
    den = torch.zeros_like(num)
    merge_burst_plain(comp_stack, flows, covs_stack, r_stack, num, den, cfa_pattern,
                      tile_size, scale, grey, iso, all_rows=True)
    return merge_ref_plain(ref_img, ref_covs, num, den, cfa_pattern, scale, grey, iso,
                           acc_rob, rad_max, max_multiplier, max_frame_count)


def merge_fused_accumulate(comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs,
                           cfa_pattern, tile_size, scale, grey=False, iso=False,
                           acc_rob=None, rad_max=1, max_multiplier=1.0,
                           max_frame_count=0.0):
    """K6: merge the F frames of the stacks, in order, and then the
    reference frame into new accumulators ``(num, den)`` at
    :func:`fused_accum_shape`, written once; returns them.

    ``comp_stack``, ``r_stack``: (F, H, W); ``flows``: (F, ny, nx, 2);
    ``covs_stack``: (F, 3, gh, gw) (F may be 0); ``ref_img``: (H, W);
    ``ref_covs``: (3, gh, gw) (neither covariance is read with ``iso``);
    all contiguous float32 on one device; ``grey`` and ``iso`` as for
    :func:`merge_accumulate`. Integer ``scale`` only. ``acc_rob`` (H, W)
    turns on the reference merge's accumulated-robustness denoiser with
    ``rad_max`` (at least 1), ``max_multiplier`` and ``max_frame_count``
    (:func:`merge_ref_plain`).
    """
    Ts, s = int(tile_size), int(scale)
    F = comp_stack.shape[0] if comp_stack.dim() == 3 else -1
    dev = ref_img.device
    _build.check_f32("ref_img", ref_img, 2, dev)
    _build.check_f32("ref_covs", ref_covs, 3, dev)
    H, W = ref_img.shape
    shape = fused_accum_shape((H, W), Ts, s, grey)
    _build.check_arg(tuple(comp_stack.shape[1:]) == (H, W),
                     f"comp {tuple(comp_stack.shape)} for a {(H, W)} reference")
    _check_merge_args(comp_stack, flows, covs_stack, r_stack, None, None, Ts, scale,
                      grey, lead=(F,))
    _build.check_arg(ref_covs.shape[0] == 3 and (
        not F or tuple(covs_stack.shape[2:]) == tuple(ref_covs.shape[1:])),
        f"ref_covs {tuple(ref_covs.shape)}, covs {tuple(covs_stack.shape)}")
    if acc_rob is not None:
        _build.check_f32("acc_rob", acc_rob, 2, dev)
        _build.check_arg(tuple(acc_rob.shape) == (H, W) and int(rad_max) >= 1,
                         f"acc_rob {tuple(acc_rob.shape)}, rad_max {rad_max}")
    args = (comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs, cfa_pattern,
            Ts, s, grey, iso, acc_rob, int(rad_max), float(max_multiplier),
            float(max_frame_count))
    if dev.type == "cpu":
        return merge_fused_plain(*args)
    num = torch.empty(shape, dtype=DEFAULT_FLOAT, device=dev)
    den = torch.empty_like(num)
    inputs = (comp_stack, flows, covs_stack, r_stack, ref_img, ref_covs) + \
        ((acc_rob,) if acc_rob is not None else ())
    cfa = _launch_args(cfa_pattern, grey, inputs)
    code = _build.library().hmsr_merge_fused(
        _build.ptr(comp_stack), F, H, W, _build.ptr(flows), flows.shape[1],
        flows.shape[2], _build.ptr(covs_stack), ref_covs.shape[1], ref_covs.shape[2],
        _build.ptr(r_stack), _build.ptr(ref_img), _build.ptr(ref_covs),
        _build.ptr(acc_rob) if acc_rob is not None else None, _build.ptr(num),
        _build.ptr(den), shape[1], shape[2], Ts, s, cfa, int(grey), int(iso),
        int(rad_max), float(max_multiplier), float(max_frame_count),
        _build.stream_of(ref_img))
    _build.check(code, "hmsr_merge_fused")
    merge_fused_accumulate.launches += 1
    return num, den


merge_fused_accumulate.launches = 0


def refill_plain(num, den, B, out_h, out_w, tiles=False):
    """Plain version of K7: :func:`~.accumfix.normalize_groups` of the
    padded ``(c, h, w)`` accumulators, cropped to ``(c, out_h, out_w)``."""
    return normalize_groups(num, den, B, tiles)[:, :out_h, :out_w]


def refill_groups(num, den, B, out_h, out_w, tiles=False):
    """K7 per group: the fused form's refill and divide. ``num``/``den``:
    K6's padded ``(c, h, w)`` accumulators, h and w whole multiples of ``B =
    Ts*s``, float32 on one device; each B-row slab (or each (B, B) tile
    with ``tiles``) is refilled and divided on its own, as
    :func:`~.accumfix.normalize_groups` does, and the image is the
    ``(c, out_h, out_w)`` crop, a new tensor."""
    B, out_h, out_w = int(B), int(out_h), int(out_w)
    dev = num.device
    c, h, w = _check_accumulators(num, den)
    _build.check_arg(B >= 1 and h >= B and w >= B and h % B == 0 and w % B == 0,
                     f"accumulators {(h, w)} are no whole groups of B = {B}")
    _build.check_arg(1 <= out_h <= h and 1 <= out_w <= w,
                     f"crop {(out_h, out_w)} of {(h, w)}")
    if dev.type == "cpu":
        return refill_plain(num, den, B, out_h, out_w, tiles)
    return _launch_refill(num, den, out_h, out_w, B, B if tiles else w, -1)


def refill_image(num, den, refill_border):
    """K7 on the whole accumulators: the scan, chunked and sharded
    forms' refill and divide, ``normalize_accum(num, den,
    refill_border=refill_border)`` (its plain twin) bit for bit.
    ``num``/``den``: ``(c, H, W)`` float32 on one device, rows contiguous,
    planes any equal distance apart (a view of every other plane, as the
    sharded pipeline's, takes no copy); returns the ``(c, H, W)`` image, a
    new tensor. The kernel refills only within ``refill_border`` of an
    edge, where :func:`~.accumfix.strip_width` says the strips are distinct,
    and everywhere otherwise."""
    B = int(refill_border)
    dev = num.device
    c, h, w = _check_accumulators(num, den)
    _build.check_arg(B >= 0, f"refill_border {B} < 0")
    if dev.type == "cpu":
        return normalize_accum(num, den, refill_border=B)
    border = strip_width((h, w), B)
    return _launch_refill(num, den, h, w, h, w, -1 if border is None else border)


def _check_accumulators(num, den):
    dev = num.device
    _build.check_f32("num", num, 3, dev)
    _build.check_f32("den", den, 3, dev)
    _build.check_arg(num.shape == den.shape, f"num {tuple(num.shape)}, den "
                     f"{tuple(den.shape)}")
    return tuple(num.shape)


def _launch_refill(num, den, out_h, out_w, gh, gw, border):
    """One K7 launch: groups of ``gh x gw``, the refill kept within
    ``border`` of an edge (everywhere if negative); the ``(c, out_h,
    out_w)`` image, a new tensor."""
    _build.require_cuda(num.device)
    c, h, w = num.shape
    plane = max(num.stride(0), h * w)
    _build.check_arg(num.stride() == den.stride() and num.stride(2) == 1
                     and num.stride(1) == w and (c == 1 or num.stride(0) >= h * w)
                     and plane < 2**31,
                     f"refill inputs need contiguous rows, the same strides and planes "
                     f"under 2^31 values apart: {num.stride()}, {den.stride()}")
    out = torch.empty((c, out_h, out_w), dtype=DEFAULT_FLOAT, device=num.device)
    code = _build.library().hmsr_refill(
        _build.ptr(num), _build.ptr(den), _build.ptr(out), c, h, w, plane, gh, gw, out_h,
        out_w, border, STARVED_DEN, EPSILON_DIV, _build.stream_of(num))
    _build.check(code, "hmsr_refill")
    refill_groups.launches += 1
    return out


refill_groups.launches = 0
