"""K5 (merge accumulation of one frame) and K5' (the same over a chunk of
frames, accumulators read and written once): CUDA kernel wrappers and their
plain PyTorch versions.

Counterpart of :mod:`hmsr_tpu.ops.pallas_merge`: ``merge_pallas`` (per
frame) and ``merge_burst_pallas`` (frames grid). The kernels are
``csrc/merge.cu`` and ``csrc/merge_burst.cu`` (both replace
``pallas_merge.py:_merge_group_kernel``); their headers say what bounds them
on the H100 and how the design answers it: one block per HR tile (or band
of one), tile windows staged in shared memory; ``csrc/common.cuh`` decides
the launch layout (:func:`merge_layout` reads it back). Both carry the four
variants of the Pallas kernel: Bayer or grey mode (``grey``: one
accumulator plane, covariances on the raw grid, no CFA pick) times the
steerable or the isotropic kernel (``iso``: no covariance is read). The
accumulators keep the plain ``(c, H*s, W*s)`` shape, c = 3 (Bayer) or 1
(grey) (the TPU's ``padded_accum_shape`` is a tiling artefact), and are
updated in place. K5 also takes a band of them (``row_offset``, the banded
branch of ``merge_pallas`` that the sharded pipeline's space axis runs):
``(c, rows, W*s)`` holding global HR rows from ``row_offset``, a multiple
of ``Ts*s``. A wrapper launches its kernel for CUDA tensors and runs
the plain version only for CPU tensors; ``merge_accumulate.launches`` and
``merge_burst_accumulate.launches`` count kernel launches,
``merge_accumulate.band_launches`` those of K5 into a band.
"""

import ctypes

import numpy as np
import torch

from . import _build
from ..utils.types import DEFAULT_FLOAT


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
                scale, grey=False, iso=False, row_offset=0):
    """Plain version of K5: the semantics of
    :func:`hmsr_tpu.models.merge_tiled.merge_tiled` (integer scale; Bayer or
    ``grey`` mode, steerable or ``iso`` kernel) written per HR pixel,
    evaluated in bands of HR rows and accumulated into ``num``/``den`` in
    place. Returns ``(num, den)``. ``num``/``den`` hold global HR rows
    ``row_offset ..`` of the image; rows past the image take nothing.
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

    n_rows = min(acc_h, H * s - row_offset)   # the band's rows in the image
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
                      cfa_pattern, tile_size, scale, grey=False, iso=False):
    """Plain version of K5': :func:`merge_plain` over the frames of the
    stacks, in order. Returns ``(num, den)``."""
    for comp, flow, covs, r in zip(comp_stack, flows, covs_stack, r_stack):
        merge_plain(comp, flow, covs, r, num, den, cfa_pattern, tile_size, scale,
                    grey, iso)
    return num, den


def _check_merge_args(comp, flow, covs, r, num, den, tile_size, scale, grey,
                      lead=(), row_offset=0):
    """Checks shared by the K5 and K5' wrappers; ``lead`` is the frame axis
    of the stacked inputs (empty for one frame), ``row_offset`` the global
    HR row of a band's first (K5 only; any number of rows from a multiple
    of ``Ts*s``). Returns ``(H, W)``."""
    Ts, s = int(tile_size), int(scale)
    dev = comp.device
    nl = len(lead)
    for name, t, nd in (("comp", comp, 2 + nl), ("flow", flow, 3 + nl),
                        ("covs", covs, 3 + nl), ("r", r, 2 + nl), ("num", num, 3),
                        ("den", den, 3)):
        _build.check_f32(name, t, nd, dev)
    H, W = comp.shape[nl:]
    n_ch = 1 if grey else 3
    _build.check_arg(all(tuple(t.shape[:nl]) == lead for t in (comp, flow, covs, r)),
                     f"stacks of different lengths: comp {tuple(comp.shape)}, flow "
                     f"{tuple(flow.shape)}, covs {tuple(covs.shape)}, r {tuple(r.shape)}")
    _build.check_arg(s == scale and s >= 1, f"integer scale required, got {scale}")
    rows = H * s if nl else num.shape[1]
    _build.check_arg(tuple(num.shape) == (n_ch, rows, W * s) == tuple(den.shape)
                     and rows >= 1,
                     f"accumulators {tuple(num.shape)}, {tuple(den.shape)} "
                     f"for a {(H, W)} {'grey' if grey else 'Bayer'} frame at scale {s}")
    _build.check_arg(not nl or row_offset == 0, "K5' takes the whole accumulator")
    _build.check_arg(row_offset >= 0 and row_offset % (Ts * s) == 0,
                     f"row_offset {row_offset} is no non-negative multiple of "
                     f"Ts*s = {Ts * s}")
    _build.check_arg(tuple(r.shape[nl:]) == (H, W) and covs.shape[nl] == 3,
                     f"r {tuple(r.shape)}, covs {tuple(covs.shape)}")
    fy, fx, fc = flow.shape[nl:]
    _build.check_arg(fy >= -(-H // Ts) and fx >= -(-W // Ts) and fc == 2,
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
